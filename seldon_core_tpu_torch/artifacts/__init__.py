"""Artifact plane (port of ``seldon_core_tpu/artifacts/``): a fused plan's
CUDA-graph buckets captured at boot from a content-addressed store, each
held to a published probe digest, and the kernel library loaded from the
same store without ``nvcc``.

Enabled by pointing ``seldon.io/artifact-store`` (or
``SELDON_ARTIFACT_STORE``) at a directory, with ``seldon.io/graph-plan:
"fused"``; refused at load when malformed (``graph/spec.py``); observable
at ``/admin/artifacts`` and the ``seldon_artifact_*`` metrics.
"""

from seldon_core_tpu_torch.artifacts.config import (
    ARTIFACT_PARITY_ANNOTATION,
    ARTIFACT_PREFIX,
    ARTIFACT_PRECOMPILE_ANNOTATION,
    ARTIFACT_PUBLISH_ANNOTATION,
    ARTIFACT_STORE_ANNOTATION,
    ARTIFACTS_ANNOTATION,
    ArtifactConfig,
    artifact_config_from_annotations,
)
from seldon_core_tpu_torch.artifacts.key import (
    FORMAT_VERSION,
    artifact_key,
    runtime_identity,
    segment_fingerprint,
)
from seldon_core_tpu_torch.artifacts.plane import ArtifactPlane
from seldon_core_tpu_torch.artifacts.registry import (
    clear,
    publish,
    snapshot,
    unpublish,
)
from seldon_core_tpu_torch.artifacts.store import (
    ArtifactBackend,
    InMemoryArtifactStore,
    LocalArtifactStore,
)

__all__ = [
    "ARTIFACTS_ANNOTATION",
    "ARTIFACT_PREFIX",
    "ARTIFACT_STORE_ANNOTATION",
    "ARTIFACT_PRECOMPILE_ANNOTATION",
    "ARTIFACT_PARITY_ANNOTATION",
    "ARTIFACT_PUBLISH_ANNOTATION",
    "ArtifactConfig",
    "artifact_config_from_annotations",
    "FORMAT_VERSION",
    "artifact_key",
    "runtime_identity",
    "segment_fingerprint",
    "ArtifactPlane",
    "ArtifactBackend",
    "LocalArtifactStore",
    "InMemoryArtifactStore",
    "publish",
    "unpublish",
    "snapshot",
    "clear",
]
