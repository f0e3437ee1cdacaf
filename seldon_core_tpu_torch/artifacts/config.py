"""Artifact-plane configuration from ``seldon.io/artifact-*`` annotations
(port of ``seldon_core_tpu/artifacts/config.py``, the same annotations,
env var and messages).

The plane records every captured fused-segment bucket (and the kernel
library) in a content-addressed store, so a restarted or added replica
captures its buckets at boot, each held to a published probe digest,
instead of at first sight on the request path.  The store root is the one
mandatory knob — without a resolvable root there is nowhere to write, so
the plane stays off and every capture is live:

- ``seldon.io/artifact-store``: store root directory (or the
  ``SELDON_ARTIFACT_STORE`` env for ad-hoc runs) — artifacts live next
  to the safetensors checkpoints, operator-managed like model weights.
- ``seldon.io/artifacts``: force-disable with ``"false"`` even when a
  store is configured (drills that must measure cold captures).
- ``seldon.io/artifact-precompile``: capture + publish every derivable
  bucket at boot, off the request path (default true).
- ``seldon.io/artifact-parity``: the probe gate at publish time — a
  bucket's probe digest is published only when its replay is bitwise
  equal to the eager run (default true).
- ``seldon.io/artifact-publish``: write live captures back to the store
  so one cold replica warms the store for the whole fleet (default
  true).

Raise ``ValueError`` with a path-prefixed message on any invalid value:
``graph/spec.py`` ``artifact_config`` re-raises it as the load-time
refusal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "ARTIFACTS_ANNOTATION",
    "ARTIFACT_PREFIX",
    "ARTIFACT_STORE_ANNOTATION",
    "ARTIFACT_PRECOMPILE_ANNOTATION",
    "ARTIFACT_PARITY_ANNOTATION",
    "ARTIFACT_PUBLISH_ANNOTATION",
    "ArtifactConfig",
    "artifact_config_from_annotations",
]

ARTIFACTS_ANNOTATION = "seldon.io/artifacts"
#: every family knob but the master switch starts with this prefix
ARTIFACT_PREFIX = "seldon.io/artifact-"
ARTIFACT_STORE_ANNOTATION = "seldon.io/artifact-store"
ARTIFACT_PRECOMPILE_ANNOTATION = "seldon.io/artifact-precompile"
ARTIFACT_PARITY_ANNOTATION = "seldon.io/artifact-parity"
ARTIFACT_PUBLISH_ANNOTATION = "seldon.io/artifact-publish"

_STORE_ENV = "SELDON_ARTIFACT_STORE"

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _parse_bool(ann: dict, key: str, where: str, default: bool) -> bool:
    raw = ann.get(key)
    if raw is None:
        return default
    v = str(raw).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(
        f"{where}: annotation {key} must be a boolean "
        f"(true/false), got {raw!r}"
    )


@dataclass(frozen=True)
class ArtifactConfig:
    """Validated artifact-plane posture for one predictor."""

    enabled: bool = False
    #: store root directory (local dir backend); "" when unresolved
    store: str = ""
    #: warm every derivable bucket at boot, off the request path
    precompile: bool = True
    #: byte-parity gate before an artifact is admitted to the store
    parity: bool = True
    #: write live compiles back to the store
    publish: bool = True


def artifact_config_from_annotations(
        ann: dict, where: str) -> Optional[ArtifactConfig]:
    """``seldon.io/artifact-*`` → validated :class:`ArtifactConfig`.

    Returns None when the family is entirely absent AND no env store is
    set (the plane is simply not in play); raises ``ValueError`` on any
    malformed value.  ``seldon.io/artifacts: "false"`` wins over
    everything; a config without a store root comes back
    ``enabled=False`` — there is nowhere to read or write.
    """
    keys = [k for k in ann
            if k == ARTIFACTS_ANNOTATION or k.startswith(ARTIFACT_PREFIX)]
    env_store = os.environ.get(_STORE_ENV, "").strip()
    if not keys and not env_store:
        return None

    store = str(ann.get(ARTIFACT_STORE_ANNOTATION, "") or "").strip()
    if not store:
        store = env_store
    on = _parse_bool(ann, ARTIFACTS_ANNOTATION, where, default=bool(store))
    if on and not store:
        raise ValueError(
            f"{where}: {ARTIFACTS_ANNOTATION} is set but no store root is "
            f"configured — set {ARTIFACT_STORE_ANNOTATION} (or the "
            f"{_STORE_ENV} env) to the artifact directory"
        )
    return ArtifactConfig(
        enabled=on and bool(store),
        store=store,
        precompile=_parse_bool(
            ann, ARTIFACT_PRECOMPILE_ANNOTATION, where, True),
        parity=_parse_bool(ann, ARTIFACT_PARITY_ANNOTATION, where, True),
        publish=_parse_bool(ann, ARTIFACT_PUBLISH_ANNOTATION, where, True),
    )
