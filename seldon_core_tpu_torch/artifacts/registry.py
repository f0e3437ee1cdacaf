"""Process-local artifact-plane registry (port of
``seldon_core_tpu/artifacts/registry.py``): each deployment that owns an
:class:`~seldon_core_tpu_torch.artifacts.plane.ArtifactPlane` publishes a
snapshot provider keyed by its name, and a status reader calls
:func:`snapshot`.  A pod serves the same facts from ``/admin/artifacts``
and its ``seldon_artifact_*`` gauges.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["publish", "unpublish", "snapshot", "clear"]

_lock = threading.Lock()
#: deployment name → snapshot provider () -> dict
_providers: dict[str, Callable[[], dict]] = {}


def publish(deployment: str, provider: Callable[[], dict]) -> None:
    """Register (or replace) the snapshot provider for a deployment."""
    with _lock:
        _providers[deployment] = provider


def unpublish(deployment: str) -> None:
    with _lock:
        _providers.pop(deployment, None)


def snapshot(deployment: str) -> Optional[dict]:
    """The deployment's current artifact posture, or None when no
    runtime in this process serves it.  Provider errors surface as None
    — status must never fail because a snapshot did."""
    with _lock:
        provider = _providers.get(deployment)
    if provider is None:
        return None
    try:
        return provider()
    except Exception:
        return None


def clear() -> None:
    """Test helper: forget every provider."""
    with _lock:
        _providers.clear()
