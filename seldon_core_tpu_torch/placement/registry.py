"""Process-local placement state registry: live placement facts → control
plane.

Mirrors ``health/registry.py`` and ``qos/registry.py``: each
:class:`~seldon_core_tpu_torch.placement.plane.PlacementPlane` owner publishes
a snapshot provider keyed by deployment name, and
``operator/reconcile.py`` reads :func:`snapshot` when computing the CR's
``status.placement`` block.  In a real cluster each engine pod exposes
the same facts via ``/admin/placement`` and the operator-side registry
stays empty — ``status.placement`` is then omitted rather than invented.
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
    """The deployment's current placement posture, or None when no
    runtime in this process serves it.  Provider errors surface as None —
    status must never fail because a snapshot did."""
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
