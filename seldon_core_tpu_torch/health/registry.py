"""Process-local health state registry: live health facts → control plane.

The reconcile loop surfaces each deployment's *current* health posture
(burn-rate verdict, sampler freshness, flight-recorder occupancy) on the
CR's ``status.health`` block — beside ``status.qos`` and refreshed on
the same tick.  Health planes are runtime objects inside engine or
gateway processes; this registry is the seam between them and the
operator, mirroring ``qos/registry.py``: each
:class:`~seldon_core_tpu_torch.health.plane.HealthPlane` owner publishes a
snapshot provider keyed by deployment name, and ``operator/reconcile.py``
reads :func:`snapshot` when computing status.

In the colocated dev/test harness this is live state; in a real cluster
each engine pod exposes the same facts via ``/admin/health`` and its
``seldon_health_*`` gauges and the operator-side registry stays empty —
``status.health`` is then omitted rather than invented.

A copy of ``seldon_core_tpu/health/registry.py``: the port imports nothing of
the JAX package.
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
    """The deployment's current health posture, or None when no runtime
    in this process serves it.  Provider errors surface as None — status
    must never fail because a snapshot did."""
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
