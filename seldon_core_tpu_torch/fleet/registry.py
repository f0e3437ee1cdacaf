"""Process-local fleet state registry: live fleet facts → control plane.

The reconcile loop surfaces each deployment's *current* fleet posture
(replica membership/health, routing policy, autoscale signals) on the
CR's ``status.fleet`` block, refreshed on the same tick as replica
availability — and the operator autoscale loop reads the same snapshot
for its demand/capacity/burn signals.  Pools and harnesses are runtime
objects inside gateway or engine processes; this registry is the seam
between them and the operator, exactly like ``qos/registry.py``.

In the colocated dev/test harness (LocalFleet + FakeKubeApi in one
process) this is live state; in a real cluster each process exposes the
same facts via ``/admin/fleet`` and its ``seldon_fleet_*`` gauges and
the operator-side registry stays empty — ``status.fleet`` is then
omitted rather than invented.

Port of ``seldon_core_tpu/fleet/registry.py``: the same names, bodies and
behaviour, on the standard library.
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
    """The deployment's current fleet posture, or None when no runtime in
    this process serves it.  Provider errors surface as None — status
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
