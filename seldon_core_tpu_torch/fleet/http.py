"""Shared admin-endpoint body for the fleet plane.

``/admin/fleet`` is served by BOTH the gateway (gateway/app.py — per-
replica health/load/hash-ring view of every pooled deployment) and the
engine (serving/rest.py — the local harness's fleet snapshot) with an
identical query surface; the body returns ``(status, payload)`` here and
the servers only wrap the transport, mirroring ``placement/http.py``.

Port of ``seldon_core_tpu/fleet/http.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["fleet_body"]

_DISABLED = {
    "error": "fleet plane disabled",
    "hint": 'enable with annotation seldon.io/fleet-replicas: "3"; pick a '
            'routing policy with seldon.io/fleet-policy: "least-loaded" | '
            '"consistent-hash" | "round-robin"',
}


def fleet_body(plane: Optional[object],
               query: Mapping[str, str]) -> Tuple[int, dict]:
    """Per-replica membership, health state, load, and the hash ring.

    ``plane`` is either one pool/harness (has ``snapshot()``) or a
    mapping of deployment name → pool (the gateway's per-deployment pool
    dict).  ``?deployment=name`` filters the mapping form."""
    if plane is None:
        return 404, _DISABLED
    if hasattr(plane, "snapshot"):
        return 200, plane.snapshot()
    pools = {name: pool for name, pool in dict(plane).items()
             if pool is not None}
    if not pools:
        return 404, _DISABLED
    want = query.get("deployment")
    if want is not None:
        pool = pools.get(want)
        if pool is None:
            return 404, {"error": f"no fleet pool for deployment {want!r}",
                         "deployments": sorted(pools)}
        return 200, pool.snapshot()
    return 200, {
        "deployments": {name: pool.snapshot()
                        for name, pool in sorted(pools.items())}
    }
