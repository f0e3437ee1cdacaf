"""The admin-endpoint body of the placement plane (port of
``seldon_core_tpu/placement/http.py``).

``/admin/placement`` is served by BOTH the gateway (``gateway/app.py``) and
the engine (``serving/rest.py``) with one query surface; the body returns
``(status, payload)`` here and the servers only wrap the transport.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["placement_body"]

_DISABLED = {
    "error": "placement plane disabled",
    "hint": 'enable with annotation seldon.io/mesh: "dp=4" (or '
            '"dp=2,tp=2"); pin segments with seldon.io/placement: '
            '"segment=device,..."',
}


def placement_body(plane: Optional[object],
                   query: Mapping[str, str]) -> Tuple[int, dict]:
    """Segment-to-device assignments, per-device byte loads, and the mesh
    registry.  ``?meshes`` returns only the process-wide mesh registry
    (which topologies this process is committed to)."""
    if plane is None:
        return 404, dict(_DISABLED)
    from seldon_core_tpu_torch.placement.meshes import registry_stats

    if query.get("meshes"):
        return 200, {"meshes": registry_stats()}
    out = plane.describe()
    out["meshes"] = registry_stats()
    return 200, out
