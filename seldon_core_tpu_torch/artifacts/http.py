"""The ``/admin/artifacts`` body (port of
``seldon_core_tpu/artifacts/http.py``, the same bodies): ``(status,
payload)`` here, the server only wraps the transport
(``serving/rest.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["artifacts_body"]

_DISABLED = {
    "error": "artifact plane disabled",
    "hint": 'point seldon.io/artifact-store (or the SELDON_ARTIFACT_STORE '
            'env) at the artifact directory; requires '
            'seldon.io/graph-plan: "fused"',
}


def artifacts_body(plane: Optional[object],
                   query: Mapping[str, str]) -> Tuple[int, dict]:
    """Warm-start posture: store occupancy, hydration/publish/parity
    counters, per-segment bucket provenance.  ``?coverage`` returns only
    the compact coverage verdict (the fleet admission gate's input)."""
    if plane is None:
        return 404, _DISABLED
    if query.get("coverage"):
        return 200, plane.coverage()
    return 200, plane.describe()
