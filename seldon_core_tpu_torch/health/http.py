"""Shared admin-endpoint bodies for the health plane.

``/admin/introspect``, ``/admin/flightrecorder`` and ``/admin/health``
are served by BOTH the gateway (gateway/app.py) and the engine
(serving/rest.py) with identical query surfaces; each returns
``(status, payload)`` here and the servers only wrap the transport.
Numeric query parameters raise ``ValueError`` — the callers map that to
400 like the ``/admin/traces`` handlers do.

A copy of ``seldon_core_tpu/health/http.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["introspect_body", "flightrecorder_body", "health_body"]

_DISABLED = {
    "error": "health plane disabled",
    "hint": 'enable with annotation seldon.io/health: "true" (or set '
            "seldon.io/slo-availability), env SELDON_HEALTH=1 for the "
            "gateway",
}


def introspect_body(plane: Optional[object],
                    query: Mapping[str, str]) -> Tuple[int, dict]:
    """Bounded introspection timelines (``?n=``, ``?probe=``, ``?stats``)."""
    if plane is None:
        return 404, _DISABLED
    sampler = plane.sampler
    if query.get("stats"):
        return 200, {"stats": sampler.stats()}
    n = int(query["n"]) if "n" in query else None
    probe = query.get("probe")
    if probe is not None and probe not in sampler.probe_names:
        return 404, {
            "error": f"unknown probe {probe!r}",
            "probes": sampler.probe_names,
        }
    return 200, {
        "service": plane.service,
        "stats": sampler.stats(),
        "samples": sampler.timeline(n=n, probe=probe),
    }


def flightrecorder_body(plane: Optional[object],
                        query: Mapping[str, str]) -> Tuple[int, dict]:
    """Filtered flight-recorder view — the same filter surface as
    ``/admin/traces`` (``?deployment= ?status= ?puid= ?min_ms=
    ?errors_only= ?replica= ?n= ?stats``)."""
    if plane is None:
        return 404, _DISABLED
    recorder = plane.recorder
    if query.get("stats"):
        return 200, {"stats": recorder.stats()}
    records = recorder.query(
        deployment=query.get("deployment"),
        status=int(query["status"]) if "status" in query else None,
        puid=query.get("puid"),
        min_ms=float(query["min_ms"]) if "min_ms" in query else None,
        errors_only=str(query.get("errors_only", "")).lower()
        in ("1", "true", "yes"),
        replica=query.get("replica"),
        n=int(query.get("n", 50)),
    )
    return 200, {"records": records, "stats": recorder.stats()}


def health_body(plane: Optional[object],
                query: Mapping[str, str]) -> Tuple[int, dict]:
    """Machine-readable verdict.  ``?verbose`` adds the latest
    introspection sample so one GET answers "unhealthy, and here is
    what the runtime looked like"."""
    if plane is None:
        return 404, _DISABLED
    verdict = plane.verdict()
    if query.get("verbose"):
        verdict["introspection"] = plane.sampler.latest()
        verdict["flightRecorder"] = plane.recorder.stats()
    return 200, verdict
