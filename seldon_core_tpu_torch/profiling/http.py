"""Shared admin-endpoint bodies for the profiling plane.

``/admin/profile``, ``/admin/profile/capture``, ``/admin/profile/compile``
and ``/admin/profile/capacity`` are served by BOTH the gateway
(gateway/app.py) and the engine (serving/rest.py) with identical query
surfaces; each returns ``(status, payload)`` here and the servers only
wrap the transport.  Numeric query parameters raise ``ValueError`` — the
callers map that to 400 like the ``/admin/health`` handlers do.

A copy of ``seldon_core_tpu/profiling/http.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

__all__ = ["profile_body", "capture_body", "compile_body", "capacity_body"]

_DISABLED = {
    "error": "profiling plane disabled",
    "hint": 'enable with annotation seldon.io/profile: "true", env '
            "SELDON_PROFILE=1 for the gateway",
}


def profile_body(plane: Optional[object],
                 query: Mapping[str, str]) -> Tuple[int, dict]:
    """Always-on collapsed host flamegraph (``?n=`` hottest stacks,
    ``?reset`` zeroes the table after rendering)."""
    if plane is None:
        return 404, _DISABLED
    sampler = plane.sampler
    plane.ensure_started()
    n = int(query["n"]) if "n" in query else None
    out = {
        "service": plane.service,
        "stats": sampler.stats(),
        "folded": sampler.collapsed(n=n),
    }
    if query.get("reset"):
        sampler.reset()
        out["reset"] = True
    return 200, out


def capture_body(plane: Optional[object],
                 query: Mapping[str, str]) -> Tuple[int, dict]:
    """On-demand capture windows.  ``?seconds=`` opens one (optionally
    ``?device=<logdir>`` for an xla_profile device trace alongside);
    ``?id=`` polls it; ``?id=&stop`` finalizes early.  Windows are
    baseline diffs — concurrent windows from both admin surfaces never
    corrupt each other or the always-on table."""
    if plane is None:
        return 404, _DISABLED
    sampler = plane.sampler
    wid = query.get("id")
    if wid:
        result = sampler.read_window(wid, stop=bool(query.get("stop")))
        if result is None:
            return 404, {"error": f"unknown capture window {wid!r}"}
        return 200, result
    seconds = float(query.get("seconds", 5.0))
    limit = plane.config.window_s
    if seconds > limit:
        return 400, {
            "error": f"capture window {seconds:g}s exceeds the "
                     f"seldon.io/profile-window-s cap ({limit:g}s)",
        }
    try:
        window = sampler.open_window(seconds,
                                     device_dir=query.get("device"))
    except ValueError as e:
        return 429, {"error": str(e)}
    return 200, window


def compile_body(plane: Optional[object],
                 query: Mapping[str, str]) -> Tuple[int, dict]:
    """Per-segment compile/cost ledger + live recompile-storm posture."""
    if plane is None:
        return 404, _DISABLED
    return 200, {
        "service": plane.service,
        **plane.compile.snapshot(),
    }


def capacity_body(plane: Optional[object],
                  query: Mapping[str, str]) -> Tuple[int, dict]:
    """Headroom estimate: achievable rps at device peak vs. observed."""
    if plane is None:
        return 404, _DISABLED
    return 200, {
        "service": plane.service,
        **plane.attribution.capacity(),
    }
