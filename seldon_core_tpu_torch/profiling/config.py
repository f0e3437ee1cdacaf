"""Profiling-plane annotation config (admission-validated; graphlint GL11xx).

The ``seldon.io/profile*`` family turns on the continuous profiling plane
(docs/observability.md): the always-on host sampling profiler, per-segment
capture/cost telemetry, and per-request FLOP attribution — the
"where do the cycles go" pillar next to tracing (sampled) and health
(always-on counters).

The parser honors the same contract as ``health_config_from_annotations``:
raise ``ValueError`` with a path-prefixed, annotation-name-bearing message
on any malformed knob so operator admission (``operator/compile.py
profile_config``) and graphlint (GL1101) share one validation source.

A copy of ``seldon_core_tpu/profiling/config.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = [
    "PROFILE_ANNOTATION",
    "PROFILE_HZ_ANNOTATION",
    "PROFILE_STACKS_ANNOTATION",
    "PROFILE_WINDOW_S_ANNOTATION",
    "PROFILE_STORM_ANNOTATION",
    "ProfileConfig",
    "profile_config_from_annotations",
]

# -- annotations (validated at admission + graphlint GL11xx) -----------------
PROFILE_ANNOTATION = "seldon.io/profile"
PROFILE_HZ_ANNOTATION = "seldon.io/profile-hz"
PROFILE_STACKS_ANNOTATION = "seldon.io/profile-stacks"
PROFILE_WINDOW_S_ANNOTATION = "seldon.io/profile-window-s"
PROFILE_STORM_ANNOTATION = "seldon.io/profile-storm"

_TRUE = ("1", "true", "yes")
_FALSE = ("", "0", "false", "no")


@dataclass(frozen=True)
class ProfileConfig:
    enabled: bool = False
    #: host stack-sampling frequency (samples/second).  The default is a
    #: prime so the sampler never phase-locks with periodic serving work
    #: (batch flush timers, health sampler ticks) and silently misses it.
    hz: float = 19.0
    #: bounded distinct folded-stack table size; overflow folds into the
    #: ``(other)`` bucket so cardinality can cost data, never memory
    stacks: int = 2000
    #: maximum on-demand capture-window length (seconds)
    window_s: float = 30.0
    #: distinct shape-bucket compiles of one segment within the storm
    #: window that flip the recompile-storm signal (>= 2)
    storm: int = 4


def profile_config_from_annotations(ann: dict,
                                    where: str = "") -> ProfileConfig:
    """Parse + validate the profile annotation family; raises ``ValueError``
    with a path-prefixed message on any malformed knob."""
    at = f" at {where}" if where else ""

    flag = str(ann.get(PROFILE_ANNOTATION,
                       os.environ.get("SELDON_PROFILE", ""))).lower()
    if flag not in _TRUE and flag not in _FALSE:
        raise ValueError(
            f"{PROFILE_ANNOTATION}{at}: {flag!r} is not a boolean "
            f"(use one of {_TRUE + _FALSE[1:]})"
        )
    enabled = flag in _TRUE

    raw = ann.get(PROFILE_HZ_ANNOTATION,
                  os.environ.get("SELDON_PROFILE_HZ"))
    hz = 19.0
    if raw is not None:
        try:
            hz = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{PROFILE_HZ_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if not 0.0 < hz <= 1000.0:
            raise ValueError(
                f"{PROFILE_HZ_ANNOTATION}{at}: {hz:g} outside (0, 1000] — "
                f"sampling above 1kHz stops being low-overhead"
            )

    raw = ann.get(PROFILE_STACKS_ANNOTATION)
    stacks = 2000
    if raw is not None:
        try:
            stacks = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{PROFILE_STACKS_ANNOTATION}{at}: {raw!r} is not an integer"
            ) from None
        if stacks <= 0:
            raise ValueError(f"{PROFILE_STACKS_ANNOTATION}{at}: must be > 0")

    raw = ann.get(PROFILE_WINDOW_S_ANNOTATION)
    window_s = 30.0
    if raw is not None:
        try:
            window_s = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{PROFILE_WINDOW_S_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if not 0.0 < window_s <= 600.0:
            raise ValueError(
                f"{PROFILE_WINDOW_S_ANNOTATION}{at}: {window_s:g} outside "
                f"(0, 600] — unbounded capture windows leak device traces"
            )

    raw = ann.get(PROFILE_STORM_ANNOTATION)
    storm = 4
    if raw is not None:
        try:
            storm = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{PROFILE_STORM_ANNOTATION}{at}: {raw!r} is not an integer"
            ) from None
        if storm < 2:
            raise ValueError(
                f"{PROFILE_STORM_ANNOTATION}{at}: must be >= 2 — a single "
                f"compile per shape bucket is normal warmup, not a storm"
            )

    return ProfileConfig(enabled=enabled, hz=hz, stacks=stacks,
                         window_s=window_s, storm=storm)
