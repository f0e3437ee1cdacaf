"""Fleet-observability annotation config (graphlint GL14xx): the
``seldon.io/fleet-obs-*`` family and its parser, as in
``seldon_core_tpu/fleet/observe.py``.  The scraper, the mergers and the
skew analysis that read it come with a later slice.

Annotations::

    seldon.io/fleet-obs-interval-ms: "2000"   # health-scrape cache TTL
    seldon.io/fleet-obs-timeout-ms:  "1500"   # per-replica scrape budget
    seldon.io/fleet-obs-concurrency: "8"      # scatter-gather width
    seldon.io/fleet-obs-mad-k:       "3.5"    # outlier threshold (MADs)
    seldon.io/fleet-obs-audit:       "256"    # decision-ring capacity
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

__all__ = [
    "OBS_INTERVAL_ANNOTATION",
    "OBS_TIMEOUT_ANNOTATION",
    "OBS_CONCURRENCY_ANNOTATION",
    "OBS_MAD_K_ANNOTATION",
    "OBS_AUDIT_ANNOTATION",
    "ObserveConfig",
    "observe_config_from_annotations",
]

OBS_INTERVAL_ANNOTATION = "seldon.io/fleet-obs-interval-ms"
OBS_TIMEOUT_ANNOTATION = "seldon.io/fleet-obs-timeout-ms"
OBS_CONCURRENCY_ANNOTATION = "seldon.io/fleet-obs-concurrency"
OBS_MAD_K_ANNOTATION = "seldon.io/fleet-obs-mad-k"
OBS_AUDIT_ANNOTATION = "seldon.io/fleet-obs-audit"

#: a robust z-score threshold: 1.4826 * MAD estimates one standard
#: deviation for normal data, so this reads "more than ~3.5 sigma slower
#: than the fleet median"
DEFAULT_MAD_K = 3.5


@dataclass(frozen=True)
class ObserveConfig:
    #: fleet-health scrape results are cached this long (ms); 0 disables
    #: the cache (every request re-scrapes)
    interval_ms: float = 2000.0
    #: per-replica scrape budget — a slow replica delays only itself
    timeout_ms: float = 1500.0
    #: scatter-gather width (how many replicas are scraped at once)
    concurrency: int = 8
    #: MAD multiples past the fleet median before a replica is an outlier
    mad_k: float = DEFAULT_MAD_K
    #: decision audit ring capacity
    audit_capacity: int = 256

    @property
    def knobs_set(self) -> bool:
        """Any non-default knob present (graphlint dead-knob check)."""
        return self != ObserveConfig()


def _parse_pos_float(raw, name: str, at: str, minimum: float) -> float:
    try:
        v = float(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(f"{name}{at}: {raw!r} is not a number") from None
    if v < minimum:
        raise ValueError(f"{name}{at}: {v:g} must be >= {minimum:g}")
    return v


def _parse_pos_int(raw, name: str, at: str) -> int:
    try:
        n = int(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(f"{name}{at}: {raw!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{name}{at}: {n} must be >= 1")
    return n


def observe_config_from_annotations(ann: Mapping,
                                    where: str = "") -> ObserveConfig:
    """Parse + validate the ``seldon.io/fleet-obs-*`` family; raises
    ``ValueError`` with a path-prefixed, annotation-name-bearing message
    on any malformed knob."""
    at = f" at {where}" if where else ""
    kw: dict = {}
    raw = ann.get(OBS_INTERVAL_ANNOTATION)
    if raw is not None:
        kw["interval_ms"] = _parse_pos_float(
            raw, OBS_INTERVAL_ANNOTATION, at, 0.0)
    raw = ann.get(OBS_TIMEOUT_ANNOTATION)
    if raw is not None:
        kw["timeout_ms"] = _parse_pos_float(
            raw, OBS_TIMEOUT_ANNOTATION, at, 1.0)
    raw = ann.get(OBS_CONCURRENCY_ANNOTATION)
    if raw is not None:
        kw["concurrency"] = _parse_pos_int(raw, OBS_CONCURRENCY_ANNOTATION, at)
    raw = ann.get(OBS_MAD_K_ANNOTATION)
    if raw is not None:
        kw["mad_k"] = _parse_pos_float(raw, OBS_MAD_K_ANNOTATION, at, 0.1)
    raw = ann.get(OBS_AUDIT_ANNOTATION)
    if raw is not None:
        kw["audit_capacity"] = _parse_pos_int(raw, OBS_AUDIT_ANNOTATION, at)
    return ObserveConfig(**kw)
