"""Capture observability: the per-segment capture ledger (port of
``seldon_core_tpu/profiling/compilewatch.py``, whose compile ledger this
is on the card).

Every :class:`~seldon_core_tpu_torch.graph.plan.FusedSegment` reports each
shape bucket it captures as a CUDA graph here (the capture's wall time,
the bucket's FLOPs and bytes counted from its stages' shapes, its graph
pool's bytes as the peak).  A bucket captured at boot from the artifact
store lands as ``source="aot-cache"``.  The watch keeps a bounded
per-segment ledger, exports the ``seldon_compile_*`` metrics (the
reference's names), and raises the **storm** signal —
``seldon.io/profile-storm`` distinct shape buckets captured within
:data:`STORM_WINDOW_S` — which the health plane fuses into the
``/admin/health`` verdict: a capture runs the segment eagerly, captures
and checks a replay, so shape churn is a production incident, not a
curiosity.  The LLM engines' programs are not on this ledger, as the
reference's engines are not on its.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["CompileWatch", "STORM_WINDOW_S"]

#: recompile-storm evaluation window (seconds): ``storm_threshold``
#: compiles of ONE segment inside this window flip the signal
STORM_WINDOW_S = 60.0

_COMPILE_COUNTER = "seldon_compile_total"
_COMPILE_WALL_COUNTER = "seldon_compile_wall_ms_total"
_HYDRATED_COUNTER = "seldon_compile_hydrated_total"
_FLOPS_GAUGE = "seldon_compile_flops"
_BYTES_GAUGE = "seldon_compile_bytes_accessed"
_PEAK_HBM_GAUGE = "seldon_compile_peak_hbm_bytes"
_STORM_GAUGE = "seldon_compile_storm"

#: shape buckets remembered per segment (oldest evicted — a storm by
#: definition churns buckets, the ledger must not churn memory with it)
_MAX_BUCKETS = 64


class CompileWatch:
    """Thread-safe ledger of segment compiles + recompile-storm signal."""

    def __init__(self, metrics=None, storm_threshold: int = 4,
                 clock=time.time):
        self.metrics = metrics
        self.storm_threshold = max(2, int(storm_threshold))
        self.clock = clock
        self._lock = threading.Lock()
        # segment label -> {"compiles", "wall_ms_total", "last_wall_ms",
        #                   "buckets": {bucket: cost dict},
        #                   "recent": deque[ts]}
        self._segments: dict[str, dict] = {}

    # -- write (FusedSegment capture path) -------------------------------
    def note_compile(self, segment: str, bucket: str = "",
                     wall_ms: float = 0.0, flops: float = 0.0,
                     bytes_accessed: float = 0.0,
                     peak_hbm_bytes: float = 0.0,
                     source: str = "live") -> None:
        """Record one shape-bucket ledger row; O(1), never raises (the
        caller is the serving path's first dispatch per bucket).

        ``source`` records the path: ``"live"`` is a capture made on
        first sight — it counts toward ``compiles``/``seldon_compile_total``
        and the storm window; ``"aot-cache"`` is a bucket captured at boot
        from the artifact store's record (artifacts/plane.py) — it lands
        on the ledger as a ``hydrations`` row so the bucket is visible,
        but a warm boot keeps a ZERO compile count and cannot trip the
        storm signal."""
        now = self.clock()
        live = source == "live"
        try:
            with self._lock:
                seg = self._segments.setdefault(segment, {
                    "compiles": 0,
                    "hydrations": 0,
                    "wall_ms_total": 0.0,
                    "last_wall_ms": 0.0,
                    "buckets": {},
                    "recent": deque(maxlen=64),
                })
                if live:
                    seg["compiles"] += 1
                    seg["wall_ms_total"] += float(wall_ms)
                    seg["last_wall_ms"] = float(wall_ms)
                    seg["recent"].append(now)
                else:
                    seg["hydrations"] = seg.get("hydrations", 0) + 1
                if len(seg["buckets"]) >= _MAX_BUCKETS and bucket not in \
                        seg["buckets"]:
                    seg["buckets"].pop(next(iter(seg["buckets"])))
                seg["buckets"][bucket] = {
                    "wall_ms": round(float(wall_ms), 3),
                    "flops": float(flops),
                    "bytes_accessed": float(bytes_accessed),
                    "peak_hbm_bytes": float(peak_hbm_bytes),
                    "source": source,
                    "ts": now,
                }
                storm = self._storm_locked(seg, now)
        except Exception:
            return
        # metrics strictly outside the ledger lock (same discipline as
        # the host sampler — never order-couple with the registry lock)
        if self.metrics is not None:
            try:
                labels = {"segment": segment, "bucket": bucket}
                if live:
                    self.metrics.counter_inc(_COMPILE_COUNTER, labels)
                    self.metrics.counter_inc(
                        _COMPILE_WALL_COUNTER, {"segment": segment},
                        wall_ms)
                else:
                    self.metrics.counter_inc(_HYDRATED_COUNTER, labels)
                if flops:
                    self.metrics.gauge_set(_FLOPS_GAUGE, flops, labels)
                if bytes_accessed:
                    self.metrics.gauge_set(_BYTES_GAUGE, bytes_accessed,
                                           labels)
                if peak_hbm_bytes:
                    self.metrics.gauge_set(_PEAK_HBM_GAUGE, peak_hbm_bytes,
                                           labels)
                self.metrics.gauge_set(
                    _STORM_GAUGE, 1.0 if storm else 0.0,
                    {"segment": segment})
            except Exception:
                pass

    def _storm_locked(self, seg: dict, now: float) -> bool:
        recent = [t for t in seg["recent"] if now - t <= STORM_WINDOW_S]
        return len(recent) >= self.storm_threshold

    # -- read -----------------------------------------------------------
    def storm_segments(self) -> list[str]:
        """Segments currently inside a recompile storm (the health
        verdict's input; empty list = signal clear)."""
        now = self.clock()
        with self._lock:
            return sorted(
                label for label, seg in self._segments.items()
                if self._storm_locked(seg, now)
            )

    def snapshot(self) -> dict:
        """``/admin/profile/compile`` payload: the full ledger plus the
        live storm posture."""
        now = self.clock()
        with self._lock:
            segments = {}
            for label, seg in self._segments.items():
                segments[label] = {
                    "compiles": seg["compiles"],
                    "hydrations": seg.get("hydrations", 0),
                    "wallMsTotal": round(seg["wall_ms_total"], 3),
                    "lastWallMs": round(seg["last_wall_ms"], 3),
                    "storm": self._storm_locked(seg, now),
                    "buckets": {
                        b: dict(cost) for b, cost in seg["buckets"].items()
                    },
                }
        return {
            "stormThreshold": self.storm_threshold,
            "stormWindowS": STORM_WINDOW_S,
            "storm": sorted(l for l, s in segments.items() if s["storm"]),
            "segments": segments,
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "compiles": sum(
                    s["compiles"] for s in self._segments.values()),
                "hydrations": sum(
                    s.get("hydrations", 0)
                    for s in self._segments.values()),
                "wallMsTotal": round(sum(
                    s["wall_ms_total"] for s in self._segments.values()), 3),
            }
