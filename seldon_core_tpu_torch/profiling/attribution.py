"""Per-request device-cost attribution: estimated FLOPs/HBM-bytes per
request, derived from a captured bucket's cost × dynamic-batch share (port
of ``seldon_core_tpu/profiling/attribution.py``).

The engine opens an :func:`attribution_scope` per request (next to the
flight recorder's node-times scope); ``_dispatch_segment`` notes each
executed segment's cost share into the ambient scope
(``cost × request_rows / bucket_rows`` — so the shares of a coalesced
batch sum to the batch's segment total, and padding waste is charged to
nobody).  ``_flight_done`` closes the scope, stamps the totals into the
flight-recorder record, and feeds the rolling window behind
``/admin/profile/capacity`` — the headroom estimate (achievable rps vs.
the card's peak FLOP/s) that answers "how much more traffic fits on this
card" without a load test.  A bucket's cost is counted once, at capture,
from its stages' shapes (``graph/plan.py`` ``count_cost``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Optional

__all__ = [
    "CostAttribution",
    "attribution_scope",
    "note_segment_cost",
    "device_peak_tflops",
    "device_kind",
]

#: per-request accumulator (contextvar — concurrent requests never see
#: each other's costs; mirrors health.flightrecorder._NODE_TIMES)
_REQUEST_COSTS: ContextVar[Optional[list]] = ContextVar(
    "profile_request_costs", default=None
)

#: device name (lowercased substring of ``torch.cuda.get_device_name``)
#: -> peak dense bf16 TFLOP/s, from NVIDIA's H100 Tensor Core GPU
#: datasheet (dense, without sparsity: SXM 989.4, PCIe 756.5).  The more
#: specific name first ("h100 pcie" before "h100").  Headroom estimates,
#: not marketing numbers; SELDON_DEVICE_PEAK_TFLOPS overrides.
_DEVICE_PEAK_TFLOPS = (
    ("h100 pcie", 756.5),
    ("h100", 989.4),
)

_FLOPS_COUNTER = "seldon_request_flops_total"
_HBM_COUNTER = "seldon_request_hbm_bytes_total"
_ATTRIBUTED_COUNTER = "seldon_request_attributed_total"


def device_peak_tflops() -> Optional[float]:
    """Peak dense bf16 TFLOP/s of the local card: the env override
    ``SELDON_DEVICE_PEAK_TFLOPS``, else the Hopper table above keyed on
    ``torch.cuda.get_device_name()``.  A card the table does not name, or
    no card at all, gives None: a capacity estimate against a guessed peak
    would be a wrong number, so capacity then reports no headroom and says
    which override to set."""
    raw = os.environ.get("SELDON_DEVICE_PEAK_TFLOPS")
    if raw:
        try:
            v = float(raw)
            if v > 0:
                return v
        except (TypeError, ValueError):
            pass
    kind = device_kind().lower()
    for sub, peak in _DEVICE_PEAK_TFLOPS:
        if sub in kind:
            return peak
    return None


def device_kind() -> str:
    """``torch.cuda.get_device_name()`` of the current card, or ``cpu``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


class _CostToken:
    __slots__ = ("_token",)

    def __init__(self, token):
        self._token = token

    def close(self) -> dict:
        """End the scope; returns ``{"flops", "hbmBytes", "segments"}``
        (zeros/empty when nothing was attributed)."""
        costs = _REQUEST_COSTS.get() or []
        _REQUEST_COSTS.reset(self._token)
        flops = 0.0
        hbm = 0.0
        segments: dict[str, float] = {}
        for label, f, b in costs:
            flops += f
            hbm += b
            segments[label] = segments.get(label, 0.0) + f
        return {"flops": flops, "hbmBytes": hbm, "segments": segments}


def attribution_scope() -> _CostToken:
    """Open a per-request cost accumulator (engine ``predict``)."""
    return _CostToken(_REQUEST_COSTS.set([]))


def note_segment_cost(label: str, flops: float, hbm_bytes: float) -> None:
    """Record one segment dispatch's share into the ambient scope
    (no-op outside a scope)."""
    costs = _REQUEST_COSTS.get()
    if costs is not None:
        costs.append((label, float(flops), float(hbm_bytes)))


class CostAttribution:
    """Rolling per-request cost window + the capacity/headroom estimate."""

    def __init__(self, metrics=None, deployment: str = "",
                 peak_tflops: Optional[float] = None, clock=time.time,
                 window_s: float = 60.0):
        self.metrics = metrics
        self.deployment = deployment
        self.peak_tflops = (
            float(peak_tflops) if peak_tflops else device_peak_tflops())
        self.device_kind = device_kind()
        self.clock = clock
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._requests: deque[tuple[float, float]] = deque(maxlen=8192)
        self.attributed = 0

    # -- write (engine) --------------------------------------------------
    def note_dispatch(self, label: str, flops: float,
                      hbm_bytes: float) -> None:
        """One segment dispatch share: ambient scope + counters."""
        note_segment_cost(label, flops, hbm_bytes)
        if self.metrics is not None:
            try:
                labels = {"deployment": self.deployment or "engine"}
                self.metrics.counter_inc(_FLOPS_COUNTER, labels, flops)
                if hbm_bytes:
                    self.metrics.counter_inc(_HBM_COUNTER, labels, hbm_bytes)
            except Exception:
                pass

    def note_request(self, flops: float) -> None:
        """One finished request's total (``_flight_done``): feeds the
        capacity window."""
        if flops <= 0:
            return
        with self._lock:
            self._requests.append((self.clock(), float(flops)))
            self.attributed += 1
        if self.metrics is not None:
            try:
                self.metrics.counter_inc(
                    _ATTRIBUTED_COUNTER,
                    {"deployment": self.deployment or "engine"})
            except Exception:
                pass

    # -- read (/admin/profile/capacity) ----------------------------------
    def _window(self) -> list[tuple[float, float]]:
        horizon = self.clock() - self.window_s
        with self._lock:
            return [(ts, f) for ts, f in self._requests if ts >= horizon]

    def occupancy_estimate(self) -> float:
        """Estimated device-FLOP occupancy in [0, 1]: attributed FLOP/s
        over the window vs. device peak (traceview's ``device`` lane)."""
        window = self._window()
        if not window or not self.peak_tflops:
            return 0.0
        span = max(1e-9, self.clock() - window[0][0])
        rate = sum(f for _, f in window) / span
        return min(1.0, rate / (self.peak_tflops * 1e12))

    def capacity(self) -> dict:
        """Headroom estimate: achievable rps at device peak for the
        observed per-request cost, vs. the observed rps (``deviceKind``
        names the card the peak is for)."""
        window = self._window()
        n = len(window)
        out = {
            "windowS": self.window_s,
            "requests": n,
            "attributed": self.attributed,
            "devicePeakTflops": self.peak_tflops,
            "deviceKind": self.device_kind,
        }
        if not self.peak_tflops:
            out["hint"] = (f"no peak FLOP/s known for {self.device_kind!r} "
                           "— set SELDON_DEVICE_PEAK_TFLOPS")
            return out
        if not n:
            out["hint"] = ("no attributed requests in the window — serve "
                           "fused traffic first (seldon.io/graph-plan: "
                           "fused)")
            return out
        span = max(1e-9, self.clock() - window[0][0])
        total_flops = sum(f for _, f in window)
        avg_flops = total_flops / n
        observed_rps = n / span
        achievable_rps = (self.peak_tflops * 1e12) / avg_flops \
            if avg_flops > 0 else float("inf")
        out.update({
            "observedRps": round(observed_rps, 3),
            "avgRequestGflops": round(avg_flops / 1e9, 6),
            "achievableRps": round(achievable_rps, 3),
            "headroom": round(achievable_rps / observed_rps, 3)
            if observed_rps > 0 else None,
            "occupancyEst": round(self.occupancy_estimate(), 6),
        })
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "attributed": self.attributed,
                "window": len(self._requests),
                "devicePeakTflops": self.peak_tflops,
            }
