"""Multi-window SLO error-budget burn-rate monitor.

Two objectives, two windows, one verdict:

- **availability** — ``seldon.io/slo-availability`` (e.g. ``0.999``)
  leaves an error budget of ``1 - objective``; the burn rate is the
  observed error fraction divided by that budget (burn 1.0 = spending
  the budget exactly as fast as the SLO allows, sustained).
- **latency** — ``seldon.io/slo-p95-ms`` (shared with QoS admission
  control) allows 5% of requests over the target; the burn rate is the
  observed over-target fraction divided by 0.05.

Windows are 5 m and 1 h, evaluated from per-second buckets the serving
path feeds via :meth:`BurnRateMonitor.observe` — the multiwindow
multi-burn-rate pattern from the Google SRE workbook: the short window
proves the burn is *still happening*, the long window that it is
*statistically real*.  Verdict thresholds: burn ≥ 14.4 in both windows
is ``critical`` (a 30-day budget gone in ~2 days), ≥ 6 is ``warn``.

The clock is injectable so tests can roll buckets out of a window
deterministically instead of sleeping.

A copy of ``seldon_core_tpu/health/burnrate.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["BurnRateMonitor", "WINDOWS", "WARN_BURN", "CRITICAL_BURN"]

#: evaluation windows (label → seconds)
WINDOWS = {"5m": 300, "1h": 3600}
#: p95 objective ⇒ 5% of requests may exceed the latency target
LATENCY_BUDGET = 0.05
WARN_BURN = 6.0
CRITICAL_BURN = 14.4
#: below this many requests in the short window the verdict stays ok —
#: one failed request out of two is not a burn signal
MIN_VOLUME = 10


class BurnRateMonitor:
    def __init__(self, slo_p95_ms: Optional[float] = None,
                 slo_availability: Optional[float] = None,
                 clock=time.time):
        self.slo_p95_ms = slo_p95_ms
        self.slo_availability = slo_availability
        self._clock = clock
        self._lock = threading.Lock()
        #: int(second) → [total, errors, slow]
        self._buckets: dict[int, list] = {}
        self.total = 0
        self.errors = 0

    # -- feed -----------------------------------------------------------
    def observe(self, latency_ms: float, error: bool) -> None:
        """Account one finished request (every request, never sampled)."""
        now = int(self._clock())
        slow = (self.slo_p95_ms is not None
                and latency_ms > self.slo_p95_ms)
        with self._lock:
            bucket = self._buckets.get(now)
            if bucket is None:
                bucket = self._buckets[now] = [0, 0, 0]
                self._prune(now)
            bucket[0] += 1
            bucket[1] += 1 if error else 0
            bucket[2] += 1 if slow else 0
            self.total += 1
            self.errors += 1 if error else 0

    def _prune(self, now: int) -> None:
        horizon = now - max(WINDOWS.values())
        for sec in [s for s in self._buckets if s <= horizon]:
            del self._buckets[sec]

    # -- evaluate -------------------------------------------------------
    def _window(self, seconds: int, now: int) -> tuple[int, int, int]:
        total = errors = slow = 0
        for sec, (t, e, s) in self._buckets.items():
            if sec > now - seconds:
                total += t
                errors += e
                slow += s
        return total, errors, slow

    def burn(self) -> dict:
        """Per-objective, per-window burn rates + raw window counts."""
        now = int(self._clock())
        with self._lock:
            windows = {
                label: self._window(seconds, now)
                for label, seconds in WINDOWS.items()
            }
        out: dict = {"windows": {}, "burn": {}}
        for label, (total, errors, slow) in windows.items():
            out["windows"][label] = {
                "total": total, "errors": errors, "slow": slow,
            }
        if self.slo_availability is not None:
            budget = 1.0 - self.slo_availability
            out["burn"]["availability"] = {
                label: round((e / t) / budget, 3) if t else 0.0
                for label, (t, e, _) in windows.items()
            }
        if self.slo_p95_ms is not None:
            out["burn"]["latency"] = {
                label: round((s / t) / LATENCY_BUDGET, 3) if t else 0.0
                for label, (t, _, s) in windows.items()
            }
        return out

    def verdict(self) -> dict:
        """Machine-readable health verdict: ok/warn/critical plus the
        objectives that contribute to it."""
        state = self.burn()
        level = 0
        signals: list[str] = []
        short = min(WINDOWS, key=WINDOWS.get)
        volume_ok = state["windows"][short]["total"] >= MIN_VOLUME
        for objective, rates in state["burn"].items():
            worst = min(rates.values())  # burn must exceed in EVERY window
            if not volume_ok:
                continue
            if worst >= CRITICAL_BURN:
                level = max(level, 2)
                signals.append(f"{objective}-burn")
            elif worst >= WARN_BURN:
                level = max(level, 1)
                signals.append(f"{objective}-burn")
        return {
            "verdict": ("ok", "warn", "critical")[level],
            "level": level,
            "signals": signals,
            "slo": {
                "p95Ms": self.slo_p95_ms,
                "availability": self.slo_availability,
            },
            **state,
        }
