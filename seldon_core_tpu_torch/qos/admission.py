"""Adaptive admission control: an AIMD concurrency limit and shedding by
priority (port of ``seldon_core_tpu/qos/admission.py``).

``seldon.io/slo-p95-ms`` states the latency objective; the controller
learns the largest concurrency that keeps the observed p95 within it:
additive increase while a window's p95 is under the target,
multiplicative decrease when it is over.  Each priority class may hold
only a fraction of the current limit (low 50%, normal 90%, high 100%), so
``low`` is refused first, then ``normal``.  A refusal answers at once
(429 and ``Retry-After``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from seldon_core_tpu_torch.qos.context import DEFAULT_PRIORITY, priority_rank

__all__ = ["AdmissionConfig", "AdmissionController", "PRIORITY_FRACTION"]

#: the fraction of the current limit each priority class may hold
PRIORITY_FRACTION = {"low": 0.5, "normal": 0.9, "high": 1.0}


@dataclass
class AdmissionConfig:
    target_p95_ms: float = 0.0     # 0: admission control off
    min_limit: int = 4
    max_limit: int = 1024
    initial_limit: int = 32
    window: int = 32               # latency samples per AIMD step
    backoff: float = 0.75          # multiplicative decrease
    step: int = 2                  # additive increase


class AdmissionController:
    """One deployment's admission gate; thread-safe, and ``try_acquire``
    never blocks."""

    def __init__(self, config: AdmissionConfig, name: str = "",
                 metrics=None):
        self.config = config
        self.name = name
        self.metrics = metrics  # MetricsRegistry or None
        self._lock = threading.Lock()
        self.limit = max(config.min_limit,
                         min(config.initial_limit, config.max_limit))
        self.inflight = 0
        self._window: list[float] = []
        self.admitted = 0
        self.shed = 0
        self._gauges()

    def _cap(self, priority: str, limit: int) -> float:
        frac = PRIORITY_FRACTION.get(priority,
                                     PRIORITY_FRACTION[DEFAULT_PRIORITY])
        return max(self.config.min_limit * frac, limit * frac)

    def try_acquire(self, priority: str = DEFAULT_PRIORITY) -> bool:
        """Admit (True) or refuse, by the priority's share of the limit."""
        with self._lock:
            if self.inflight + 1 > self._cap(priority, self.limit):
                self.shed += 1
                if self.metrics is not None:
                    self.metrics.counter_inc(
                        "seldon_qos_shed_total",
                        {"deployment": self.name, "priority": priority,
                         "reason": "admission"})
                return False
            self.inflight += 1
            self.admitted += 1
        if self.metrics is not None:
            self.metrics.counter_inc(
                "seldon_qos_admitted_total",
                {"deployment": self.name, "priority": priority})
            self._gauges()
        return True

    def release(self, latency_s: float, ok: bool = True) -> None:
        """Return a slot; a success feeds the AIMD window one latency (a
        fast failure would read as health and open the limit)."""
        with self._lock:
            self.inflight = max(self.inflight - 1, 0)
            if ok:
                self._window.append(latency_s * 1000.0)
                if len(self._window) >= self.config.window:
                    self._adjust_locked()
        if self.metrics is not None:
            self._gauges()

    def _adjust_locked(self) -> None:
        window, self._window = self._window, []
        if not self.config.target_p95_ms:
            return
        window.sort()
        p95 = window[min(int(len(window) * 0.95), len(window) - 1)]
        if p95 > self.config.target_p95_ms:
            self.limit = max(self.config.min_limit,
                             int(self.limit * self.config.backoff))
        else:
            self.limit = min(self.config.max_limit,
                             self.limit + self.config.step)

    @property
    def shed_level(self) -> int:
        """0: nothing sheds; 1: ``low`` sheds; 2: ``normal`` too; 3: even
        ``high`` (saturated)."""
        with self._lock:
            limit, inflight = self.limit, self.inflight
        level = 0
        for pri in ("low", "normal", "high"):
            if inflight + 1 > self._cap(pri, limit):
                level = priority_rank(pri) + 1
        return level

    def retry_after_s(self) -> float:
        """About one target latency of drain (the wire rounds it to whole
        seconds)."""
        t = self.config.target_p95_ms / 1000.0
        return min(max(t, 0.05), 10.0) if t else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"limit": self.limit, "inflight": self.inflight,
                    "admitted": self.admitted, "shed": self.shed,
                    "targetP95Ms": self.config.target_p95_ms}

    def _gauges(self) -> None:
        if self.metrics is None:
            return
        labels = {"deployment": self.name}
        self.metrics.gauge_set("seldon_qos_concurrency_limit", self.limit,
                               labels)
        self.metrics.gauge_set("seldon_qos_inflight", self.inflight, labels)
        self.metrics.gauge_set("seldon_qos_shed_level", self.shed_level,
                               labels)
