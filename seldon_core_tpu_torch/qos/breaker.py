"""Circuit breakers around remote graph nodes (port of
``seldon_core_tpu/qos/breaker.py``).

After a rolling window shows a component failing (error rate) or
drowning (slow calls), calls stop leaving the process: the walk gets an
immediate 503 ``CIRCUIT_OPEN`` (and the engine serves the
``seldon.io/qos-fallback`` subgraph), the component gets time to recover,
and after a cooldown a few half-open probes decide whether traffic
resumes.

- ``closed``: every call's outcome and latency land in the window; over
  ``min_calls`` samples the breaker opens at ``error_rate >=
  error_threshold`` or ``slow_rate >= slow_threshold`` (slow: past
  ``slow_ms``).
- ``open``: calls are refused for ``open_s``.
- ``half_open``: up to ``probes`` trial calls; one failure reopens,
  ``probes`` successes close.

A 4xx answer is the caller's fault and never counts as a failure; a 5xx
does.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from seldon_core_tpu_torch.runtime.component import SeldonComponentError

__all__ = ["BreakerConfig", "BreakerOpenError", "CircuitBreaker",
           "BreakerWrapper", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpenError(SeldonComponentError):
    """The call was short-circuited: the component's breaker is open."""

    def __init__(self, message: str):
        super().__init__(message, status_code=503, reason="CIRCUIT_OPEN")


@dataclass
class BreakerConfig:
    window_s: float = 10.0        # rolling observation window
    min_calls: int = 10           # samples before the breaker may open
    error_threshold: float = 0.5  # error fraction that opens it
    slow_ms: float = 0.0          # 0: slow calls are not counted
    slow_threshold: float = 0.8   # slow fraction that opens it
    open_s: float = 5.0           # cooldown before half-open probes
    probes: int = 3               # half-open trial calls


class CircuitBreaker:
    """One component's breaker; thread-safe."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 name: str = "", metrics=None):
        self.config = config or BreakerConfig()
        self.name = name
        self.metrics = metrics
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._half_open_successes = 0
        self._samples: deque[tuple[float, bool, bool]] = deque()
        self.short_circuits = 0
        self._gauge()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def allow(self) -> bool:
        """May a call go now?  A caller told yes must ``record`` it."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and \
                    self._half_open_inflight < self.config.probes:
                self._half_open_inflight += 1
                return True
            self.short_circuits += 1
            return False

    def record(self, ok: bool, latency_s: float = 0.0) -> None:
        cfg = self.config
        slow = bool(cfg.slow_ms and latency_s * 1000.0 >= cfg.slow_ms)
        now = time.monotonic()
        with self._lock:
            if self._state == HALF_OPEN:
                self._half_open_inflight = max(
                    self._half_open_inflight - 1, 0)
                if ok and not slow:
                    self._half_open_successes += 1
                    if self._half_open_successes >= cfg.probes:
                        self._transition_locked(CLOSED)
                        self._samples.clear()
                else:
                    self._transition_locked(OPEN)
                    self._opened_at = now
                return
            self._samples.append((now, ok, slow))
            cutoff = now - cfg.window_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            n = len(self._samples)
            if n < cfg.min_calls or self._state != CLOSED:
                return
            errors = sum(1 for _, k, _s in self._samples if not k)
            slows = sum(1 for _, _k, s in self._samples if s)
            if errors / n >= cfg.error_threshold or \
                    (cfg.slow_ms and slows / n >= cfg.slow_threshold):
                self._transition_locked(OPEN)
                self._opened_at = now

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN and \
                time.monotonic() - self._opened_at >= self.config.open_s:
            self._transition_locked(HALF_OPEN)
            self._half_open_inflight = 0
            self._half_open_successes = 0

    def _transition_locked(self, to: str) -> None:
        if self._state == to:
            return
        self._state = to
        if self.metrics is not None:
            self.metrics.counter_inc("seldon_qos_breaker_transitions_total",
                                     {"component": self.name, "to": to})
        self._gauge()

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge_set("seldon_qos_breaker_state",
                                   _STATE_GAUGE[self._state],
                                   {"component": self.name})

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open_locked()
            return {"component": self.name, "state": self._state,
                    "shortCircuits": self.short_circuits,
                    "windowSamples": len(self._samples)}


def _is_backend_failure(e: SeldonComponentError) -> bool:
    return e.status_code >= 500 or e.status_code == 0


class BreakerWrapper:
    """A remote node's client (``RemoteComponent``,
    ``GrpcComponentClient``) behind a :class:`CircuitBreaker`; ``has``
    and every other attribute go to the client."""

    def __init__(self, inner: Any, breaker: Optional[CircuitBreaker] = None,
                 name: str = "", metrics=None):
        self.inner = inner
        self.name = name or getattr(inner, "name", type(inner).__name__)
        self.breaker = breaker or CircuitBreaker(name=self.name,
                                                 metrics=metrics)
        self.breaker.name = self.breaker.name or self.name

    def has(self, method: str) -> bool:
        inner_has = getattr(self.inner, "has", None)
        if callable(inner_has):
            return inner_has(method)
        return callable(getattr(self.inner, method, None))

    async def _call(self, method: str, *args):
        if not self.breaker.allow():
            raise BreakerOpenError(
                f"circuit open for component {self.name!r} "
                f"({self.breaker.snapshot()['state']})")
        t0 = time.perf_counter()
        try:
            out = getattr(self.inner, method)(*args)
            if inspect.isawaitable(out):
                out = await out
        except SeldonComponentError as e:
            self.breaker.record(ok=not _is_backend_failure(e),
                                latency_s=time.perf_counter() - t0)
            raise
        except Exception:
            self.breaker.record(ok=False, latency_s=time.perf_counter() - t0)
            raise
        self.breaker.record(ok=True, latency_s=time.perf_counter() - t0)
        return out

    async def predict(self, msg):
        return await self._call("predict", msg)

    async def route(self, msg):
        return await self._call("route", msg)

    async def aggregate(self, msgs):
        return await self._call("aggregate", msgs)

    async def transform_input(self, msg):
        return await self._call("transform_input", msg)

    async def transform_output(self, msg):
        return await self._call("transform_output", msg)

    async def send_feedback(self, fb):
        return await self._call("send_feedback", fb)

    def __getattr__(self, item):
        return getattr(self.inner, item)
