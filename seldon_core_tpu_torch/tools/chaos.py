"""Fault injection for inference graphs (port of
``seldon_core_tpu/tools/chaos.py``).

Serving graphs fail in production through slow or
flaky components; this module wraps any graph node implementation with
injected latency / errors / payload corruption so graph-level behavior
(status propagation, batcher shedding, gateway retries, MAB reward flow)
can be tested deterministically.

Usage (tests or a staging deployment)::

    from seldon_core_tpu_torch.tools.chaos import ChaosWrapper, ChaosPolicy

    flaky = ChaosWrapper(real_component, ChaosPolicy(
        error_rate=0.2, latency_ms=50.0, seed=0))
    engine = GraphEngine(spec, resolver=lambda u: flaky)

Policies are deterministic under ``seed`` — a failing sequence reproduces.
"""

from __future__ import annotations

import asyncio
import inspect
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from seldon_core_tpu_torch.runtime.component import SeldonComponentError

__all__ = ["ChaosPolicy", "ChaosWrapper", "ChaosError", "BurstSchedule"]


@dataclass
class ChaosPolicy:
    # probability a call raises ChaosError (surfaces as FAILURE status /
    # HTTP 500 through the standard error path)
    error_rate: float = 0.0
    # fixed injected latency per call
    latency_ms: float = 0.0
    # extra uniform jitter on top of latency_ms
    jitter_ms: float = 0.0
    # probability a call hangs for hang_ms (timeout / deadline testing)
    hang_rate: float = 0.0
    hang_ms: float = 1000.0
    # synchronous CPU burn per call (host-profiler drills: unlike the
    # asyncio sleeps above this BLOCKS the event loop in a distinctly
    # named frame, so a flamegraph from profiling/hostsampler.py must
    # show `_chaos_cpu_burn` dominating)
    cpu_burn_ms: float = 0.0
    # -- burst mode: deterministic latency spikes over a seeded schedule
    # (overload drills, docs/qos.md): every call landing inside a burst
    # window pays burst_latency_ms EXTRA.  Windows are drawn once from
    # `seed` (BurstSchedule), so a drill's capacity dips reproduce
    # exactly; 0 on either knob disables the mode.
    burst_latency_ms: float = 0.0
    burst_duration_ms: float = 0.0
    # mean gap between burst-window starts (±50% seeded jitter)
    burst_period_ms: float = 1000.0
    # apply faults only to these methods (None = all)
    methods: Optional[set] = None
    seed: Optional[int] = None
    # drill tag: when set, every injected fault stamps a `chaos` event
    # (with this id) onto the request's current span, and the id lands in
    # root-span attributes — so /admin/traces?drill=<id> isolates exactly
    # the traces a fault-injection drill touched (docs/observability.md)
    drill_id: str = ""

    @property
    def burst_enabled(self) -> bool:
        return self.burst_latency_ms > 0 and self.burst_duration_ms > 0


class BurstSchedule:
    """Deterministic burst windows from a seed.

    Window k starts ``period * (0.5 + u_k)`` after window k-1 ends
    (``u_k`` from the seeded stream) and lasts ``duration`` — the whole
    schedule is a pure function of (seed, period, duration), so an
    overload drill's latency spikes land at identical offsets every run.
    Windows materialize lazily as time advances."""

    def __init__(self, seed: Optional[int], period_ms: float,
                 duration_ms: float):
        self._rng = random.Random(seed)
        self.period_s = period_ms / 1000.0
        self.duration_s = duration_ms / 1000.0
        self._windows: list[tuple[float, float]] = []
        self._next_start = self.period_s * (0.5 + self._rng.random())

    def _extend_to(self, t: float) -> None:
        while self._next_start <= t:
            start = self._next_start
            self._windows.append((start, start + self.duration_s))
            self._next_start = (
                start + self.duration_s
                + self.period_s * (0.5 + self._rng.random())
            )

    def active(self, elapsed_s: float) -> bool:
        """Is ``elapsed_s`` (seconds since the schedule's origin) inside
        a burst window?"""
        self._extend_to(elapsed_s)
        for start, end in reversed(self._windows):
            if start <= elapsed_s < end:
                return True
            if end <= elapsed_s:
                break
        return False

    def windows_until(self, elapsed_s: float) -> list[tuple[float, float]]:
        self._extend_to(elapsed_s)
        return [w for w in self._windows if w[0] < elapsed_s]


async def maybe_await(x: Any) -> Any:
    """Await ``x`` if it is awaitable: a wrapped component may be sync or
    async with the same method surface."""
    if inspect.isawaitable(x):
        return await x
    return x


def _chaos_cpu_burn(ms: float) -> int:
    """Synchronous busy loop (module-level, distinctly named so folded
    host-profiler stacks attribute the burn to `chaos:_chaos_cpu_burn`
    rather than an anonymous lambda)."""
    deadline = time.perf_counter() + ms / 1000.0
    acc = 0
    while time.perf_counter() < deadline:
        acc += 1
    return acc


class ChaosError(SeldonComponentError):
    """Injected failure: rides the standard component-error path, so the
    graph engine wires it as a FAILURE status with this reason."""

    def __init__(self, message: str):
        super().__init__(message, status_code=503, reason="CHAOS_INJECTED")


class ChaosWrapper:
    """Wraps a component implementation (sync or async methods) with a
    :class:`ChaosPolicy`.  Exposes the same duck-type surface the engine
    resolves (``has``/``predict``/``route``/``aggregate``/transforms/
    ``send_feedback``) and counts injections for assertions."""

    _METHODS = ("predict", "route", "aggregate", "transform_input",
                "transform_output", "send_feedback")

    def __init__(self, inner: Any, policy: ChaosPolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.policy = policy
        self._rng = random.Random(policy.seed)
        self.injected_errors = 0
        self.injected_delays = 0
        self.injected_bursts = 0
        self.injected_burns = 0
        self.calls = 0
        self.name = getattr(inner, "name", type(inner).__name__)
        # burst schedule: its own seeded stream (per-call draws above stay
        # byte-identical whether or not bursts are enabled) anchored at
        # construction; `clock` is injectable so tests pin the timeline
        self._clock = clock
        self._origin = clock()
        self.bursts: Optional[BurstSchedule] = None
        if policy.burst_enabled:
            self.bursts = BurstSchedule(
                policy.seed, policy.burst_period_ms, policy.burst_duration_ms
            )

    def burst_active(self) -> bool:
        return (self.bursts is not None
                and self.bursts.active(self._clock() - self._origin))

    def has(self, method: str) -> bool:
        inner_has = getattr(self.inner, "has", None)
        if callable(inner_has):
            return inner_has(method)
        return callable(getattr(self.inner, method, None))

    def _armed(self, method: str) -> bool:
        m = self.policy.methods
        return m is None or method in m

    async def _call(self, method: str, *args):
        self.calls += 1
        pol = self.policy
        if self._armed(method):
            # ALL RNG draws happen synchronously BEFORE the first await:
            # drawing after a sleep would order draws by coroutine wakeup,
            # breaking the seeded-reproducibility contract under
            # concurrency (the module's main use case)
            hang = bool(pol.hang_rate and self._rng.random() < pol.hang_rate)
            jitter = self._rng.random() if pol.jitter_ms else 0.0
            fail = bool(pol.error_rate
                        and self._rng.random() < pol.error_rate)
            # burst check BEFORE any await too: activity is a pure
            # function of the (deterministic) schedule and the call's
            # arrival time, not of coroutine wakeup order
            burst = self.burst_active()
            if (hang or fail or burst or pol.latency_ms or pol.jitter_ms
                    or pol.cpu_burn_ms):
                self._mark_span(method, hang=hang, fail=fail, burst=burst,
                                burn=bool(pol.cpu_burn_ms))
            if pol.cpu_burn_ms:
                # deliberately synchronous: the burn holds the event loop
                # (that is the drill — blocking work on the hot path)
                self.injected_burns += 1
                _chaos_cpu_burn(pol.cpu_burn_ms)
            if hang:
                self.injected_delays += 1
                await asyncio.sleep(pol.hang_ms / 1000.0)
            elif pol.latency_ms or pol.jitter_ms:
                self.injected_delays += 1
                await asyncio.sleep(
                    (pol.latency_ms + jitter * pol.jitter_ms) / 1000.0
                )
            if burst:
                self.injected_bursts += 1
                await asyncio.sleep(pol.burst_latency_ms / 1000.0)
            if fail:
                self.injected_errors += 1
                raise ChaosError(
                    f"chaos: injected failure in {self.name}.{method} "
                    f"(call #{self.calls})"
                )
        return await maybe_await(getattr(self.inner, method)(*args))

    def _mark_span(self, method: str, *, hang: bool, fail: bool,
                   burst: bool, burn: bool = False) -> None:
        """Record the injection on the request's current span (no-op when
        tracing is off) — a drilled trace must say it was drilled."""
        from seldon_core_tpu_torch.utils.tracing import current_span

        sp = current_span()
        if sp is None:
            return
        sp.add_event(
            "chaos", target=f"{self.name}.{method}",
            kind=("hang" if hang else "error" if fail
                  else "burst" if burst else "cpu_burn" if burn
                  else "latency"),
            drill_id=self.policy.drill_id,
        )
        if self.policy.drill_id:
            sp.attributes["drill-id"] = self.policy.drill_id

    # -- duck-type surface ----------------------------------------------
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
