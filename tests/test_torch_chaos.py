"""Fault injection (``seldon_core_tpu_torch/tools/chaos.py``) against the
reference's ``tools/chaos.py``: burst schedules EQUAL window for window
under one seed, the per-call error/jitter/hang draws EQUAL call for call,
and the graph-level failure contract of ``tests/test_chaos.py`` on the
port's engine (a FAILURE status with the chaos reason, concurrent
fan-out, the named CPU-burn frame the port's host sampler sees)."""

import asyncio
import time

import numpy as np
import pytest

from seldon_core_tpu.tools import chaos as rchaos
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
from seldon_core_tpu_torch.runtime.component import (
    ComponentHandle,
    SeldonComponentError,
)
from seldon_core_tpu_torch.tools import chaos as pchaos
from seldon_core_tpu_torch.tools.chaos import (
    ChaosError,
    ChaosPolicy,
    ChaosWrapper,
)


class Identity:
    def predict(self, X, names):
        return X


def wrap(policy, user=None):
    return ChaosWrapper(ComponentHandle(user or Identity(), name="m"), policy)


def engine_with(wrapper):
    return GraphEngine({"name": "m", "type": "MODEL"},
                       resolver=lambda u: wrapper)


def run_predict(eng, x=None):
    msg = SeldonMessage.from_ndarray(
        np.asarray(x if x is not None else [[1.0, 2.0]], np.float32))
    return asyncio.run(eng.predict(msg))


@pytest.mark.parametrize("seed,period,duration", [
    (7, 100.0, 30.0), (8, 100.0, 30.0), (0, 5.0, 1.0), (42, 1000.0, 250.0),
    (123, 40.0, 39.0)])
def test_burst_schedule_equals_the_reference(seed, period, duration):
    a = pchaos.BurstSchedule(seed, period, duration)
    b = rchaos.BurstSchedule(seed, period, duration)
    probes = np.linspace(0.0, 5.0, 997)
    assert [a.active(t) for t in probes] == [b.active(t) for t in probes]
    assert a.windows_until(5.0) == b.windows_until(5.0)
    assert a.windows_until(9.0) == b.windows_until(9.0)


class _Echo:
    async def predict(self, msg):
        return msg


async def _outcomes(mod, policy_kw, n=40):
    """The wrapper's per-call verdicts and counters for a seeded policy
    on a pinned clock."""
    now = [0.0]
    w = mod.ChaosWrapper(_Echo(), mod.ChaosPolicy(**policy_kw),
                         clock=lambda: now[0])
    out = []
    for i in range(n):
        now[0] = i * 0.003
        try:
            await w.predict(None)
            out.append("ok")
        except Exception as e:
            out.append((type(e).__name__, getattr(e, "status_code", None),
                        getattr(e, "reason", None), str(e)))
    return out, (w.calls, w.injected_errors, w.injected_delays,
                 w.injected_bursts, w.injected_burns)


@pytest.mark.parametrize("policy", [
    {"error_rate": 0.4, "seed": 3},
    {"error_rate": 0.3, "jitter_ms": 0.2, "seed": 11},
    {"hang_rate": 0.2, "hang_ms": 0.1, "error_rate": 0.2, "seed": 5},
    {"error_rate": 0.5, "seed": 1, "burst_latency_ms": 0.1,
     "burst_duration_ms": 10.0, "burst_period_ms": 20.0},
    {"error_rate": 1.0, "methods": {"send_feedback"}, "seed": 0},
], ids=["errors", "jitter", "hang", "bursts", "methods"])
def test_wrapper_draws_equal_the_reference(policy):
    assert asyncio.run(_outcomes(pchaos, policy)) == \
        asyncio.run(_outcomes(rchaos, policy))


def test_chaos_error_is_the_ports_component_error():
    e = ChaosError("x")
    assert isinstance(e, SeldonComponentError)
    assert (e.status_code, e.reason) == (503, "CHAOS_INJECTED")


def test_injected_error_becomes_failure_status():
    w = wrap(ChaosPolicy(error_rate=1.0, seed=0))
    out = run_predict(engine_with(w))
    assert (out.status.status, out.status.code, out.status.reason) == (
        "FAILURE", 503, "CHAOS_INJECTED")
    assert w.injected_errors == 1


def test_error_rate_is_deterministic_under_seed():
    def outcomes(seed):
        eng = engine_with(wrap(ChaosPolicy(error_rate=0.5, seed=seed)))
        res = [run_predict(eng) for _ in range(20)]
        return [r.status.status if r.status else "SUCCESS" for r in res]

    a = outcomes(42)
    assert a == outcomes(42)
    assert "FAILURE" in a and "SUCCESS" in a


def test_latency_injection_delays_the_call():
    w = wrap(ChaosPolicy(latency_ms=80.0, seed=0))
    t0 = time.perf_counter()
    out = run_predict(engine_with(w))
    assert time.perf_counter() - t0 >= 0.07
    assert out.status is None or out.status.status == "SUCCESS"
    assert w.injected_delays == 1


def test_burst_latency_lands_inside_windows_only():
    now = [0.0]
    w = ChaosWrapper(_Echo(), ChaosPolicy(
        burst_latency_ms=1.0, burst_duration_ms=50.0, burst_period_ms=100.0,
        seed=0), clock=lambda: now[0])
    start, end = w.bursts.windows_until(2.0)[0]
    now[0] = (start + end) / 2
    asyncio.run(w.predict(SeldonMessage()))
    assert w.injected_bursts == 1
    now[0] = end + 1e-3
    assert not w.burst_active()
    asyncio.run(w.predict(SeldonMessage()))
    assert w.injected_bursts == 1


def test_cpu_burn_blocks_the_loop():
    w = wrap(ChaosPolicy(cpu_burn_ms=30.0, seed=0))
    eng = engine_with(w)
    ticks = []

    async def drill():
        async def ticker():
            while True:
                ticks.append(time.perf_counter())
                await asyncio.sleep(0)

        t = asyncio.ensure_future(ticker())
        for _ in range(3):
            await asyncio.sleep(0)
        await eng.predict(SeldonMessage.from_ndarray(
            np.asarray([[1.0, 2.0]], np.float32)))
        await asyncio.sleep(0)
        t.cancel()

    asyncio.run(drill())
    assert w.injected_burns == 1
    assert max(b - a for a, b in zip(ticks, ticks[1:])) >= 0.02


def test_cpu_burn_frame_visible_to_the_ports_host_sampler():
    from seldon_core_tpu_torch.profiling import HostSampler

    sampler = HostSampler(hz=200.0)
    eng = engine_with(wrap(ChaosPolicy(cpu_burn_ms=120.0, seed=0)))
    sampler.ensure_started()
    try:
        run_predict(eng)
    finally:
        sampler.stop()
    assert any("_chaos_cpu_burn" in stack for stack in sampler.folded())


def test_methods_filter_scopes_faults():
    class Learner(Identity):
        def send_feedback(self, request, names, reward, truth, routing=None):
            pass

    eng = engine_with(wrap(ChaosPolicy(error_rate=1.0,
                                       methods={"send_feedback"}, seed=0),
                           user=Learner()))
    out = run_predict(eng)
    assert out.status is None or out.status.status == "SUCCESS"
    res = asyncio.run(eng.send_feedback(Feedback(
        request=SeldonMessage.from_ndarray(np.ones((1, 2), np.float32)),
        reward=1.0)))
    assert res.status is not None and res.status.reason == "CHAOS_INJECTED"


def _ensemble(a, b):
    return GraphEngine(
        {"name": "ens", "type": "COMBINER",
         "implementation": "AVERAGE_COMBINER",
         "children": [{"name": "a", "type": "MODEL"},
                      {"name": "b", "type": "MODEL"}]},
        resolver=lambda u: {"a": a, "b": b}.get(u.name))


def test_one_flaky_branch_fails_graph_with_status():
    out = run_predict(_ensemble(
        ComponentHandle(Identity(), name="a"),
        ChaosWrapper(ComponentHandle(Identity(), name="b"),
                     ChaosPolicy(error_rate=1.0, seed=0))))
    assert out.status is not None and out.status.reason == "CHAOS_INJECTED"


def test_fanout_latency_governed_by_slowest_branch():
    eng = _ensemble(
        ChaosWrapper(ComponentHandle(Identity(), name="a"),
                     ChaosPolicy(latency_ms=300.0, seed=0)),
        ChaosWrapper(ComponentHandle(Identity(), name="b"),
                     ChaosPolicy(latency_ms=300.0, seed=1)))
    t0 = time.perf_counter()
    out = run_predict(eng)
    dt = time.perf_counter() - t0
    assert out.status is None or out.status.status == "SUCCESS"
    assert 0.25 <= dt < 0.45, dt


def test_drill_span_event_and_attribute():
    from seldon_core_tpu_torch.utils.tracing import Tracer

    tracer = Tracer(enabled=True)
    w = wrap(ChaosPolicy(latency_ms=1.0, seed=0, drill_id="d7"))
    eng = GraphEngine({"name": "m", "type": "MODEL"},
                      resolver=lambda u: w, tracer=tracer)
    out = run_predict(eng)
    tree = tracer.get(out.meta.puid).to_dict()

    def spans(sp):
        yield sp
        for c in sp.get("children", []):
            yield from spans(c)

    events = [e for sp in spans(tree) for e in sp.get("events", [])
              if e.get("name") == "chaos"]
    assert events and events[0]["attributes"]["drill_id"] == "d7"
    assert any(sp.get("attributes", {}).get("drill-id") == "d7"
               for sp in spans(tree))
