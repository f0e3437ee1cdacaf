"""The port's QoS plane against the reference's on the CPU.

The cases of the reference's own ``tests/test_qos.py`` (context, admission,
breaker, deadline batcher, engine), each run through the reference's
objects and the port's on the same sequence of requests, latencies and
outcomes: every decision must be EQUAL (admitted or shed, limits and shed
levels after each step, breaker states, the EDF order of a batch, budget
rejects, status codes, reasons, tags and request paths).  Then the port's
wiring the reference also has: the runner's annotations, breakers around
REST and gRPC remote nodes, and the REST tier binding the QoS headers
(429 with ``Retry-After: 1``, 504 before any model work), held to the
reference's aiohttp tier on the same graph.
"""

import asyncio
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu import qos as jq
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import Meta as JMeta
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import resolve_component as jresolve
from seldon_core_tpu.qos import admission as jadm
from seldon_core_tpu.qos import breaker as jbrk
from seldon_core_tpu.qos import context as jctx
from seldon_core_tpu.runtime import batcher as jbatcher
from seldon_core_tpu.runtime.component import (
    SeldonComponentError as JComponentError,
)
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import qos as tq
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import Meta as TMeta
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import LocalDeployment, qos_config
from seldon_core_tpu_torch.operator.local import resolve_component as tresolve
from seldon_core_tpu_torch.operator.local import serve
from seldon_core_tpu_torch.qos import admission as tadm
from seldon_core_tpu_torch.qos import breaker as tbrk
from seldon_core_tpu_torch.qos import context as tctx
from seldon_core_tpu_torch.runtime import batcher as tbatcher
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

NO_BATCH = {"seldon.io/batching": "false"}
X = np.zeros((1, 784), np.float32)
TIMEOUT = 120


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


#: the two stacks: (name, qos package, context, admission, breaker,
#: batcher, message class, meta class, component error)
SIDES = {
    "ref": (jq, jctx, jadm, jbrk, jbatcher, JMessage, JMeta, JComponentError),
    "port": (tq, tctx, tadm, tbrk, tbatcher, TMessage, TMeta,
             SeldonComponentError),
}


def both(fn):
    """``fn(side)`` for the reference and the port; the two results."""
    return fn(*SIDES["ref"]), fn(*SIDES["port"])


# ---- context -------------------------------------------------------------


class TestContext:
    def test_headers_roundtrip_and_budget_shrinks(self):
        def case(q, ctx, *_):
            c = q.qos_from_headers({"X-Seldon-Priority": "HIGH",
                                    "X-Seldon-Deadline-Ms": "250"})
            assert 0 < c.deadline.remaining_ms() <= 250
            time.sleep(0.02)
            hop = ctx.forward_headers(c)
            return c.priority, float(hop["X-Seldon-Deadline-Ms"]) < 250, \
                sorted(hop)

        ref, port = both(case)
        assert port == ref == ("high", True, ["X-Seldon-Deadline-Ms",
                                               "X-Seldon-Priority"])

    def test_meta_tags_roundtrip_across_the_two_stacks(self):
        def stamp(q, ctx, adm, brk, bat, M, Meta, E):
            meta = Meta()
            q.stamp_meta(meta, q.QosContext(
                priority="low", deadline=q.Deadline.after_ms(100)))
            return meta

        jm, tm = both(stamp)
        assert sorted(jm.tags) == sorted(tm.tags) == ["deadline-ms",
                                                       "priority"]
        # each stack reads the other's stamp: the tags are the wire channel
        for q, meta in ((jq, tm), (tq, jm)):
            c = q.qos_from_meta(meta)
            assert c.priority == "low"
            assert 0 < c.deadline.remaining_ms() <= 100

    def test_absent_channels_and_unknown_priority(self):
        def case(q, ctx, adm, brk, bat, M, Meta, E):
            return (q.qos_from_headers({}), q.qos_from_meta(Meta()),
                    q.qos_from_headers({"X-Seldon-Priority": "urgent!!"})
                    .priority,
                    q.qos_from_headers({"X-Seldon-Deadline-Ms": "-5"})
                    .deadline.expired,
                    q.qos_from_headers({"X-Seldon-Deadline-Ms": "abc"})
                    .deadline)

        ref, port = both(case)
        assert port == ref == (None, None, "normal", True, None)

    def test_lower_case_header_keys(self):
        # the port's HTTP server lower-cases header names
        c = tq.qos_from_headers({"x-seldon-priority": "low",
                                 "x-seldon-deadline-ms": "50"})
        assert c.priority == "low" and 0 < c.deadline.remaining_ms() <= 50

    def test_scope_binds_and_restores(self):
        def case(q, ctx, *_):
            seen = [ctx.current_qos()]
            with q.qos_scope(q.QosContext(priority="high")):
                seen.append(ctx.current_qos().priority)
                with q.qos_scope(None):
                    seen.append(ctx.current_qos().priority)
            seen.append(ctx.current_qos())
            return seen

        ref, port = both(case)
        assert port == ref == [None, "high", "high", None]


# ---- admission -----------------------------------------------------------


class TestAdmission:
    def test_priority_shed_order_low_first(self):
        plan = ["high"] * 5 + ["low", "normal"] + ["high"] * 3 + \
            ["normal", "high", "high"]

        def case(q, ctx, adm, *_):
            a = adm.AdmissionController(adm.AdmissionConfig(
                target_p95_ms=50, min_limit=10, initial_limit=10))
            return [(a.try_acquire(p), a.shed_level) for p in plan]

        ref, port = both(case)
        assert port == ref
        assert [ok for ok, _ in port] == [True] * 5 + [False, True] + \
            [True] * 3 + [False, True, False]
        assert port[-1][1] == 3

    def test_aimd_on_a_seeded_sequence(self):
        rng = np.random.default_rng(3)
        steps = [(rng.choice(["low", "normal", "high"]),
                  float(rng.choice([0.001, 0.005, 0.030, 0.080])),
                  bool(rng.random() < 0.9), bool(rng.random() < 0.6))
                 for _ in range(600)]

        def case(q, ctx, adm, *_):
            a = adm.AdmissionController(adm.AdmissionConfig(
                target_p95_ms=20, initial_limit=16, window=8, min_limit=2))
            held, trace = 0, []
            for pri, lat, ok, acquire in steps:
                if acquire or held == 0:
                    got = a.try_acquire(pri)
                    held += got
                    trace.append(("acq", got))
                else:
                    a.release(lat, ok)
                    held -= 1
                trace.append((a.limit, a.inflight, a.shed_level))
            return trace, a.snapshot()

        ref, port = both(case)
        assert port == ref
        limits = {t[0] for t in port[0] if len(t) == 3}
        assert len(limits) > 3  # the limit really moved both ways

    def test_aimd_decrease_then_increase(self):
        def case(q, ctx, adm, *_):
            a = adm.AdmissionController(adm.AdmissionConfig(
                target_p95_ms=10, initial_limit=64, window=8))
            for _ in range(8):
                a.try_acquire("high")
                a.release(0.050)
            shrunk = a.limit
            for _ in range(16):
                a.try_acquire("high")
                a.release(0.001)
            return shrunk, a.limit

        ref, port = both(case)
        assert port == ref and port[0] < 64 < port[1] + 64 and \
            port[1] > port[0]

    def test_failures_release_but_do_not_feed_aimd(self):
        def case(q, ctx, adm, *_):
            a = adm.AdmissionController(adm.AdmissionConfig(
                target_p95_ms=10, initial_limit=16, window=4))
            for _ in range(8):
                a.try_acquire("high")
                a.release(0.0001, ok=False)
            return a.limit, a.inflight

        ref, port = both(case)
        assert port == ref == (16, 0)

    def test_snapshot_and_metrics(self):
        def case(q, ctx, adm, brk, bat, M, Meta, E):
            reg = (JRegistry if q is jq else TRegistry)()
            a = adm.AdmissionController(adm.AdmissionConfig(
                target_p95_ms=50, min_limit=1, initial_limit=1),
                name="dep", metrics=reg)
            out = (a.try_acquire("high"), a.try_acquire("low"),
                   a.snapshot(), a.retry_after_s())
            lines = sorted(ln for ln in reg.render().splitlines()
                           if ln.startswith("seldon_qos"))
            return out, lines

        ref, port = both(case)
        assert port == ref
        assert 'seldon_qos_admitted_total{deployment="dep",priority="high"}' \
            ' 1' in port[1] or any(ln.startswith(
                'seldon_qos_admitted_total{deployment="dep",priority="high"}')
                for ln in port[1])


# ---- circuit breaker -----------------------------------------------------


class TestBreaker:
    def test_error_rate_trips_and_open_blocks(self):
        def case(q, ctx, adm, brk, *_):
            b = brk.CircuitBreaker(brk.BreakerConfig(
                min_calls=4, error_threshold=0.5, open_s=30.0))
            states = []
            for ok in (True, False, False, True, False):
                b.record(ok=ok)
                states.append(b.state)
            return states, b.allow(), b.short_circuits

        ref, port = both(case)
        assert port == ref
        assert port[0][-1] == "open" and port[1:] == (False, 1)

    def test_volume_floor_and_latency_ejection(self):
        def case(q, ctx, adm, brk, *_):
            floor = brk.CircuitBreaker(brk.BreakerConfig(min_calls=10))
            for _ in range(9):
                floor.record(ok=False)
            slow = brk.CircuitBreaker(brk.BreakerConfig(
                min_calls=4, slow_ms=10.0, slow_threshold=0.75, open_s=30.0))
            states = []
            for lat in (0.05, 0.001, 0.05, 0.05, 0.05):
                slow.record(ok=True, latency_s=lat)
                states.append(slow.state)
            return floor.state, states

        ref, port = both(case)
        assert port == ref
        assert port[0] == "closed" and port[1][-1] == "open"

    def test_half_open_probes_close_or_reopen(self):
        def make(brk):
            b = brk.CircuitBreaker(brk.BreakerConfig(min_calls=2, open_s=0.05,
                                                     probes=2))
            b.record(ok=False)
            b.record(ok=False)
            return b

        jb, tb = make(jbrk), make(tbrk)
        jb2, tb2 = make(jbrk), make(tbrk)
        trace = {"ref": [], "port": []}
        for b, key in ((jb, "ref"), (tb, "port")):
            trace[key].append(b.state)
        time.sleep(0.08)
        for b, b2, key in ((jb, jb2, "ref"), (tb, tb2, "port")):
            t = trace[key]
            t += [b.state, b.allow(), b.allow(), b.allow()]
            b.record(ok=True)
            t.append(b.state)
            b.record(ok=True)
            t.append(b.state)
            t += [b2.allow()]
            b2.record(ok=False)
            t += [b2.state, b2.snapshot()["shortCircuits"]]
        assert trace["port"] == trace["ref"] == [
            "open", "half_open", True, True, False, "half_open", "closed",
            True, "open", 0]

    def test_wrapper_4xx_never_trips_5xx_does(self):
        def case(q, ctx, adm, brk, bat, M, Meta, E):
            class Flaky:
                code = 400

                async def predict(self, msg):
                    raise E("nope", self.code)

            flaky = Flaky()
            cfg = dict(min_calls=3, error_threshold=0.5, open_s=30.0)
            w4 = brk.BreakerWrapper(flaky, brk.CircuitBreaker(
                brk.BreakerConfig(**cfg)), name="c")
            w5 = brk.BreakerWrapper(flaky, brk.CircuitBreaker(
                brk.BreakerConfig(**cfg)), name="c2")

            async def hammer(w, n):
                codes = []
                for _ in range(n):
                    try:
                        await w.predict(M())
                    except E as e:
                        codes.append((e.status_code, e.reason))
                return codes

            a = run(hammer(w4, 6))
            flaky.code = 503
            b = run(hammer(w5, 4))
            return a, w4.breaker.state, b, w5.breaker.state, w5.has("predict")

        ref, port = both(case)
        assert port == ref
        assert port[1] == "closed" and port[3] == "open"
        assert port[2][-1] == (503, "CIRCUIT_OPEN")


# ---- batcher: EDF and the budget reject ----------------------------------


class TestDeadlineBatcher:
    def _batch_fn(self, bat, seen):
        def fn(batch):
            seen.append([float(v) for v in np.asarray(batch)[:, 0]])
            return (batch, None) if bat is tbatcher else batch

        return fn

    def test_edf_orders_pending_by_deadline(self):
        def case(q, ctx, adm, brk, bat, *_):
            batches = []
            b = bat.DynamicBatcher(self._batch_fn(bat, batches),
                                   bat.BatcherConfig(max_batch_size=8,
                                                     max_delay_ms=10.0))

            async def submit(tag, budget_ms):
                c = (q.QosContext(deadline=q.Deadline.after_ms(budget_ms))
                     if budget_ms else None)
                with q.qos_scope(c):
                    out = await b(np.full((1, 2), tag, np.float32))
                out = out[0] if bat is tbatcher else out
                return tag, float(out[0, 0])

            async def storm():
                return await asyncio.gather(
                    submit(9.0, 0), submit(1.0, 10_000), submit(2.0, 5_000),
                    submit(3.0, 50), submit(4.0, 0), submit(5.0, 50))

            outs = run(storm())
            return outs, batches

        ref, port = both(case)
        assert port == ref
        outs, batches = port
        assert all(tag == val for tag, val in outs)
        assert batches == [[3.0, 5.0, 2.0, 1.0, 9.0, 4.0, 0.0, 0.0]]

    def test_budget_reject_at_dequeue(self):
        def case(q, ctx, adm, brk, bat, *_):
            reg = (JRegistry if q is jq else TRegistry)()
            seen = []
            b = bat.DynamicBatcher(self._batch_fn(bat, seen),
                                   bat.BatcherConfig(name="t",
                                                     max_batch_size=8,
                                                     max_delay_ms=1.0),
                                   metrics=reg)
            b.latency_ewma_s = 0.050  # batches take 50 ms

            async def call(budget_ms, tag):
                with q.qos_scope(q.QosContext(
                        deadline=q.Deadline.after_ms(budget_ms))):
                    try:
                        await b(np.full((1, 2), tag, np.float32))
                        return "ok"
                    except bat.DeadlineExceededError as e:
                        return f"{e.status_code} {e.reason}"

            async def mix():
                return await asyncio.gather(call(5, 1.0), call(5000, 2.0),
                                            call(20, 3.0))

            outs = run(mix())
            shed = [ln for ln in reg.render().splitlines()
                    if ln.startswith("seldon_batcher_shed_total")]
            return outs, seen, shed

        ref, port = both(case)
        assert port == ref
        outs, seen, shed = port
        assert outs == ["504 DEADLINE_EXCEEDED", "ok", "504 DEADLINE_EXCEEDED"]
        assert seen == [[2.0]]
        assert shed == ['seldon_batcher_shed_total{batcher="t",'
                        'reason="budget"} 2.0'] or \
            all('reason="budget"' in ln for ln in shed)

    def test_batcher_series_equal_the_references(self):
        def case(q, ctx, adm, brk, bat, *_):
            reg = (JRegistry if q is jq else TRegistry)()
            b = bat.DynamicBatcher(self._batch_fn(bat, []),
                                   bat.BatcherConfig(name="s", max_batch_size=8,
                                                     max_delay_ms=1.0,
                                                     max_queue_rows=6),
                                   metrics=reg)

            async def calls():
                await asyncio.gather(b(np.zeros((3, 2), np.float32)),
                                     b(np.zeros((2, 2), np.float32)))
                await b(np.zeros((1, 2), np.float32))
                try:
                    await b(np.zeros((7, 2), np.float32))
                except bat.QueueFullError:
                    pass

            run(calls())
            return sorted(ln for ln in reg.render().splitlines()
                          if ln.startswith("seldon_batcher"))

        ref, port = both(case)
        assert port == ref
        assert any("seldon_batcher_pad_rows_total" in ln for ln in port)
        assert any('reason="queue_full"' in ln for ln in port)

    def test_budget_shed_is_counted_by_reason(self):
        b = tbatcher.DynamicBatcher(lambda x: (x, None),
                                    tbatcher.BatcherConfig(max_batch_size=4,
                                                           max_delay_ms=1.0))
        b.latency_ewma_s = 1.0

        async def doomed():
            with tq.qos_scope(tq.QosContext(
                    deadline=tq.Deadline.after_ms(10))):
                with pytest.raises(tbatcher.DeadlineExceededError):
                    await b(np.zeros((1, 3), np.float32))

        run(doomed())
        assert b.stats["shed"] == 1
        assert b.shed_reasons == {"queue_full": 0, "deadline": 0, "budget": 1}

    def test_no_deadline_no_shedding_and_the_ewma(self):
        def case(q, ctx, adm, brk, bat, *_):
            b = bat.DynamicBatcher(self._batch_fn(bat, []),
                                   bat.BatcherConfig(max_batch_size=4,
                                                     max_delay_ms=1.0))
            b.latency_ewma_s = 10.0  # huge, but no deadline anywhere
            out = run(b(np.zeros((2, 3), np.float32)))
            out = out[0] if bat is tbatcher else out
            fresh = bat.DynamicBatcher(self._batch_fn(bat, []))
            ewma = []
            for s in (1.0, 2.0, 0.5):
                fresh._note_latency(s)
                ewma.append(fresh.latency_ewma_s)
            return out.shape, ewma

        ref, port = both(case)
        assert port == ref and port[0] == (2, 3)
        assert port[1] == pytest.approx([1.0, 1.2, 1.06])


# ---- engine: budget, admission, walk deadline, degraded mode -------------


def mlp_node(name, side, seed=0, hidden=16):
    mod = "seldon_core_tpu" if side == "ref" else "seldon_core_tpu_torch"
    return {"name": name, "type": "MODEL", "parameters": [
        {"name": "model_class", "value": f"{mod}.models.mlp:MNISTMLP",
         "type": "STRING"},
        {"name": "seed", "value": str(seed), "type": "INT"},
        {"name": "hidden", "value": str(hidden), "type": "INT"}]}


def qos_engine(side, spec, qos, ann=NO_BATCH, **kw):
    if side == "ref":
        return JEngine(spec, resolver=lambda u: jresolve(u, ann, qos=qos),
                       name="p", qos=qos, **kw)
    return TEngine(spec, resolver=lambda u: tresolve(u, ann, "cpu", qos=qos),
                   name="p", qos=qos, **kw)


def pinned(side):
    msg = (JMessage if side == "ref" else TMessage).from_ndarray(X)
    msg.meta.puid = "qos-pinned"
    return msg


def _status(out):
    return (None if out.status is None else
            (out.status.status, out.status.code, out.status.reason))


class TestEngineQos:
    def test_admission_shed_is_429_with_reason(self):
        outs = {}
        for side, q in (("ref", jq), ("port", tq)):
            qos = q.EngineQos(q.QosConfig(name="p", slo_p95_ms=50))
            qos.admission.limit = 0
            qos.admission.config.min_limit = 0
            out = run(qos_engine(side, mlp_node("m", side), qos)
                      .predict(pinned(side)))
            outs[side] = (_status(out), out.status.info, out.meta.puid)
        assert outs["port"] == outs["ref"]
        assert outs["port"][0] == ("FAILURE", 429, "ADMISSION_SHED")
        assert "retry after" in outs["port"][1]

    def test_expired_budget_504s_before_any_model_work(self):
        outs = {}
        for side, q in (("ref", jq), ("port", tq)):
            eng = qos_engine(side, mlp_node("m", side), None)
            calls = []
            orig = eng._walk

            async def spy(*a, _orig=orig, **kw):
                calls.append(1)
                return await _orig(*a, **kw)

            eng._walk = spy
            c = q.QosContext(deadline=q.Deadline(time.monotonic() - 1.0))
            with q.qos_scope(c):
                out = run(eng.predict(pinned(side)))
            outs[side] = (_status(out), out.status.info, len(calls))
        assert outs["port"] == outs["ref"]
        assert outs["port"][0] == ("FAILURE", 504, "DEADLINE_EXCEEDED")
        assert outs["port"][2] == 0

    def test_deadline_bounds_walk_via_meta_tag(self):
        class Slow:
            def has(self, m):
                return m == "predict"

            async def predict(self, msg):
                await asyncio.sleep(5.0)
                return msg

        outs = {}
        for side, q, E in (("ref", jq, JEngine), ("port", tq, TEngine)):
            eng = E({"name": "slow", "type": "MODEL"},
                    resolver=lambda u: Slow(), name="p")
            msg = pinned(side)
            q.stamp_meta(msg.meta, q.QosContext(
                deadline=q.Deadline.after_ms(80)))
            t0 = time.perf_counter()
            out = run(eng.predict(msg))
            assert time.perf_counter() - t0 < 2.0
            outs[side] = (_status(out), sorted(out.meta.tags))
        assert outs["port"] == outs["ref"]
        assert outs["port"][0] == ("FAILURE", 504, "DEADLINE_EXCEEDED")

    def test_walk_timeout_alone(self):
        class Slow:
            def has(self, m):
                return m == "predict"

            async def predict(self, msg):
                await asyncio.sleep(5.0)
                return msg

        outs = {}
        for side, E in (("ref", JEngine), ("port", TEngine)):
            eng = E({"name": "slow", "type": "MODEL"},
                    resolver=lambda u: Slow(), name="p", walk_timeout_s=0.05)
            out = run(eng.predict(pinned(side)))
            outs[side] = (_status(out), out.status.info)
        assert outs["port"] == outs["ref"]
        assert "0.050s" in outs["port"][1]

    def test_degrade_on_shed_level(self):
        outs = {}
        for side, q in (("ref", jq), ("port", tq)):
            spec = {**mlp_node("big", side), "children": [
                mlp_node("cheap", side, seed=1)]}
            qos = q.EngineQos(q.QosConfig(name="p", slo_p95_ms=50,
                                          fallback_node="cheap",
                                          degrade_shed_level=1))
            eng = qos_engine(side, spec, qos)
            held = 0
            while qos.admission.shed_level < 1:
                assert qos.admission.try_acquire("high")
                held += 1
            out = run(eng.predict(pinned(side)))
            for _ in range(held):
                qos.admission.release(0.001)
            outs[side] = (held, _status(out), out.meta.tags.get("degraded"),
                          list(out.meta.request_path), qos.snapshot())
        assert outs["port"] == outs["ref"]
        assert outs["port"][2] == "shed_level"
        assert outs["port"][3] == ["cheap"]

    @pytest.mark.parametrize("fallback,code", [("ghost", "GL802"),
                                               ("m", "GL803")])
    def test_bad_fallback_raises_at_construction(self, fallback, code):
        for side, q in (("ref", jq), ("port", tq)):
            qos = q.EngineQos(q.QosConfig(name="p", fallback_node=fallback))
            with pytest.raises(ValueError, match=code):
                qos_engine(side, mlp_node("m", side), qos)

    def test_breaker_open_routes_to_fallback_with_degraded_tag(self):
        outs = {}
        for side, q in (("ref", jq), ("port", tq)):
            spec = {"name": "big", "type": "MODEL",
                    "endpoint": {"service_host": "127.0.0.1",
                                 "service_port": 1, "type": "REST"},
                    "children": [mlp_node("cheap", side)]}
            qos = q.EngineQos(q.QosConfig(
                name="p", fallback_node="cheap",
                breaker=(jbrk if side == "ref" else tbrk).BreakerConfig(
                    min_calls=2, error_threshold=0.5, open_s=30.0)))
            eng = qos_engine(side, spec, qos)

            async def drive(eng=eng):
                try:
                    first = [_status(await eng.predict(pinned(side)))
                             for _ in range(2)]
                    return first, await eng.predict(pinned(side))
                finally:
                    await eng.node_impl("big").inner.close()

            first, out = run(drive())
            outs[side] = (first, qos.breakers[0].state, _status(out),
                          out.meta.tags["degraded"],
                          list(out.meta.request_path), qos.snapshot())
        assert outs["port"] == outs["ref"]
        assert outs["port"][0] == [("FAILURE", 503, "TRANSPORT")] * 2
        assert outs["port"][1] == "open"
        assert outs["port"][3] == "breaker_open"
        assert outs["port"][4] == ["cheap"]


# ---- the port's runner and REST tier -------------------------------------


def _dep(ann, graph):
    return {"spec": {"name": "qdep", "annotations": ann,
                     "predictors": [{"name": "main", "graph": graph}]}}


def test_annotations_parse_as_the_references():
    from seldon_core_tpu_torch.graph.spec import load_deployment

    cases = [
        {},
        {"seldon.io/slo-p95-ms": "120"},
        {"seldon.io/qos-breaker": "true", "seldon.io/qos-breaker-min-calls":
         "3", "seldon.io/qos-breaker-open-ms": "250",
         "seldon.io/qos-breaker-slow-ms": "40"},
        {"seldon.io/qos-fallback": "cheap",
         "seldon.io/qos-degrade-shed-level": "1",
         "seldon.io/qos-breaker": "false"},
    ]
    for ann in cases:
        j, t = (q.qos_from_annotations(ann, "d/p") for q in (jq, tq))
        assert (j is None) == (t is None)
        if t is not None:
            assert vars(t.breaker) == vars(j.breaker)
            assert (t.name, t.slo_p95_ms, t.fallback_node,
                    t.degrade_shed_level, t.breakers_enabled) == \
                (j.name, j.slo_p95_ms, j.fallback_node, j.degrade_shed_level,
                 j.breakers_enabled)
    for bad in ({"seldon.io/slo-p95-ms": "0"},
                {"seldon.io/qos-breaker": "maybe"},
                {"seldon.io/qos-degrade-shed-level": "4",
                 "seldon.io/slo-p95-ms": "5"},
                {"seldon.io/qos-breaker-min-calls": "0",
                 "seldon.io/qos-breaker": "1"},
                {"seldon.io/slo-p95-ms": "fast"}):
        for q in (jq, tq):
            with pytest.raises(ValueError):
                q.qos_from_annotations(bad, "d/p")
    graph = {**mlp_node("big", "port"), "children": [mlp_node("cheap",
                                                               "port")]}
    for fallback, msg in (("ghost", "not in"), ("big", "graph root")):
        dep = load_deployment(_dep({"seldon.io/qos-fallback": fallback},
                                   graph))
        with pytest.raises(ValueError, match=msg):
            qos_config(dep)


@pytest.mark.parametrize("kind", ["REST", "GRPC"])
def test_runner_puts_breakers_around_remote_nodes(kind):
    from seldon_core_tpu_torch.graph.spec import load_deployment

    graph = {"name": "big", "type": "MODEL",
             "endpoint": {"service_host": "127.0.0.1", "service_port": 1,
                          "type": kind},
             "children": [mlp_node("cheap", "port")]}
    ann = {**NO_BATCH, "seldon.io/qos-fallback": "cheap",
           "seldon.io/qos-breaker-min-calls": "2"}

    async def drive():
        local = LocalDeployment(load_deployment(_dep(ann, graph)),
                                device="cpu")
        impl = local.engine.node_impl("big")
        try:
            assert isinstance(impl, tbrk.BreakerWrapper)
            firsts = [_status(await local.predict(pinned("port")))
                      for _ in range(2)]
            out = await local.predict(pinned("port"))
            return firsts, out, local
        finally:
            await impl.inner.close()

    firsts, out, local = run(drive())
    assert [f[1] for f in firsts] == [503, 503]
    assert out.meta.tags["degraded"] == "breaker_open"
    assert list(out.meta.request_path) == ["cheap"]
    assert tq.snapshot("qdep")["openBreakers"] == ["big"]
    assert 'seldon_qos_breaker_state{component="big"} 2' in \
        local.metrics.render() or \
        'seldon_qos_breaker_state{component="big"} 2.0' in \
        local.metrics.render()


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


async def test_rest_tier_binds_the_qos_headers_as_the_reference():
    """The same graph and QoS behind the reference's aiohttp tier and the
    port's REST tier: a full admission gate answers 429 with Retry-After,
    an expired budget 504 before any model work, a low-priority request
    past its share of the limit 429, and with room every answer 200."""
    graph = {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}
    jqos = jq.EngineQos(jq.QosConfig(name="p", slo_p95_ms=50))
    jeng = JEngine(graph, name="p", qos=jqos)
    jrunner = await start_server(build_app(engine=jeng), "127.0.0.1", 0)
    tserver, local = await serve(_dep({"seldon.io/slo-p95-ms": "50"}, graph),
                                 port=0, host="127.0.0.1", device="cpu")
    ports = {"ref": jrunner.addresses[0][1], "port": tserver.port}
    qoss = {"ref": jqos, "port": local.qos}
    body = {"data": {"ndarray": [[1.0, 2.0]]}}
    cases = [({}, None), ({"X-Seldon-Deadline-Ms": "0"}, None),
             ({"X-Seldon-Priority": "high", "X-Seldon-Deadline-Ms": "5000"},
              None),
             ({"X-Seldon-Priority": "low"}, "half"),
             ({"X-Seldon-Priority": "high"}, "half"),
             ({"X-Seldon-Priority": "high"}, "full")]
    try:
        got = {}
        for side in ("ref", "port"):
            adm = qoss[side].admission
            rows = []
            for headers, fill in cases:
                adm.inflight = {None: 0, "half": adm.limit // 2,
                                "full": adm.limit}[fill]
                code, hdrs, out = await asyncio.to_thread(
                    _post, ports[side], body, headers)
                rows.append((code, hdrs.get("Retry-After"),
                             out["status"]["reason"],
                             out.get("data", {}).get("ndarray")))
            adm.inflight = 0
            got[side] = rows
        assert got["port"] == got["ref"]
        codes = [r[:3] for r in got["port"]]
        assert codes == [(200, None, ""), (504, None, "DEADLINE_EXCEEDED"),
                         (200, None, ""), (429, "1", "ADMISSION_SHED"),
                         (200, None, ""), (429, "1", "ADMISSION_SHED")]
    finally:
        await tserver.stop()
        await jrunner.cleanup()
