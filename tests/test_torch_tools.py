"""The port's tools (``seldon_core_tpu_torch/tools/``) against the
reference's, over the port's own servers on the CPU.

Contract draws and requests are EQUAL under one ``np.random.Generator``
seed.  Each package's testers, load drivers, overload drill and CLI run
against the same port servers (REST, gRPC, framed, the gateway's OAuth
dance) over real sockets, the port's on its own clients and the
reference's on aiohttp and grpc.aio: the testers' reports and the CLI's
deterministic output are EQUAL, the load reports agree on their keys,
and the drills offer the seed's arrivals and shed in the same order.
Replay verdicts and the viewers' text are EQUAL to the reference's for
the same bodies, taken from the port's ``/trace``, ``/admin/profile``,
``/admin/flightrecorder`` and ``/admin/fleet*``.
"""

import asyncio
import glob
import json
import os
import threading

import numpy as np
import pytest

from seldon_core_tpu.tools import contract as rcontract
from seldon_core_tpu.tools import tester as rtester
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.serving.client import HttpSession
from seldon_core_tpu_torch.serving.rest import RestServer
from seldon_core_tpu_torch.tools import contract as pcontract
from seldon_core_tpu_torch.tools.loadtest import (
    GrpcDriver,
    RestDriver,
    SseStreamDriver,
    overload_drill,
    run_load,
    run_load_sync,
    run_open_loop,
)
from seldon_core_tpu_torch.tools.tester import test_api as run_api_test
from seldon_core_tpu_torch.tools.tester import (
    test_component as run_component_test,
)

REPO = os.path.join(os.path.dirname(__file__), "..")

CONTRACT = {
    "features": [
        {"name": "x", "ftype": "continuous", "dtype": "FLOAT",
         "range": [0, 1], "shape": [2]},
        {"name": "age", "ftype": "continuous", "dtype": "INT",
         "range": [18, 65]},
        {"name": "r", "ftype": "continuous", "dtype": "FLOAT", "repeat": 2},
        {"name": "u", "ftype": "continuous"},
        {"name": "lo", "ftype": "continuous", "range": [3, "inf"]},
        {"name": "hi", "ftype": "continuous", "dtype": "INT",
         "range": ["inf", -1]},
        {"name": "c", "ftype": "categorical", "values": [0, 5, 9]},
    ],
    "targets": [{"name": "proba", "ftype": "continuous", "dtype": "FLOAT",
                 "range": [0, 1], "shape": [5]}],
}
CONTRACTS = [("inline", CONTRACT)] + [
    (os.path.basename(p), json.load(open(p)))
    for p in sorted(glob.glob(os.path.join(REPO, "examples", "contracts",
                                           "*.json")))]


class EchoWidth:
    """Answers (n, 5), the width of CONTRACT's targets."""

    def predict(self, X, names=None):
        return np.ones((np.asarray(X).shape[0], 5), dtype=np.float64) * 0.2

    def send_feedback(self, X, names, reward, truth):
        return None


# -- contract --------------------------------------------------------------

@pytest.mark.parametrize("name,doc", CONTRACTS, ids=[n for n, _ in CONTRACTS])
def test_contract_draws_equal_the_reference(name, doc):
    r, p = rcontract.Contract.from_dict(doc), pcontract.Contract.from_dict(doc)
    assert p.feature_names() == r.feature_names()
    assert p.target_names() == r.target_names()
    for tensor in (True, False):
        rr, pp = np.random.default_rng(7), np.random.default_rng(7)
        for n in (1, 3):
            assert p.rest_request(n, tensor=tensor, rng=pp) == \
                r.rest_request(n, tensor=tensor, rng=rr)
    if r.targets:
        assert p.feedback_request(2, reward=0.5,
                                  rng=np.random.default_rng(3)) == \
            r.feedback_request(2, reward=0.5, rng=np.random.default_rng(3))
    if name == "inline":
        assert p.proto_request(2, rng=np.random.default_rng(1)) \
            .SerializeToString() == r.proto_request(
                2, rng=np.random.default_rng(1)).SerializeToString()


@pytest.mark.parametrize("response", [
    {"data": {"ndarray": [[0.1] * 5]}},
    {"data": {"ndarray": [[0.1] * 3]}},
    {"data": {"tensor": {"shape": [1, 5], "values": [0.0] * 5}}},
    {"data": {"tensor": {"shape": [2, 5], "values": [0.0]}}},
    {"data": {"binTensor": {"shape": [1], "dtype": "uint8", "b64": "AA=="}}},
    {"data": {"names": []}},
    {"jsonData": {"a": 1}},
    {"status": {"status": "FAILURE", "info": "boom"}},
])
def test_validate_response_equals_the_reference(response):
    for doc in (CONTRACT, {**CONTRACT, "response_type": "json"}):
        assert pcontract.validate_response(
            pcontract.Contract.from_dict(doc), response) == \
            rcontract.validate_response(rcontract.Contract.from_dict(doc),
                                        response)


# -- testers ---------------------------------------------------------------
#
# Each tester runs twice against the same port server, once from each
# package (the reference's on aiohttp, grpc.aio and its framed client),
# with the same contract, seed and counts; the two reports are EQUAL.  An
# engine's answer carries ``meta.puid``, a fresh random id per request, so
# that one key is dropped before the engines' answers are compared.

async def _rest(component=None, engine=None):
    return await RestServer(engine, host="127.0.0.1", port=0,
                            component=component).start()


def _echo():
    return ComponentHandle(EchoWidth(), name="echo", service_type="MODEL")


def _without_puid(report: dict) -> dict:
    out = json.loads(json.dumps(report))
    for r in out["responses"]:
        (r.get("meta") or {}).pop("puid", None)
    return out


async def _both_component_tests(doc, **kw):
    """``test_component`` of each package with the same arguments; the
    port's report, once held EQUAL to the reference's."""
    port = await run_component_test(pcontract.Contract.from_dict(doc), **kw)
    ref = await rtester.test_component(rcontract.Contract.from_dict(doc),
                                       **kw)
    assert port.to_dict() == ref.to_dict()
    return port


async def _both_api_tests(doc, **kw):
    """``test_api`` of each package with the same arguments (the OAuth
    dance included when a key is given); the port's report, once held
    EQUAL to the reference's less each answer's ``meta.puid``."""
    port = await run_api_test(pcontract.Contract.from_dict(doc), **kw)
    ref = await rtester.test_api(rcontract.Contract.from_dict(doc), **kw)
    assert _without_puid(port.to_dict()) == _without_puid(ref.to_dict())
    return port


class Doubler:
    """Answers twice its input, so every answer shows the draw it got."""

    def predict(self, X, names=None):
        return np.asarray(X, dtype=np.float64) * 2.0


def _doubling_engine():
    handle = ComponentHandle(Doubler(), name="m")
    return GraphEngine({"name": "m", "type": "MODEL"},
                       resolver=lambda u: handle)


def _simple_engine():
    return GraphEngine({"name": "m", "implementation": "SIMPLE_MODEL"})


API_DOC = {"features": CONTRACT["features"], "targets": []}


class TestComponentTester:
    async def test_rest_socket(self):
        srv = await _rest(component=_echo())
        try:
            report = await _both_component_tests(
                CONTRACT, port=srv.port, n_requests=3, batch_size=4, seed=0)
            assert report.ok, report.failures
            assert report.sent == 3 and len(report.responses) == 3
            fb = await _both_component_tests(
                CONTRACT, port=srv.port, endpoint="send-feedback", seed=0)
            assert fb.sent == 1
        finally:
            await srv.stop()

    async def test_rest_socket_bad_width_fails(self):
        class Wrong:
            def predict(self, X, names=None):
                return np.zeros((np.asarray(X).shape[0], 2))

        srv = await _rest(component=ComponentHandle(Wrong(), name="w"))
        try:
            # the failure strings EQUAL to the reference's
            report = await _both_component_tests(CONTRACT, port=srv.port,
                                                 n_requests=2, seed=0)
            assert not report.ok and len(report.failures) == 2
        finally:
            await srv.stop()

    async def test_grpc_socket(self):
        from seldon_core_tpu_torch.serving.grpc_api import (
            GrpcServer,
            component_service_handlers,
        )

        server = GrpcServer(component_service_handlers(_echo(), "MODEL"),
                            port=0, host="127.0.0.1")
        port = await server.start()
        try:
            report = await _both_component_tests(
                CONTRACT, port=port, transport="grpc", n_requests=2,
                batch_size=3, seed=0)
            assert report.ok, report.failures
            fb = await _both_component_tests(
                CONTRACT, port=port, transport="grpc",
                endpoint="send-feedback", seed=1)
            assert fb.ok, fb.failures
        finally:
            await server.stop()

    async def test_framed_socket(self):
        from seldon_core_tpu_torch.serving.framed import FramedComponentServer

        with FramedComponentServer(_echo()) as srv:
            report = await _both_component_tests(
                CONTRACT, port=srv.port, transport="framed", n_requests=2,
                seed=0)
            assert report.ok, report.failures
            fb = await _both_component_tests(
                CONTRACT, port=srv.port, transport="framed",
                endpoint="send-feedback", seed=1)
            assert fb.ok, fb.failures


class TestApiTester:
    async def test_engine_rest_and_grpc(self):
        from seldon_core_tpu_torch.serving.grpc_api import (
            GrpcServer,
            seldon_service_handler,
        )

        eng = _doubling_engine()
        srv = await _rest(engine=eng)
        gsrv = GrpcServer([seldon_service_handler(eng)], port=0,
                          host="127.0.0.1")
        gport = await gsrv.start()
        try:
            report = await _both_api_tests(
                API_DOC, base_url=f"http://127.0.0.1:{srv.port}",
                n_requests=2, batch_size=2, seed=0)
            assert report.ok, report.failures
            over_grpc = await _both_api_tests(
                API_DOC, base_url="", grpc_target=f"127.0.0.1:{gport}",
                n_requests=2, batch_size=2, seed=0)
            assert over_grpc.ok, over_grpc.failures
            # the same draws: the same answers over both wires
            assert [r["data"] for r in over_grpc.responses] == \
                [r["data"] for r in report.responses]
            fb = await _both_api_tests(
                CONTRACT, base_url=f"http://127.0.0.1:{srv.port}",
                endpoint="feedback", seed=0)
            assert fb.ok, fb.failures
        finally:
            await gsrv.stop()
            await srv.stop()

    async def test_gateway_oauth_dance(self):
        from seldon_core_tpu.tools.loadtest import oauth_token as r_token
        from seldon_core_tpu_torch.gateway.app import Gateway
        from seldon_core_tpu_torch.gateway.store import (
            DeploymentRecord,
            DeploymentStore,
        )
        from seldon_core_tpu_torch.tools.loadtest import oauth_token

        srv = await _rest(engine=_doubling_engine())
        store = DeploymentStore()
        store.put(DeploymentRecord(
            name="dep1", oauth_key="key1", oauth_secret="sec1",
            engine_url=f"http://127.0.0.1:{srv.port}"))
        gw = Gateway(store)
        gsrv = await gw.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{gsrv.port}"
        try:
            report = await _both_api_tests(
                API_DOC, base_url=base, oauth_key="key1",
                oauth_secret="sec1", n_requests=2, batch_size=3, seed=0)
            assert report.ok, report.failures
            refused = []
            for token in (oauth_token, r_token):
                with pytest.raises(RuntimeError,
                                   match="token endpoint HTTP 401") as e:
                    await token(base, "key1", "wrong")
                refused.append(str(e.value))
            assert refused[0] == refused[1]
        finally:
            await gw.close()
            await srv.stop()


# -- load harness ----------------------------------------------------------

class TestLoadHarness:
    """The port's drivers and loops beside the reference's (aiohttp,
    grpc.aio) against the same port servers: both clean, the same report
    keys; the timings themselves differ from run to run."""

    async def test_rest_and_grpc_closed_loop(self):
        from seldon_core_tpu.tools import loadtest as rload
        from seldon_core_tpu_torch.serving.grpc_api import (
            GrpcServer,
            seldon_service_handler,
        )

        eng = _simple_engine()
        srv = await _rest(engine=eng)
        gsrv = GrpcServer([seldon_service_handler(eng)], port=0,
                          host="127.0.0.1")
        gport = await gsrv.start()
        payload = pcontract.Contract.from_dict(CONTRACT).rest_request(
            1, rng=np.random.default_rng(0))
        base, target = f"http://127.0.0.1:{srv.port}", f"127.0.0.1:{gport}"
        try:
            for proto, drivers in (
                    ("rest", (RestDriver(base, payload, drill_id="d1"),
                              rload.RestDriver(base, payload,
                                               drill_id="d1"))),
                    ("grpc", (GrpcDriver(target, payload),
                              rload.GrpcDriver(target, payload)))):
                reports = []
                for driver, loop in zip(drivers, (run_load, rload.run_load)):
                    res = await loop(driver, seconds=0.4, concurrency=8,
                                     warmup_s=0.1, protocol=proto)
                    assert res.failures == 0 and res.requests > 10, res
                    assert len(res.latencies_ms) == res.requests
                    reports.append(res.to_dict())
                d, ref = reports
                assert _shape(d) == _shape(ref)
                assert d["protocol"] == ref["protocol"] == proto
                assert d["latency_ms"]["p99"] >= d["latency_ms"]["p50"] > 0
        finally:
            await gsrv.stop()
            await srv.stop()

    async def test_rest_driver_counts_http_errors(self):
        from seldon_core_tpu.tools import loadtest as rload

        srv = await _rest(component=_echo())
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for driver, loop in (
                    (RestDriver(base, {"x": 1}, path="/nowhere"), run_load),
                    (rload.RestDriver(base, {"x": 1}, path="/nowhere"),
                     rload.run_load)):
                res = await loop(driver, seconds=0.2, concurrency=2,
                                 warmup_s=0.0)
                assert res.requests == 0 and res.failures > 0
        finally:
            await srv.stop()

    async def test_open_loop_poisson(self):
        from seldon_core_tpu.tools import loadtest as rload

        srv = await _rest(engine=_simple_engine())
        base = f"http://127.0.0.1:{srv.port}"
        payload = pcontract.Contract.from_dict(CONTRACT).rest_request(
            1, rng=np.random.default_rng(0))
        try:
            reports = []
            for driver, loop in (
                    (RestDriver(base, payload), run_open_loop),
                    (rload.RestDriver(base, payload), rload.run_open_loop)):
                res = await loop(driver, rate=200.0, seconds=1.0,
                                 warmup_s=0.2, protocol="rest")
                d = res.to_dict()
                assert (d["mode"], d["offered_rate"], d["dropped"]) == (
                    "open-loop", 200.0, 0)
                assert res.failures == 0
                assert 120 <= d["req_per_s"] <= 280, d["req_per_s"]
                reports.append(d)
            assert _shape(reports[0]) == _shape(reports[1])
        finally:
            await srv.stop()

    async def test_open_loop_overload_reports_drops(self):
        from seldon_core_tpu.tools.loadtest import run_open_loop as r_open

        class Slow:
            async def __aenter__(self):
                return self

            async def __aexit__(self, *exc):
                pass

            async def __call__(self):
                await asyncio.sleep(0.5)

        for loop in (run_open_loop, r_open):
            res = await loop(Slow(), rate=300.0, seconds=1.0, warmup_s=0.1,
                             max_inflight=20)
            assert res.extra["dropped"] > 0

    async def test_open_loop_counts_warmup_admitted_completions(self):
        from seldon_core_tpu.tools.loadtest import run_open_loop as r_open

        class Stream:
            async def __aenter__(self):
                return self

            async def __aexit__(self, *exc):
                pass

            async def __call__(self):
                await asyncio.sleep(0.3)

        for loop in (run_open_loop, r_open):
            res = await loop(Stream(), rate=20.0, seconds=0.5,
                             warmup_s=0.25, seed=0)
            assert res.requests > len(res.latencies_ms) > 0
            assert res.to_dict()["req_per_s"] > 0


def test_run_load_sync_counts():
    class Quick:
        calls = 0

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            pass

        async def __call__(self):
            Quick.calls += 1
            await asyncio.sleep(0.001)

    res = run_load_sync(Quick(), seconds=0.3, concurrency=4, warmup_s=0.05)
    assert 0 < res.requests <= Quick.calls
    assert res.protocol == "Quick"


# overload_drill: each package's drill runs over a port engine of its own
# (one factory, so neither run inherits the other's admission state) with
# the same seed, rate and priority mix.  The reference's drill binds the
# reference's QoS context; ``_bridged`` rebinds it as the port's, which the
# port engine reads.  Offered counts are EQUAL to each other and to what
# the seed schedules; the shed order (which class sheds first, and more)
# is the same in both.

def _drill_window(seed, rate, mix, warmup_near, seconds_near, n=2000):
    """``(warmup_s, seconds, offered)`` for ``overload_drill`` at ``rate``
    and ``seed``.  Each window edge sits in the middle of the widest gap
    between two of the drill's seeded arrivals within 0.15 s of where it
    is asked for, so a drill loop that wakes a few ms late on a loaded
    machine still offers the same arrivals.  ``offered`` counts them by
    priority as the drill does: from the window's start through the first
    arrival past its end, which the loop issues before it stops."""
    rng, pri_rng = np.random.default_rng(seed), np.random.default_rng(seed + 1)
    names = sorted(mix)
    weights = np.asarray([mix[k] for k in names], dtype=np.float64)
    weights /= weights.sum()
    sched = [0.0]
    for _ in range(n - 1):
        sched.append(sched[-1] + rng.exponential(1.0 / rate))
    pris = [names[int(pri_rng.choice(len(names), p=weights))]
            for _ in range(n)]

    def mid_gap(t):
        k = max((k for k in range(n - 1) if abs(sched[k] - t) <= 0.15),
                key=lambda k: sched[k + 1] - sched[k])
        assert sched[k + 1] - sched[k] > 0.01  # 5 ms or more each side
        return (sched[k] + sched[k + 1]) / 2

    start = mid_gap(warmup_near)
    end = mid_gap(start + seconds_near)
    last = next(k for k in range(n) if sched[k] >= end)
    offered = {p: 0 for p in names}
    for k in range(last + 1):
        if sched[k] >= start:
            offered[pris[k]] += 1
    return start, end - start, offered


def _bridged(predict):
    """``predict`` of a port engine called from the reference's drill:
    the reference's QoS context (priority, deadline) bound as the
    port's."""
    from seldon_core_tpu.qos import context as rq
    from seldon_core_tpu_torch.qos import context as pq

    async def call(msg):
        ctx = rq.current_qos()
        bound = None if ctx is None else pq.QosContext(
            priority=ctx.priority,
            deadline=None if ctx.deadline is None
            else pq.Deadline(ctx.deadline.expires_at))
        with pq.qos_scope(bound):
            return await predict(msg)
    return call


def _both_drills(make_engine, **kw):
    """Each package's ``overload_drill`` over a fresh port engine; per
    package its result and the ``(priority, code)`` of every answer in
    the order they came back."""
    from seldon_core_tpu.tools.loadtest import overload_drill as r_drill
    from seldon_core_tpu_torch.qos.context import current_qos

    out = {}
    for pkg, drill, wrap in (("port", overload_drill, lambda f: f),
                             ("reference", r_drill, _bridged)):
        answers = []
        eng = make_engine()

        async def seen(msg, eng=eng, answers=answers):
            res = await eng.predict(msg)
            answers.append((current_qos().priority,
                            200 if res.status is None else res.status.code))
            return res
        res = asyncio.run(drill(
            wrap(seen),
            lambda: SeldonMessage(data=np.zeros((1, 1), np.float32)), **kw))
        out[pkg] = (res, answers)
    return out


def test_overload_drill_sheds_low_priority_first():
    """Over capacity, the admission gate sheds the low class before the
    high one under either package's drill: the first shed is low, more
    low sheds, and the high class's goodput at least the low class's."""
    from seldon_core_tpu_torch import qos as q

    class Slow:
        def has(self, m):
            return m == "predict"

        async def predict(self, msg):
            await asyncio.sleep(0.04)
            return SeldonMessage(data=np.ones((1, 1), np.float32))

    def engine():
        qos = q.EngineQos(q.QosConfig(name="p", slo_p95_ms=10_000))
        cfg = qos.admission.config
        cfg.min_limit = cfg.max_limit = qos.admission.limit = 4
        return GraphEngine({"name": "m", "type": "MODEL"},
                           resolver=lambda u: Slow(), name="p", qos=qos)

    mix = {"high": 0.5, "low": 0.5}
    warmup, seconds, offered = _drill_window(1, 200.0, mix, 0.2, 0.6)
    runs = _both_drills(engine, rate=200.0, seconds=seconds,
                        warmup_s=warmup, deadline_ms=2000,
                        priority_mix=mix, seed=1)
    (res, answers), (ref, ref_answers) = runs["port"], runs["reference"]
    assert {k: v for k, v in res.items() if k != "priorities"} == \
        {k: v for k, v in ref.items() if k != "priorities"}
    for r, ans in ((res, answers), (ref, ref_answers)):
        assert {p: r["priorities"][p]["offered"] for p in mix} == offered
        assert set(r["priorities"]["low"]) == \
            set(ref["priorities"]["low"])
        hi, lo = r["priorities"]["high"], r["priorities"]["low"]
        assert [p for p, code in ans if code == 429][:1] == ["low"], ans
        assert lo["shed"] > hi["shed"], r
        assert hi["goodput"] >= lo["goodput"], r
        assert lo["shed_latency_ms"]["p50"] < 20.0  # a shed is a fast no


def test_overload_drill_goodput_under_capacity():
    class Quick:
        def has(self, m):
            return m == "predict"

        async def predict(self, msg):
            await asyncio.sleep(0.001)
            return SeldonMessage(data=np.ones((1, 1), np.float32))

    mix = {"high": 0.5, "low": 0.5}
    warmup, seconds, offered = _drill_window(1, 150.0, mix, 0.2, 0.5)
    runs = _both_drills(
        lambda: GraphEngine({"name": "m", "type": "MODEL"},
                            resolver=lambda u: Quick(), name="p"),
        rate=150.0, seconds=seconds, warmup_s=warmup, deadline_ms=100,
        priority_mix=mix, seed=1, drill_id="x")
    for res, answers in runs.values():
        assert {p: res["priorities"][p]["offered"] for p in mix} == offered
        for pri in mix:
            assert res["priorities"][pri]["goodput"] == 1.0
        assert {code for _, code in answers} == {200}


def test_sse_stream_driver_records_ttft_and_tokens():
    from seldon_core_tpu_torch.operator.local import serve

    async def go():
        srv, local = await serve(
            os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                         "llm.json"), port=0, host="127.0.0.1",
            device="cpu", seed=0)
        try:
            class Keeping(SseStreamDriver):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    self.bodies = []

                async def __call__(self):
                    self.bodies.append(await super().__call__())

            driver = Keeping(
                f"http://127.0.0.1:{srv.port}",
                {"jsonData": {"prompt_ids": [5, 9, 2, 7], "n_new": 3}})
            async with driver:
                await driver()
            driver.ttfts_ms.clear()
            driver.tpots_ms.clear()
            driver.bodies.clear()
            driver.tokens = driver.streams_completed = 0
            res = await run_load(driver, seconds=1.0, concurrency=3,
                                 warmup_s=0.1, protocol="sse-stream")
            assert res.failures == 0 and res.requests >= 1
            stats = driver.stream_stats(res.req_per_s)
            assert stats["streams_completed"] >= res.requests
            assert stats["tokens"] == 3 * stats["streams_completed"]
            assert stats["tokens_per_s"] > 0
            assert stats["ttft_ms"]["p50"] > 0
            assert stats["tpot_ms"]["p50"] > 0
            # recorded: each stream's last event, its ids greedy and equal
            finals = driver.bodies
            assert len(finals) == stats["streams_completed"]
            assert all(f["done"] and f["ids"] == finals[0]["ids"]
                       for f in finals)
            rest = RestDriver(f"http://127.0.0.1:{srv.port}",
                              {"jsonData": {"prompt_ids": [5, 9, 2, 7],
                                            "n_new": 3}})
            async with rest:
                body = await rest()
            assert json.loads(body)["jsonData"]["ids"] == finals[0]["ids"]
            # a non-stream answer is a failure, not a hang
            bad = SseStreamDriver(f"http://127.0.0.1:{srv.port}", {},
                                  path="/api/v0.1/predictions")
            async with bad:
                with pytest.raises(RuntimeError):
                    await bad()
        finally:
            await srv.stop()
            await local.aclose()

    asyncio.run(go())


# -- replay ----------------------------------------------------------------

BODIES = [
    (b'{"data": {"ndarray": [[1.0]]}, "meta": {"puid": "a", "tags": '
     b'{"artifact-source": "aot-cache", "device-plane": "on"}}}',
     b'{"meta": {"puid": "b"}, "data": {"ndarray": [[1.0]]}}'),
    (b'{"data": {"ndarray": [[1.0]]}}', b'{"data": {"ndarray": [[1.5]]}}'),
    (b"not json", b"not json"),
    (b"not json", b"{}"),
    (b'{"meta": {"tags": {"artifact-source": "live"}}}', b"[1, 2]"),
]


@pytest.mark.parametrize("a,b", BODIES)
def test_replay_verdicts_equal_the_reference(a, b):
    from seldon_core_tpu.tools import replay as r
    from seldon_core_tpu_torch.tools import replay as p

    for strict in (False, True):
        assert p.compare_responses(a, b, strict) == \
            r.compare_responses(a, b, strict)
    for body in (a, b):
        assert p.canonical_body(body) == r.canonical_body(body)
        assert p.artifact_source(body) == r.artifact_source(body)
        assert p.device_plane_tag(body) == r.device_plane_tag(body)


def test_replay_cli_against_the_port_engine(tmp_path, capsys):
    """A gateway flight record replayed at the port's engine: EQUAL to a
    second engine, the device-plane stamp as asserted, a wrong expected
    artifact source exits 1, an engine-side record (no body) exits 2."""
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.tools import replay

    iris = os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                        "iris.json")
    body = '{"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}'
    rec = {"puid": "p1", "deployment": "iris", "status": 200,
           "durationMs": 1.0, "request": {
               "body": body, "path": "/api/v0.1/predictions",
               "contentType": "application/json"}}
    path = tmp_path / "rec.json"
    path.write_text(json.dumps({"records": [rec]}))
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps({"puid": "e1", "request": None}) + "\n")
    result = {}

    def serve_two():
        async def go():
            a, da = await serve(iris, port=0, host="127.0.0.1", device="cpu")
            b, db = await serve(iris, port=0, host="127.0.0.1", device="cpu")
            result["urls"] = (f"http://127.0.0.1:{a.port}",
                              f"http://127.0.0.1:{b.port}")
            result["ready"].set()
            while not result["done"].is_set():
                await asyncio.sleep(0.05)
            for s, d in ((a, da), (b, db)):
                await s.stop()
                await d.aclose()
        asyncio.run(go())

    result["ready"], result["done"] = threading.Event(), threading.Event()
    t = threading.Thread(target=serve_two, daemon=True)
    t.start()
    assert result["ready"].wait(60)
    a, b = result["urls"]
    try:
        assert replay.main(["--record", str(path), "--to", a,
                            "--compare", b]) == 0
        assert "parity: OK" in capsys.readouterr().out
        assert replay.main(["--record", str(path), "--puid", "p1",
                            "--to", a, "--expect-device-plane", "off"]) == 0
        assert replay.main(["--record", str(path), "--to", a,
                            "--expect-artifact-source", "aot-cache"]) == 1
        assert "MISMATCH" in capsys.readouterr().err
        assert replay.main(["--record", str(bare), "--to", a]) == 2
    finally:
        result["done"].set()
        t.join(30)


# -- viewers ---------------------------------------------------------------

def _viewer_texts(mod_name: str, argv: list, capsys) -> str:
    import importlib

    texts = []
    for pkg in ("seldon_core_tpu", "seldon_core_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.tools.{mod_name}")
        rc = mod.main(list(argv))
        texts.append((rc, capsys.readouterr().out))
    assert texts[0] == texts[1], mod_name
    return texts[1][1]


def test_viewers_render_the_port_bodies_as_the_reference(tmp_path, capsys):
    """``/trace``, ``/admin/introspect`` and ``/admin/profile`` of a port
    engine, ``/admin/fleet/health`` and ``/admin/fleet/decisions`` of a
    port fleet: each viewer's text is EQUAL to the reference's."""
    from seldon_core_tpu_torch.operator.local import LocalFleet, serve

    ann = {"seldon.io/tracing": "true", "seldon.io/health": "true",
           "seldon.io/health-sample-ms": "20", "seldon.io/profile": "true",
           "seldon.io/profile-hz": "200", "seldon.io/batching": "false"}
    dep = {"metadata": {"name": "v", "annotations": ann},
           "spec": {"predictors": [{"name": "p", "graph": {
               "name": "clf", "type": "MODEL", "parameters": [{
                   "name": "model_class", "type": "STRING",
                   "value": "seldon_core_tpu_torch.models.iris:"
                            "IrisClassifier"}]}}]}}
    fleet_dep = json.loads(json.dumps(dep))
    fleet_dep["metadata"]["annotations"] = {
        "seldon.io/batching": "false", "seldon.io/fleet-replicas": "3",
        "seldon.io/health": "true", "seldon.io/fleet-policy": "round-robin"}
    dumps = {}

    async def go():
        srv, local = await serve(dep, port=0, host="127.0.0.1", device="cpu")
        fl = await LocalFleet(fleet_dep, device="cpu").start()
        http = HttpSession()
        body = b'{"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}'
        hdr = {"Content-Type": "application/json",
               "traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for _ in range(4):
                await http.request("POST", base + "/api/v0.1/predictions",
                                   body, hdr)
            for rep in fl.replicas():
                await http.request("POST",
                                   rep["url"] + "/api/v0.1/predictions",
                                   body, hdr)
            await asyncio.sleep(0.3)
            for name, url in (
                    ("trace", base + "/trace?trace_id=" + "ab" * 16),
                    ("introspect", base + "/admin/introspect?n=5"),
                    ("profile", base + "/admin/profile"),
                    ("health", fl.replicas()[0]["url"]
                     + "/admin/fleet/health?refresh=1"),
                    ("decisions", fl.replicas()[0]["url"]
                     + "/admin/fleet/decisions")):
                st, _, raw = await http.request("GET", url)
                assert st == 200, (name, raw)
                dumps[name] = raw
        finally:
            await http.close()
            await fl.stop()
            await srv.stop()
            await local.aclose()

    asyncio.run(go())
    files = {}
    for name, raw in dumps.items():
        files[name] = str(tmp_path / f"{name}.json")
        with open(files[name], "wb") as f:
            f.write(raw)
    assert "4 trace(s)" in _viewer_texts("traceview", [files["trace"]], capsys)
    _viewer_texts("traceview", ["--introspect", files["introspect"],
                                "--lanes", "memory,queue"], capsys)
    _viewer_texts("profview", [files["profile"], "--min-pct", "0"], capsys)
    _viewer_texts("profview", ["--diff", files["profile"],
                               files["profile"]], capsys)
    out = _viewer_texts("fleetview", [files["health"], "--decisions",
                                      files["decisions"]], capsys)
    assert "r0" in out


# -- the CLI ---------------------------------------------------------------

def _threaded_server(component=None, engine_factory=None):
    """A RestServer on a loop of its own thread, for the CLI's own
    ``asyncio.run``; returns ``(port, stop)``."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state = {}

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            engine = engine_factory() if engine_factory else None
            state["srv"] = await RestServer(engine, host="127.0.0.1", port=0,
                                            component=component).start()
            started.set()
        loop.run_until_complete(boot())
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(30)

    def stop():
        asyncio.run_coroutine_threadsafe(state["srv"].stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(5)
    return state["srv"].port, stop


def _both_cli(argv, capsys):
    """Each package's ``python -m ... tools`` main on the same argv;
    ``[(rc, stdout), ...]``, the port's first."""
    from seldon_core_tpu.tools.__main__ import main as r_main
    from seldon_core_tpu_torch.tools.__main__ import main

    outs = []
    for fn in (main, r_main):
        rc = fn(list(argv))
        outs.append((rc, capsys.readouterr().out))
    return outs


def _shape(doc):
    """The keys of a JSON document, all the way down (a load report's
    numbers are timings, so two runs agree only on its keys)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return type(doc).__name__


class TestCli:
    def test_contract_test_and_load(self, tmp_path, capsys):
        cpath = tmp_path / "contract.json"
        cpath.write_text(json.dumps(CONTRACT))
        port, stop = _threaded_server(_echo())
        try:
            (rc, out), ref = _both_cli(
                ["contract-test", str(cpath), "-p", str(port), "-n", "2",
                 "-b", "3", "--seed", "0"], capsys)
            assert (rc, out) == ref
            out = json.loads(out)
            assert rc == 0 and out["ok"] and out["sent"] == 2
            assert "responses" not in out
            (rc, out), ref = _both_cli(
                ["contract-test", str(cpath), "-p", str(port), "-n", "2",
                 "--seed", "0", "-v", "--endpoint", "send-feedback"], capsys)
            assert (rc, out) == ref and rc == 0
            for argv, mode in (
                    (["-c", "2"], "closed-loop"), (["--rate", "50"],
                                                   "open-loop")):
                (rc, out), (r_rc, r_out) = _both_cli(
                    ["load", str(cpath), "--url", f"http://127.0.0.1:{port}",
                     "--path", "/predict", "-s", "0.3", "--warmup", "0.05"]
                    + argv, capsys)
                out, r_out = json.loads(out), json.loads(r_out)
                assert (rc, _shape(out)) == (r_rc, _shape(r_out)) and rc == 0
                assert out["protocol"] == "rest" and out["requests"] > 0
                assert out.get("mode", "closed-loop") == mode
        finally:
            stop()

    def test_api_test_against_an_engine(self, capsys):
        from seldon_core_tpu_torch.graph.spec import load_deployment
        from seldon_core_tpu_torch.operator.local import LocalDeployment

        iris = os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                            "iris.json")
        port, stop = _threaded_server(engine_factory=lambda: LocalDeployment(
            load_deployment(iris), device="cpu"))
        contract = os.path.join(REPO, "examples", "contracts", "iris.json")
        try:
            (rc, out), (r_rc, r_out) = _both_cli(
                ["api-test", contract, "--url", f"http://127.0.0.1:{port}",
                 "-n", "3", "-b", "2", "--seed", "0", "-v"], capsys)
            out = json.loads(out)
            assert (rc, _without_puid(out)) == \
                (r_rc, _without_puid(json.loads(r_out)))
            assert rc == 0 and out["ok"] and len(out["responses"]) == 3
            assert np.asarray(out["responses"][0]["data"]["ndarray"]
                              ).shape == (2, 3)
        finally:
            stop()

    def test_load_cli_stream_flag_wiring(self, capsys):
        contract = os.path.join(REPO, "examples", "contracts", "llm.json")
        (rc, out), (r_rc, r_out) = _both_cli(
            ["load", contract, "--stream", "--url", "http://127.0.0.1:9",
             "-c", "1", "-s", "0.3", "--warmup", "0"], capsys)
        out, r_out = json.loads(out), json.loads(r_out)
        assert (rc, _shape(out)) == (r_rc, _shape(r_out)) and rc == 1
        assert out["protocol"] == "sse-stream"
        assert out["stream"] == r_out["stream"]
        assert out["stream"]["streams_completed"] == 0
        assert "ttft_ms" not in out["stream"]

    def test_firehose_tail(self, tmp_path, capsys):
        from seldon_core_tpu_torch.gateway.firehose_net import (
            FirehoseBroker,
            NetworkFirehose,
        )

        broker = FirehoseBroker(str(tmp_path)).start()
        target = f"127.0.0.1:{broker.port}"
        try:
            fh = NetworkFirehose(target)
            for i in range(3):
                fh.publish("client-a", {"i": i}, {"o": i})
            assert fh.flush()
            (rc, out), ref = _both_cli(
                ["firehose-tail", "client-a", "--target", target], capsys)
            assert (rc, out) == ref and rc == 0
            lines = out.strip().splitlines()
            assert [json.loads(ln)["offset"] for ln in lines] == [0, 1, 2]
            (rc, out), ref = _both_cli(
                ["firehose-tail", "client-a", "--target", target,
                 "--from-offset", "2"], capsys)
            assert (rc, out) == ref and rc == 0
            assert len(out.strip().splitlines()) == 1
        finally:
            broker.stop()
        from seldon_core_tpu_torch.tools.__main__ import main

        assert main(["firehose-tail", "client-a", "--target", target]) == 1

    def test_save_model_on_the_cpu(self, tmp_path, capsys):
        from seldon_core_tpu_torch.runtime.checkpoint import load_checkpoint
        from seldon_core_tpu_torch.tools.__main__ import main

        out_dir = tmp_path / "ckpt"
        assert main(["save-model",
                     "seldon_core_tpu_torch.models.llm_demo:DemoLLM",
                     str(out_dir), "--param", "n_layers=1",
                     "--device", "cpu"]) == 0
        tree, meta = load_checkpoint(str(out_dir))
        assert tree and meta
        assert main(["save-model",
                     "seldon_core_tpu_torch.models.iris:IrisClassifier",
                     str(tmp_path / "x"), "--device", "cpu"]) == 1
        assert "has no save_checkpoint()" in capsys.readouterr().err
