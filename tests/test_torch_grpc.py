"""The port's gRPC tier against the reference's on the CPU.

- Component services (``Model``, ``Router``, ``Combiner``, ``Generic``):
  the same components behind the reference's ``GrpcServer`` and the
  port's, called by the reference's ``GrpcComponentClient`` and the
  port's in all four pairings (the two cross-wire directions included):
  every answer EQUAL to the reference pair's (data exact, meta, status,
  feedback delivered, a component error a FAILURE of the same code).
- The external ``Seldon`` service over a graph engine, ``oauth_token``
  auth answering ``UNAUTHENTICATED``, and a ``GRPC`` graph node in the
  runner: answers EQUAL to the reference's.
- The LLM over ``Predict`` and ``Stream`` (``llm.json``'s model, the
  reference's weights converted): greedy ids and streamed tokens EQUAL;
  a stream cancelled after its first event frees its slot and pages.
- The microservice's GRPC mode and the runner's ``--grpc-port`` from
  subprocesses; a taken port is refused unless ``reuse_port``.

Every socket test runs under its own timeout (``_run``).
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.runtime.component import (
    SeldonComponentError as JComponentError,
)
from seldon_core_tpu.serving import grpc_api as jg
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.operator.local import LocalDeployment
from seldon_core_tpu_torch.graph.spec import load_deployment
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.runtime.paged import PagedConfig
from seldon_core_tpu_torch.serving import grpc_api as tg

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 180

SIDES = {"ref": (jg, JHandle, JMessage, JFeedback, JComponentError),
         "port": (tg, THandle, TMessage, TFeedback, SeldonComponentError)}


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class EchoModel:
    def predict(self, X, names):
        return np.asarray(X) * 2

    def tags(self):
        return {"served_by": "echo"}

    def metrics(self):
        return [{"key": "echo_calls", "type": "COUNTER", "value": 1}]


class ConstRouter:
    def route(self, X, names):
        return 1


class MeanCombiner:
    def aggregate(self, Xs, names_list):
        return np.mean(np.stack([np.asarray(x) for x in Xs]), axis=0)


class FeedbackSink:
    def __init__(self):
        self.rewards = []

    def predict(self, X, names):
        return X

    def send_feedback(self, request, names, reward, truth, routing=None):
        self.rewards.append(reward)


class Boom:
    def predict(self, X, names):
        raise ValueError("nope")


async def _component_server(side, obj, name, service_type):
    g, H = SIDES[side][:2]
    handle = H(obj, name=name, service_type=service_type)
    server = g.GrpcServer(g.component_service_handlers(handle, service_type),
                          port=0, host="127.0.0.1")
    return server, await server.start()


def _canon(msg):
    d = msg.to_dict()
    for m in d.get("meta", {}).get("metrics", []):
        m.pop("value", None)
    return d


async def _component_answers(server_side, client_side):
    """What a client of ``client_side`` gets from servers of
    ``server_side``: model, router, combiner, feedback, error."""
    g, _, M, F, E = SIDES[client_side]
    sink = FeedbackSink()
    servers = {}
    for name, obj, st in (("echo", EchoModel(), "MODEL"),
                          ("r", ConstRouter(), "ROUTER"),
                          ("c", MeanCombiner(), "COMBINER"),
                          ("sink", sink, "MODEL"), ("boom", Boom(), "MODEL")):
        servers[name] = await _component_server(server_side, obj, name, st)
    clients = {k: g.GrpcComponentClient(f"127.0.0.1:{p}")
               for k, (_, p) in servers.items()}
    try:
        out = {}
        echo = await clients["echo"].predict(
            M(data=np.array([[1.0, 2.5]]), names=["a", "b"]))
        out["echo"] = _canon(echo)
        out["route"] = await clients["r"].route(M(data=np.zeros((1, 2))))
        agg = await clients["c"].aggregate([M(data=np.array([[0.0, 2.0]])),
                                            M(data=np.array([[2.0, 4.0]]))])
        out["aggregate"] = agg.host_data().tolist()
        fb = await clients["sink"].send_feedback(F(
            request=M(data=np.array([[1.0]])), reward=0.5))
        out["feedback"] = (sink.rewards, fb.status.to_dict())
        try:
            await clients["boom"].predict(M(data=np.zeros((1,))))
            out["error"] = None
        except E as e:
            out["error"] = (e.status_code, e.reason, "nope" in str(e))
        return out
    finally:
        for c in clients.values():
            await c.close()
        for s, _ in servers.values():
            await s.stop()


def test_component_services_answer_as_the_references_in_every_pairing():
    pairs = [("ref", "ref"), ("port", "port"), ("port", "ref"),
             ("ref", "port")]
    got = {p: _run(_component_answers(*p)) for p in pairs}
    want = got["ref", "ref"]
    for p in pairs:
        assert got[p] == want, p
    assert want["echo"]["data"]["ndarray"] == [[2.0, 5.0]]
    assert want["echo"]["meta"]["tags"] == {"served_by": "echo"}
    assert want["route"] == 1 and want["aggregate"] == [[1.0, 3.0]]
    assert want["feedback"][0] == [0.5]
    assert want["error"] == (500, "INTERNAL", True)


def _combo():
    return {"name": "combo", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [{"name": "m1", "implementation": "SIMPLE_MODEL"},
                         {"name": "m2", "implementation": "SIMPLE_MODEL"}]}


def test_seldon_service_and_auth_as_the_references():
    def auth(md):
        return "dep" if md.get("oauth_token") == "sekrit" else None

    async def answers(server_side, client_side):
        g = SIDES[server_side][0]
        eng = (JEngine if server_side == "ref" else TEngine)(_combo())
        server = g.GrpcServer([g.seldon_service_handler(eng, auth=auth)],
                              port=0, host="127.0.0.1")
        port = await server.start()
        cg, M, F = SIDES[client_side][0], SIDES[client_side][2], \
            SIDES[client_side][3]
        try:
            bad = cg.SeldonGrpcClient(f"127.0.0.1:{port}", token="wrong")
            with pytest.raises(grpc.aio.AioRpcError) as ei:
                await bad.predict(M(data=np.zeros((1, 2))))
            await bad.close()
            good = cg.SeldonGrpcClient(f"127.0.0.1:{port}", token="sekrit")
            out = await good.predict(M(data=np.array([[1.0, 2.0]]),
                                       names=["a", "b"]))
            fb = await good.send_feedback(F(reward=1.0))
            await good.close()
            d = out.to_dict()
            assert d["meta"].pop("puid")
            return ei.value.code(), d, fb.status.to_dict()
        finally:
            await server.stop()

    got = {p: _run(answers(*p)) for p in (("ref", "ref"), ("port", "port"),
                                          ("port", "ref"), ("ref", "port"))}
    want = got["ref", "ref"]
    assert all(v == want for v in got.values()), got
    assert want[0] == grpc.StatusCode.UNAUTHENTICATED
    assert want[1]["status"]["status"] == "SUCCESS"
    assert set(want[1]["meta"]["requestPath"]) == {"combo", "m1", "m2"}


def test_grpc_graph_node_in_the_runner_answers_as_the_references():
    """A router (remote, gRPC) over two remote models: the port's runner
    resolves the ``GRPC`` endpoints; the reference's engine calls the same
    servers with its own client.  Answers and routing EQUAL."""

    async def run():
        servers = {}
        for name, obj, st in (("router", ConstRouter(), "ROUTER"),
                              ("a", EchoModel(), "MODEL"),
                              ("b", FeedbackSink(), "MODEL")):
            servers[name] = await _component_server("port", obj, name, st)
        graph = {"name": "router", "type": "ROUTER", "children": [
            {"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}

        def with_endpoints(u):
            u = dict(u)
            u["endpoint"] = {"service_host": "127.0.0.1", "type": "GRPC",
                             "service_port": servers[u["name"]][1]}
            u["children"] = [with_endpoints(c) for c in u.get("children", [])]
            return u

        dep = {"spec": {"name": "g", "annotations": {
            "seldon.io/grpc-read-timeout": "20000"}, "predictors": [
                {"name": "main", "graph": with_endpoints(graph)}]}}
        local = LocalDeployment(load_deployment(dep), device="cpu")
        jclients = {k: jg.GrpcComponentClient(f"127.0.0.1:{p}")
                    for k, (_, p) in servers.items()}
        jeng = JEngine(graph, resolver=lambda u: jclients[u.name], name="main")
        try:
            x = np.array([[1.0, 2.0, 3.0]])
            t = await local.predict(TMessage(data=x, names=["p", "q", "r"]))
            j = await jeng.predict(JMessage(data=x, names=["p", "q", "r"]))
            tf = await local.send_feedback(TFeedback(
                response=t, reward=1.0))
            jf = await jeng.send_feedback(JFeedback(
                response=JMessage(meta=j.meta), reward=1.0))
            return t, j, tf, jf, local
        finally:
            for c in jclients.values():
                await c.close()
            for name in servers:
                await local.engine.node_impl(name).close()
            for s, _ in servers.values():
                await s.stop()

    t, j, tf, jf, local = _run(run())
    td, jd = t.to_dict(), j.to_dict()
    td["meta"].pop("puid"), jd["meta"].pop("puid")
    assert td == jd
    assert td["meta"]["routing"] == {"router": 1}
    assert td["data"]["ndarray"] == [[1.0, 2.0, 3.0]]
    assert tf.status.to_dict() == jf.status.to_dict()
    assert isinstance(local.engine.node_impl("a"), tg.GrpcComponentClient)


# ---- the LLM over Predict and Stream ---------------------------------------

def _llm(max_slots=4):
    """llm.json's DemoLLM (the reference's) and a port LLMComponent over
    its converted weights."""
    params = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=256, max_seq=128, max_slots=max_slots, n_new=8,
                  int8="full", paged_pages=65, page_size=16)
    j = JDemoLLM(**params)
    jc = j.engine.cfg
    cfg = ttf.TransformerConfig(
        vocab_size=jc.vocab_size, d_model=jc.d_model, n_layers=jc.n_layers,
        n_heads=jc.n_heads, n_kv_heads=jc.n_kv_heads, d_ff=jc.d_ff,
        max_seq=jc.max_seq, dtype=torch.float32)
    engine = tllm.PagedLLMEngine(
        convert.params_from_jax(jax.tree.map(np.asarray, j.engine.params)),
        cfg, PagedConfig(65, 16), max_slots=max_slots)
    return j, tllm.LLMComponent(engine, n_new=8)


PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [], list(range(1, 40)), [7] * 20]


def test_llm_predict_and_stream_ids_equal_the_references():
    j, t = _llm()

    async def answers(side, comp):
        server, port = await _component_server(side, comp, "llm", "MODEL")
        client = tg.GrpcComponentClient(f"127.0.0.1:{port}")
        try:
            out = []
            for p in PROMPTS:
                req = TMessage(json_data={"prompt_ids": p, "n_new": 5})
                pred = await client.predict(req)
                events = [e async for e in client.stream(req)]
                out.append((pred.json_data["ids"],
                            [e.get("token") for e in events[:-1]],
                            events[-1]["ids"], events[-1]["prompt_len"]))
            return out
        finally:
            await client.close()
            await server.stop()

    want = _run(answers("ref", j))
    got = _run(answers("port", t))
    t.engine.close()
    assert got == want
    for (ids, tokens, done_ids, plen), p in zip(got, PROMPTS):
        assert done_ids == ids and ids[:len(p)] == p
        assert tokens == ids[len(p):] and plen == len(p)
    assert len(got[1][0]) == 5  # the empty prompt


def test_cancelled_stream_frees_its_slot_and_pages():
    _, comp = _llm(max_slots=1)
    eng = comp.engine
    full = eng.free_pages

    async def run():
        server, port = await _component_server("port", comp, "llm", "MODEL")
        client = tg.GrpcComponentClient(f"127.0.0.1:{port}")
        try:
            req = TMessage(json_data={"prompt_ids": [5, 9, 2, 7] * 8,
                                      "n_new": 60})
            agen = client.stream(req)
            await agen.__anext__()
            held = (len(eng._slots), eng.free_pages)
            await agen.aclose()  # cancels the call mid-stream
            t0 = time.monotonic()
            while (eng._slots or eng.free_pages != full) and \
                    time.monotonic() - t0 < 20:
                await asyncio.sleep(0.02)
            freed = (len(eng._slots), eng.free_pages, len(eng._free))
            # the one slot serves again, end to end
            events = [e async for e in client.stream(TMessage(
                json_data={"prompt_ids": [1, 2], "n_new": 3}))]
            return held, freed, events
        finally:
            await client.close()
            await server.stop()

    held, freed, events = _run(run())
    eng.close()
    assert held[0] == 1 and held[1] < full
    assert freed == (0, full, 1)
    assert events[-1]["done"] and len(events[-1]["ids"]) == 5


def test_stream_of_a_component_without_one_is_unimplemented():
    async def code(side):
        server, port = await _component_server(side, EchoModel(), "echo",
                                               "MODEL")
        client = tg.GrpcComponentClient(f"127.0.0.1:{port}")
        try:
            with pytest.raises(grpc.aio.AioRpcError) as ei:
                async for _ in client.stream(TMessage(
                        json_data={"prompt_ids": [1]})):
                    pass
            return ei.value.code()
        finally:
            await client.close()
            await server.stop()

    assert _run(code("port")) == _run(code("ref")) == \
        grpc.StatusCode.UNIMPLEMENTED


def test_transport_errors_map_as_the_references():
    async def errors(side):
        g, _, M, _, E = SIDES[side]
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        out = []
        c = g.GrpcComponentClient(f"127.0.0.1:{dead}", timeout_s=5.0)
        try:
            await c.predict(M(data=np.zeros((1, 2))))
        except E as e:
            out.append((e.status_code, e.reason))
        await c.close()

        class Slow:
            async def predict(self, msg):
                await asyncio.sleep(2.0)
                return msg

            def has(self, m):
                return m == "predict"

        server = g.GrpcServer(g.component_service_handlers(Slow(), "MODEL"),
                              port=0, host="127.0.0.1")
        port = await server.start()
        c = g.GrpcComponentClient(f"127.0.0.1:{port}", timeout_s=0.2)
        try:
            await c.predict(M(data=np.zeros((1, 2))))
        except E as e:
            out.append((e.status_code, e.reason))
        await c.close()
        await server.stop(0)
        return out

    assert _run(errors("port")) == _run(errors("ref")) == [
        (503, "TRANSPORT"), (504, "DEADLINE_EXCEEDED")]


def test_a_client_serves_more_than_one_event_loop():
    """A channel belongs to its loop: the client makes one per loop."""
    from seldon_core_tpu_torch.serving.workers import pick_free_port

    port = pick_free_port()
    client = tg.GrpcComponentClient(f"127.0.0.1:{port}")

    async def serve_and_call():
        server = tg.GrpcServer(tg.component_service_handlers(
            THandle(EchoModel(), name="echo"), "MODEL"), port=port,
            host="127.0.0.1")
        await server.start()
        try:
            out = await client.predict(TMessage(data=np.array([[1.0]])))
            return out.host_data().tolist()
        finally:
            await server.stop(0)

    assert _run(serve_and_call()) == [[2.0]]
    assert _run(serve_and_call()) == [[2.0]]


def test_a_taken_port_is_refused_unless_reuse_port():
    async def run():
        first = tg.GrpcServer([], port=0, host="127.0.0.1")
        port = await first.start()
        try:
            with pytest.raises(RuntimeError):
                tg.GrpcServer([], port=port, host="127.0.0.1")
            a = tg.GrpcServer([], port=0, host="127.0.0.1", reuse_port=True)
            shared = await a.start()
            b = tg.GrpcServer([], port=shared, host="127.0.0.1",
                              reuse_port=True)
            assert b.port == shared
            await a.stop(0)
            await b.stop(0)
        finally:
            await first.stop(0)

    _run(run())


# ---- the entry points, as subprocesses -------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _reap(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def _line(proc, marker):
    lines = []
    while True:
        ln = proc.stdout.readline()
        if not ln:
            raise AssertionError("".join(lines))
        lines.append(ln)
        if marker in ln:
            return ln


def test_microservice_serves_grpc_from_a_subprocess():
    proc = _spawn(["seldon_core_tpu_torch.serving.microservice",
                   "seldon_core_tpu_torch.graph.builtins:SimpleModel", "GRPC",
                   "--port", "0", "--host", "127.0.0.1", "--device", "cpu"])
    try:
        port = int(_line(proc, "serving gRPC on").strip().rsplit(":", 1)[1])

        async def call():
            outs = []
            for g, M in ((tg, TMessage), (jg, JMessage)):
                c = g.GrpcComponentClient(f"127.0.0.1:{port}")
                outs.append((await c.predict(M(data=np.ones((2, 3)))))
                            .to_dict()["data"])
                await c.close()
            return outs

        t, j = _run(call(), 60)
    finally:
        assert _reap(proc) in (0, -signal.SIGTERM)
    assert t == j and t["names"] == ["svc1", "svc2", "svc3"]


def test_runner_serves_the_seldon_service_on_its_grpc_port():
    """``--grpc-port`` (and ``ENGINE_SERVER_GRPC_PORT`` when the flag is not
    given): the Seldon service answers as the REST tier does."""
    graph = ROOT / "seldon_core_tpu_torch" / "examples" / "iris.json"
    for flag in (True, False):
        gport = _free_port()
        args = ["seldon_core_tpu_torch.operator.local", "--graph", str(graph),
                "--port", "0", "--host", "127.0.0.1", "--device", "cpu"]
        env = None
        if flag:
            args += ["--grpc-port", str(gport)]
        else:
            env = {"ENGINE_SERVER_GRPC_PORT": str(gport)}
        proc = _spawn(args, env)
        try:
            assert f":{gport}" in _line(proc, "gRPC Seldon service on")
            rport = int(_line(proc, "serving deployment").strip()
                        .rsplit(":", 1)[1])
            body = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}

            def rest():
                import urllib.request

                req = urllib.request.Request(
                    f"http://127.0.0.1:{rport}/api/v0.1/predictions",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    return json.loads(r.read())

            async def grpc_call():
                c = tg.SeldonGrpcClient(f"127.0.0.1:{gport}")
                try:
                    return (await c.predict(TMessage.from_dict(body)))\
                        .to_dict()
                finally:
                    await c.close()

            g = _run(grpc_call(), 60)
            r = rest()
        finally:
            _reap(proc)
        g["meta"].pop("puid"), r["meta"].pop("puid")
        assert g == r and g["status"]["status"] == "SUCCESS"


def test_runner_flags_default_as_the_references(monkeypatch):
    from seldon_core_tpu_torch.operator.local import build_parser

    monkeypatch.delenv("ENGINE_SERVER_GRPC_PORT", raising=False)
    monkeypatch.delenv("ENGINE_WORKERS", raising=False)
    args = build_parser().parse_args(["--graph", "g.json"])
    assert (args.grpc_port, args.native_grpc_port, args.workers) == (5000, 0,
                                                                      1)
    monkeypatch.setenv("ENGINE_SERVER_GRPC_PORT", "0")
    monkeypatch.setenv("ENGINE_WORKERS", "3")
    args = build_parser().parse_args(["--graph", "g.json"])
    assert (args.grpc_port, args.workers) == (0, 3)
