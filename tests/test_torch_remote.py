"""Engines calling remote components over REST, the port's against the
reference's on the CPU.

- Two stacks on the same weights: the reference's engine with its
  ``RemoteComponent`` nodes calling the reference's ``ComponentServer``s
  (aiohttp), and the port's local runner (a graph whose nodes have an
  ``endpoint``) calling the port's component servers.  Both answer iris,
  the MAB (a remote router taking feedback), the ensemble and ``llm.json``
  alike: the same status and meta, data within atol 1e-5 (float32 matmuls
  of two frameworks), greedy ids and streamed tokens EQUAL, the empty
  prompt included.
- Cross-wire: the reference's ``RemoteComponent`` against the port's
  component server, and the port's against the reference's, give the
  answers of their own pairs.
- Errors map as the reference's do: a remote FAILURE keeps its code, a
  refused connection is 503 ``TRANSPORT``, a slow reply 504
  ``DEADLINE_EXCEEDED``, a missing stream route 501.

Every socket test runs under its own timeout (``_run``, urllib timeouts).
"""

import asyncio
import json
import socket
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import builtins as jbuiltins
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models import iris as jiris
from seldon_core_tpu.models import mlp as jmlp
from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.runtime.component import (
    SeldonComponentError as JComponentError,
)
from seldon_core_tpu.serving.client import RemoteComponent as JRemote
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu.utils.metrics import EngineMetrics as JMetrics
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph import builtins as tbuiltins
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.messages import Status as TStatus
from seldon_core_tpu_torch.models import iris as tiris
from seldon_core_tpu_torch.models import mlp as tmlp
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.operator.local import serve
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.runtime.paged import PagedConfig
from seldon_core_tpu_torch.serving.client import ExternalClient, RemoteComponent
from seldon_core_tpu_torch.serving.rest import RestServer

TIMEOUT = 180
ATOL = 1e-5


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw, code = r.read().decode(), r.status
            if path.endswith("/stream"):
                return code, [json.loads(ln[6:]) for ln in raw.split("\n\n")
                              if ln.startswith("data: ")]
            return code, json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---- the two stacks --------------------------------------------------------

def _iris():
    j = jiris.IrisClassifier()
    t = tiris.IrisClassifier(params=convert.params_from_jax(_host(j.params)),
                             device="cpu")
    return j, t


def _mlp(hidden, seed):
    j = jmlp.MNISTMLP(hidden=hidden, seed=seed)
    t = tmlp.MNISTMLP(hidden=hidden, device="cpu",
                      params=convert.params_from_jax(_host(j.params)))
    return j, t


def _eg():
    kw = dict(n_branches=2, epsilon=0.5, seed=5)
    return jbuiltins.EpsilonGreedy(**kw), tbuiltins.EpsilonGreedy(**kw)


def _llm():
    """The reference's DemoLLM of llm.json, and a port LLMComponent over
    its converted weights."""
    params = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=256, max_seq=128, max_slots=4, n_new=8,
                  int8="full", paged_pages=65, page_size=16)
    j = JDemoLLM(**params)
    jc = j.engine.cfg
    cfg = ttf.TransformerConfig(
        vocab_size=jc.vocab_size, d_model=jc.d_model, n_layers=jc.n_layers,
        n_heads=jc.n_heads, n_kv_heads=jc.n_kv_heads, d_ff=jc.d_ff,
        max_seq=jc.max_seq, dtype=torch.float32)
    engine = tllm.PagedLLMEngine(
        convert.params_from_jax(_host(j.engine.params)), cfg,
        PagedConfig(65, 16), max_slots=4)
    return j, tllm.LLMComponent(engine, n_new=8)


_IMG = np.random.default_rng(3).normal(size=(2, 784)).round(3)
GRAPHS = {
    # graph, {remote node: (factory, service type)}, requests
    "iris": ({"name": "classifier", "type": "MODEL"},
             {"classifier": (_iris, "MODEL")},
             [{"data": {"names": ["a", "b", "c", "d"],
                        "ndarray": [[5.1, 3.5, 1.4, 0.2],
                                    [6.7, 3.0, 5.2, 2.3]]}}]),
    "mab": ({"name": "eg-router", "type": "ROUTER",
             "children": [{"name": "model-a", "type": "MODEL"},
                          {"name": "model-b", "type": "MODEL"}]},
            {"eg-router": (_eg, "ROUTER"),
             "model-a": (lambda: _mlp(64, 0), "MODEL"),
             "model-b": (lambda: _mlp(96, 1), "MODEL")},
            [{"data": {"ndarray": _IMG.tolist()}}] * 6),
    "ensemble": ({"name": "combiner", "type": "COMBINER",
                  "implementation": "AVERAGE_COMBINER",
                  "children": [{"name": f"member-{i}", "type": "MODEL"}
                               for i in range(3)]},
                 {f"member-{i}": (lambda i=i: _mlp(64, i), "MODEL")
                  for i in range(3)},
                 [{"data": {"ndarray": _IMG.tolist()}}]),
    "llm": ({"name": "llm", "type": "MODEL"}, {"llm": (_llm, "MODEL")},
            [{"jsonData": {"prompt_ids": [3, 1, 4, 1, 5, 9, 2], "n_new": 5}},
             {"jsonData": {"prompt_ids": [], "n_new": 3}},
             {"jsonData": {"prompt_ids": list(range(1, 40))}}]),
}
FEEDBACK = {"response": {"meta": {"routing": {"eg-router": 1}}},
            "reward": 1.0}


def _with_endpoints(graph, ports):
    g = dict(graph)
    if g["name"] in ports:
        g["endpoint"] = {"service_host": "127.0.0.1",
                         "service_port": ports[g["name"]], "type": "REST"}
    g["children"] = [_with_endpoints(c, ports) for c in g.get("children", [])]
    return g


async def _stacks(name):
    """Start both stacks for ``GRAPHS[name]``; ``(ref engine port, port
    engine port, stop)``."""
    graph, nodes, _ = GRAPHS[name]
    jports, tports, closers = {}, {}, []
    for node, (factory, stype) in nodes.items():
        jobj, tobj = factory()
        runner = await start_server(build_app(component=JHandle(
            jobj, name=node, service_type=stype)), "127.0.0.1", 0)
        server = await RestServer(component=THandle(
            tobj, name=node, service_type=stype), host="127.0.0.1",
            port=0).start()
        jports[node], tports[node] = runner.addresses[0][1], server.port
        closers += [server.stop, runner.cleanup]
        if name == "llm":
            closers.append(lambda t=tobj: asyncio.to_thread(t.engine.close))

    def jresolve(unit):
        return JRemote(f"http://127.0.0.1:{jports[unit.name]}",
                       name=unit.name)

    jeng = JEngine(graph, resolver=jresolve, name="main",
                   metrics_sink=JMetrics(deployment=name))
    jrunner = await start_server(build_app(engine=jeng), "127.0.0.1", 0)
    dep = {"spec": {"name": name, "annotations": {"seldon.io/batching":
                                                  "false"},
                    "predictors": [{"name": "main", "graph":
                                    _with_endpoints(graph, tports)}]}}
    tserver, _ = await serve(dep, port=0, host="127.0.0.1", device="cpu")
    closers = [tserver.stop, jrunner.cleanup] + closers

    async def stop():
        for c in closers:
            await c()

    return jrunner.addresses[0][1], tserver.port, stop


def _canon(body):
    if isinstance(body, dict):
        meta = body.get("meta", {})
        meta.pop("puid", None)
        for m in meta.get("metrics", []):
            m.pop("value")  # latencies
    return body


def _same(j, t):
    (jc, jb), (tc, tb) = j, t
    assert tc == jc, (jb, tb)
    jb, tb = _canon(jb), _canon(tb)
    if "data" in jb:
        np.testing.assert_allclose(np.asarray(tb["data"]["ndarray"]),
                                   np.asarray(jb["data"]["ndarray"]),
                                   atol=ATOL)
        assert tb["data"]["names"] == jb["data"]["names"]
        jb.pop("data"), tb.pop("data")
    if "jsonData" in jb:
        assert tb["jsonData"]["ids"] == jb["jsonData"]["ids"]
        jb, tb = jb["status"], tb["status"]
    assert tb == jb


@pytest.mark.parametrize("name", ["iris", "mab", "ensemble"])
def test_engine_over_remote_components_answers_like_the_reference(name):
    _, _, bodies = GRAPHS[name]

    async def run():
        jp, tp, stop = await _stacks(name)
        try:
            out = []
            for i, body in enumerate(bodies):
                if name == "mab" and i == 3:
                    for _ in range(4):  # reward branch 1 through the wire
                        out.append((await asyncio.to_thread(
                            _post, jp, "/api/v0.1/feedback", FEEDBACK),
                            await asyncio.to_thread(
                            _post, tp, "/api/v0.1/feedback", FEEDBACK)))
                out.append((await asyncio.to_thread(
                    _post, jp, "/api/v0.1/predictions", body),
                    await asyncio.to_thread(
                    _post, tp, "/api/v0.1/predictions", body)))
            return out
        finally:
            await stop()

    answers = _run(run())
    for j, t in answers:
        _same(j, t)
    assert all(t[0] == 200 for _, t in answers)
    if name == "mab":
        routes = [t[1]["meta"]["routing"]["eg-router"] for _, t in answers
                  if "meta" in t[1]]
        assert set(routes) == {0, 1}
        assert [t[1]["meta"]["requestPath"] for _, t in answers
                if "meta" in t[1]][0]["eg-router"] == "RemoteComponent"


def test_llm_over_a_remote_component_streams_the_reference_ids():
    """Predictions and the stream through the engine's remote LLM node:
    greedy ids EQUAL (the empty prompt's too, HTTP 200 with 3 tokens)."""
    _, _, bodies = GRAPHS["llm"]

    async def run():
        jp, tp, stop = await _stacks("llm")
        try:
            out = []
            for path in ("/api/v0.1/predictions", "/api/v0.1/stream"):
                for body in bodies:
                    out.append((path, await asyncio.to_thread(
                        _post, jp, path, body),
                        await asyncio.to_thread(_post, tp, path, body)))
            return out
        finally:
            await stop()

    answers = _run(run())
    for path, j, t in answers:
        if path.endswith("stream"):
            (jc, jev), (tc, tev) = j, t
            assert tc == jc == 200
            assert [e.get("token") for e in tev] == \
                [e.get("token") for e in jev]
            assert tev[-1]["done"] and tev[-1]["ids"] == jev[-1]["ids"]
        else:
            _same(j, t)
    empty = [t for p, _, t in answers if p.endswith("stream")][1]
    assert len(empty[1]) == 4 and empty[1][-1]["prompt_len"] == 0


# ---- cross-wire -------------------------------------------------------------

def test_clients_and_servers_of_the_two_packages_interoperate():
    """The reference's RemoteComponent against the port's component server
    and the port's against the reference's: every method answers as on
    its own pair, the binTensor encoding included (the reference's client
    takes it as ``encoding=``, the port's from the message)."""
    x = np.random.default_rng(1).normal(size=(3, 2)).astype(np.float32)

    async def calls(client, msg_cls, fb_cls, enc):
        msg = msg_cls.from_ndarray(x, names=["p", "q"], encoding=enc)
        out = [await client.predict(msg), await client.transform_input(msg),
               await client.transform_output(msg),
               await client.aggregate([msg, msg])]
        routes = [await client.route(msg),
                  await client.route(msg_cls.from_ndarray(-np.abs(x),
                                                          encoding=enc))]
        fb = await client.send_feedback(fb_cls(request=msg, reward=1.0))
        return [o.to_dict() for o in out], routes, fb.to_dict()

    async def run():
        jsrv = await start_server(build_app(component=JHandle(
            _Echo(), name="echo")), "127.0.0.1", 0)
        tsrv = await RestServer(component=THandle(_Echo(), name="echo"),
                                host="127.0.0.1", port=0).start()
        jurl = f"http://127.0.0.1:{jsrv.addresses[0][1]}"
        turl = f"http://127.0.0.1:{tsrv.port}"
        try:
            res = {}
            for enc in ("ndarray", "binTensor"):
                for cname, ccls, mcls, fcls in (
                        ("ref", JRemote, JMessage, JFeedback),
                        ("port", RemoteComponent, TMessage, TFeedback)):
                    for sname, url in (("ref", jurl), ("port", turl)):
                        c = ccls(url, name="echo", **(
                            {"encoding": enc} if cname == "ref" else {}))
                        res[enc, cname, sname] = await calls(c, mcls, fcls,
                                                             enc)
                        await c.close()
            return res
        finally:
            await tsrv.stop()
            await jsrv.cleanup()

    res = _run(run())
    for enc in ("ndarray", "binTensor"):
        want = res[enc, "ref", "ref"]
        for key in (("ref", "port"), ("port", "ref"), ("port", "port")):
            assert res[(enc,) + key] == want, (enc, key)


class _Doubler:
    """A message-level model that records the encoding each request came
    in and answers in it; ``msg_cls`` is the package's message class."""

    accepts_messages = True

    def __init__(self, msg_cls):
        self.msg_cls = msg_cls
        self.seen = []

    def predict(self, msg):
        data = np.asarray(msg.data)
        self.seen.append((msg.encoding, str(data.dtype)))
        return self.msg_cls(data=data * 2, names=list(msg.names),
                            encoding=msg.encoding)


@pytest.mark.parametrize("enc", ["ndarray", "binTensor"])
def test_endpoint_hop_keeps_the_request_encoding(enc):
    """A request through the port's runner to an endpoint node crosses the
    hop in the encoding it arrived with (the reference's hop is always
    ndarray): the component sees a float32 binTensor as such, and the
    runner answers what the reference's graph answers with the component
    in process, bytes of the binTensor included."""
    x = np.random.default_rng(7).normal(size=(2, 3)).astype(np.float32)
    msg = TMessage.from_ndarray(x, names=["a", "b", "c"], encoding=enc)
    body = msg.to_dict()

    async def run():
        comp = _Doubler(TMessage)
        server = await RestServer(component=THandle(comp, name="d"),
                                  host="127.0.0.1", port=0).start()
        dep = {"spec": {"name": "hop", "predictors": [{
            "name": "main", "graph": {
                "name": "d", "type": "MODEL", "endpoint": {
                    "service_host": "127.0.0.1",
                    "service_port": server.port, "type": "REST"}}}]}}
        runner, _ = await serve(dep, port=0, host="127.0.0.1", device="cpu")
        try:
            got = await asyncio.to_thread(_post, runner.port,
                                          "/api/v0.1/predictions", body)
        finally:
            await runner.stop()
            await server.stop()
        jeng = JEngine({"name": "d", "type": "MODEL"}, resolver=lambda u:
                       JHandle(_Doubler(JMessage), name="d"))
        want = (await jeng.predict(JMessage.from_dict(body))).to_dict()
        return got, want, comp.seen

    (code, got), want, seen = _run(run())
    assert code == 200
    assert seen == [(enc, "float32" if enc == "binTensor" else "float64")]
    assert list(got["data"]) == ["names", enc]
    assert got["data"] == want["data"]
    assert got["status"] == want["status"]


@pytest.mark.parametrize("meta_only", [False, True])
def test_route_meta_only_sends_what_the_reference_sends(meta_only):
    """``route_meta_only`` on the port's client and the reference's: a
    remote router receives the same message (no tensor when on) and both
    take the same branch."""
    x = np.random.default_rng(3).normal(size=(2, 2)).astype(np.float32)

    class Router:
        accepts_messages = True

        def __init__(self):
            self.seen = []

        def route(self, msg):
            self.seen.append(
                (None if msg.data is None else np.asarray(msg.data).tolist(),
                 list(msg.names), dict(msg.meta.tags)))
            return 1

    async def run():
        out = {}
        for cname, ccls, mcls in (("ref", JRemote, JMessage),
                                  ("port", RemoteComponent, TMessage)):
            router = Router()
            server = await RestServer(component=THandle(router, name="r"),
                                      host="127.0.0.1", port=0).start()
            c = ccls(f"http://127.0.0.1:{server.port}", name="r",
                     route_meta_only=meta_only)
            try:
                m = mcls.from_ndarray(x, names=["p", "q"])
                m.meta.tags["k"] = "v"
                branch = await c.route(m)
            finally:
                await c.close()
                await server.stop()
            out[cname] = (branch, router.seen)
        return out

    out = _run(run())
    assert out["port"] == out["ref"]
    assert out["port"][0] == 1
    assert (out["port"][1][0][0] is None) == meta_only


class _Echo:
    class_names = ["a", "b"]

    def predict(self, X, names):
        return np.asarray(X) * 2.0

    def transform_input(self, X, names):
        return np.asarray(X) + 1.0

    def transform_output(self, X, names):
        return -np.asarray(X)

    def route(self, X, names):
        return int(np.asarray(X).sum() > 0)

    def aggregate(self, Xs, names_list):
        return np.mean([np.asarray(x) for x in Xs], axis=0)

    def tags(self):
        return {"v": 1}


class _Slow:
    accepts_messages = True  # the handle forwards the message itself

    def __init__(self, delay):
        self.delay = delay

    async def predict(self, msg):
        await asyncio.sleep(self.delay)
        return msg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_errors_map_like_the_reference():
    """A remote FAILURE keeps its code and reason; a refused connection is
    503 TRANSPORT; a reply past the read timeout 504 DEADLINE_EXCEEDED; a
    component without a stream route 501 STREAM_UNSUPPORTED."""
    class Refuse:
        def predict(self, X, names):
            raise ValueError("nope")

    async def run():
        jsrv = await start_server(build_app(component=JHandle(
            Refuse(), name="r")), "127.0.0.1", 0)
        slow = THandle(_Slow(2.0), name="slow")
        tsrv = await RestServer(component=slow, host="127.0.0.1",
                                port=0).start()
        dead = f"http://127.0.0.1:{_free_port()}"
        out = {}
        try:
            for cname, ccls, err in (("ref", JRemote, JComponentError),
                                     ("port", RemoteComponent,
                                      SeldonComponentError)):
                msg = (JMessage if cname == "ref" else TMessage).from_ndarray(
                    np.ones((1, 2)))
                cases = {
                    "failure": ccls(f"http://127.0.0.1:"
                                    f"{jsrv.addresses[0][1]}"),
                    "refused": ccls(dead),
                    "slow": ccls(f"http://127.0.0.1:{tsrv.port}",
                                 timeout_s=0.3),
                }
                for case, c in cases.items():
                    try:
                        await c.predict(msg)
                        out[cname, case] = None
                    except err as e:
                        out[cname, case] = (e.status_code, e.reason)
                    await c.close()
                try:
                    agen = ccls(f"http://127.0.0.1:{jsrv.addresses[0][1]}"
                                ).stream(msg)
                    await agen.__anext__()
                except err as e:
                    out[cname, "stream"] = (e.status_code, e.reason)
            return out
        finally:
            await tsrv.stop()
            await jsrv.cleanup()

    out = _run(run())
    for case in ("failure", "refused", "slow", "stream"):
        assert out["port", case] == out["ref", case], case
    assert out["port", "failure"] == (500, "")
    assert out["port", "refused"] == (503, "TRANSPORT")
    assert out["port", "slow"] == (504, "DEADLINE_EXCEEDED")
    assert out["port", "stream"] == (501, "STREAM_UNSUPPORTED")


def test_external_client_calls_the_engine_api():
    async def run():
        server = await RestServer(_EchoEngine(), host="127.0.0.1",
                                  port=0).start()
        client = ExternalClient(f"http://127.0.0.1:{server.port}")
        try:
            out = await client.predict(TMessage.from_ndarray(np.ones((1, 2))))
            fb = await client.send_feedback(TFeedback(reward=2.0))
            return out, fb
        finally:
            await client.close()
            await server.stop()

    out, fb = _run(run())
    assert out.host_data().tolist() == [[1.0, 1.0]]
    assert fb.status.status == "SUCCESS"


class _EchoEngine:
    async def predict(self, msg):
        return msg

    async def send_feedback(self, fb):
        return TMessage(status=TStatus())
