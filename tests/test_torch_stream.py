"""The port's ``POST /api/v0.1/stream`` route against the JAX reference's on
the CPU.

- The same greedy request to the reference's ``EngineServer`` and to the
  port's ``RestServer``, each serving an LLM graph with the same weights,
  gives the same token events and the same ids in the ``done`` event (the
  latency fields differ).
- The stream is incremental (the first event arrives while the request
  still holds its slot), stop tokens end it, and a speculative engine
  streams the ids its ``/predictions`` answers.
- A client that closes its connection mid-stream frees the slot and pages.
- A bad request answers JSON with the reference's status before any
  event; an error mid-stream sends an ``error`` event; a graph that is not
  a single streaming node answers 501 ``STREAM_UNSUPPORTED``.
"""

import asyncio
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine import GraphEngine as JGraphEngine
from seldon_core_tpu.models import transformer as jtf
from seldon_core_tpu.runtime import llm as jllm
from seldon_core_tpu.runtime import paged as jpaged
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime import paged as tpaged
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.serving.rest import RestServer
from seldon_core_tpu_torch.utils.tracing import request_records

_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **_KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **_KW)
JP = jtf.init_params(jax.random.PRNGKey(0), JCFG)
TP = convert.params_from_jax(jax.tree.map(np.asarray, JP))
LLM_NODE = {"name": "llm", "type": "MODEL"}


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 256, size=n).tolist()


def _port_graph(graph=None, **kw):
    """A port GraphEngine over a paged LLM node, and its engine."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 32)
    eng = tllm.PagedLLMEngine(TP, TCFG, tpaged.PagedConfig(33, 4), **kw)
    handle = ComponentHandle(tllm.LLMComponent(eng, n_new=6), name="llm")
    return GraphEngine(graph or LLM_NODE, resolver=lambda u: handle), eng


def _http(port, body, path="/api/v0.1/stream"):
    """POST ``body`` (a dict, or raw bytes); ``(status, events or error
    JSON)``.  urllib reads the reference's chunked response and the
    port's close-delimited one alike."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read().decode()
            if path.endswith("/stream"):
                assert r.headers["Content-Type"] == "text/event-stream"
                return r.status, [json.loads(ln[6:])
                                  for ln in raw.split("\n\n")
                                  if ln.startswith("data: ")]
            return r.status, json.loads(raw)
    except urllib.error.HTTPError as e:
        assert e.headers["Content-Type"].startswith("application/json")
        return e.code, json.loads(e.read())


async def _port_server(engine):
    return await RestServer(engine, host="127.0.0.1", port=0).start()


async def _open_stream(port, body):
    """A raw client: send the request, read the status line and headers;
    returns ``(status, reader, writer)``."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    w.write(b"POST /api/v0.1/stream HTTP/1.1\r\nHost: t\r\n"
            b"Content-Type: application/json\r\n"
            + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await w.drain()
    status = int((await r.readline()).split()[1])
    while (await r.readline()) not in (b"\r\n", b""):
        pass
    return status, r, w


async def _next_event(r):
    while True:
        line = await r.readline()
        if not line:
            return None
        if line.startswith(b"data: "):
            return json.loads(line[6:])


def test_stream_events_equal_reference_route():
    jeng = jllm.PagedLLMEngine(JP, JCFG, jpaged.PagedConfig(33, 4),
                               max_slots=2, max_len=32)
    jgraph = JGraphEngine(LLM_NODE, resolver=lambda u: JHandle(
        jllm.LLMComponent(jeng, n_new=6), name="llm"))
    graph, eng = _port_graph()
    body = {"jsonData": {"prompt_ids": _prompt(7, 1), "n_new": 9}}

    async def run():
        runner = await start_server(build_app(engine=jgraph), "127.0.0.1", 0)
        server = await _port_server(graph)
        try:
            want = await asyncio.to_thread(_http, runner.addresses[0][1],
                                           body)
            got = await asyncio.to_thread(_http, server.port, body)
            preds = await asyncio.to_thread(_http, server.port, body,
                                            "/api/v0.1/predictions")
            return want, got, preds
        finally:
            await server.stop()
            await runner.cleanup()

    (wc, want), (gc, got), (pc, pred) = asyncio.run(run())
    eng.close()
    assert wc == gc == pc == 200
    assert got[:-1] == want[:-1]  # {"token": t, "i": i} per token
    assert [e["i"] for e in got[:-1]] == list(range(9))
    done, wdone = got[-1], want[-1]
    assert done["done"] is True and done["ids"] == wdone["ids"]
    assert done["ids"] == pred["jsonData"]["ids"]
    for key in ("prompt_len", "n_generated"):
        assert done[key] == wdone[key]
    assert {m["key"] for m in done["metrics"]} == {
        m["key"] for m in wdone["metrics"]}
    ref = jtf.generate(JP, jnp.asarray(body["jsonData"]["prompt_ids"])[None],
                       9, JCFG)
    assert done["ids"] == np.asarray(ref)[0].tolist()


def test_stream_is_incremental_and_stops_on_stop_token():
    graph, eng = _port_graph()
    p = _prompt(6, 2)
    ids = np.asarray(jtf.generate(JP, jnp.asarray(p)[None], 12, JCFG))[0]
    stop = int(ids[6 + 4])

    async def run():
        server = await _port_server(graph)
        try:
            status, r, w = await _open_stream(
                server.port, {"jsonData": {"prompt_ids": p, "n_new": 12}})
            assert status == 200
            first = await _next_event(r)
            # the request still holds its slot: the event came mid-request
            assert first == {"token": int(ids[6]), "i": 0}
            assert len(eng._slots) == 1
            events = [first]
            while (ev := await _next_event(r)) is not None:
                events.append(ev)
            w.close()
            _, stopped = await asyncio.to_thread(_http, server.port, {
                "jsonData": {"prompt_ids": p, "n_new": 12, "stop": [stop]}})
            return events, stopped
        finally:
            await server.stop()

    events, stopped = asyncio.run(run())
    eng.close()
    assert [e["token"] for e in events[:-1]] == ids[6:].tolist()
    first_stop = ids[6:].tolist().index(stop)
    assert [e["token"] for e in stopped[:-1]] == \
        ids[6:6 + first_stop + 1].tolist()
    assert stopped[-1]["n_generated"] == first_stop + 1
    assert not eng._slots and eng.free_pages == 32


def test_abandoned_stream_frees_its_slot_and_pages():
    graph, eng = _port_graph()
    t0 = time.perf_counter()

    async def run():
        server = await _port_server(graph)
        try:
            status, r, w = await _open_stream(
                server.port,
                {"jsonData": {"prompt_ids": _prompt(5, 3), "n_new": 24}})
            assert status == 200
            assert "token" in await _next_event(r)
            assert len(eng._slots) == 1 and eng.free_pages < 32
            w.close()
            t0 = time.monotonic()
            while (eng._slots or eng.free_pages != 32) and \
                    time.monotonic() - t0 < 10:
                await asyncio.sleep(0.01)
            return eng.free_pages, dict(eng._slots), len(eng._free)
        finally:
            await server.stop()

    free, slots, free_slots = asyncio.run(run())
    eng.close()
    assert free == 32 and not slots and free_slots == 2
    # the generation was cut short: its request ended cancelled, far
    # fewer than its 24 tokens emitted
    reqs = [r for r in request_records(t0) if r.engine == eng.engine_id]
    assert [r.outcome for r in reqs] == ["cancelled"]
    assert reqs[0].tokens < 24


def test_bad_requests_answer_json_like_the_reference():
    """Before the first event: a malformed body (400), a prompt over
    max_len and a request without ``prompt_ids`` (the reference answers
    500 with the error) answer JSON with the reference's status.  An empty
    prompt is no error: both stream its 3 tokens (the prefill of an empty
    prompt is a bucket of pad ids) and answer 200 with the same ids."""
    jeng = jllm.LLMEngine(JP, JCFG, max_slots=2, max_len=32)
    jgraph = JGraphEngine(LLM_NODE, resolver=lambda u: JHandle(
        jllm.LLMComponent(jeng, n_new=6), name="llm"))
    graph, eng = _port_graph()
    bodies = [b"{not json", {"jsonData": {"prompt_ids": _prompt(30, 1),
                                         "n_new": 9}},
              {"jsonData": {"n_new": 3}},
              {"jsonData": {"prompt_ids": [], "n_new": 3}}]

    async def run():
        runner = await start_server(build_app(engine=jgraph), "127.0.0.1", 0)
        server = await _port_server(graph)
        try:
            out = []
            for b in bodies:
                out.append((await asyncio.to_thread(
                    _http, runner.addresses[0][1], b),
                    await asyncio.to_thread(_http, server.port, b)))
            return out
        finally:
            await server.stop()
            await runner.cleanup()

    answers = asyncio.run(run())
    eng.close()
    (wc, want), (gc, got) = answers.pop()
    assert gc == wc == 200 and len(got) == len(want) == 4
    assert [e.get("token") for e in got] == [e.get("token") for e in want]
    assert got[-1]["ids"] == want[-1]["ids"] and got[-1]["prompt_len"] == 0
    for (wc, want), (gc, got) in answers:
        assert gc == wc and 400 <= gc < 600
        assert got["status"]["status"] == "FAILURE"
        assert got["status"]["code"] == want["status"]["code"]
    assert answers[0][1][0] == 400
    assert "exceeds max_len" in answers[1][1][1]["status"]["info"]
    assert not eng._slots and eng.free_pages == 32


def test_not_streamable_graphs_answer_501():
    """A graph whose root is a router over LLM nodes, or a built-in model,
    and an engine without ``stream``: JSON 501 STREAM_UNSUPPORTED."""
    router = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
              "children": [LLM_NODE]}
    builtin = {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}
    routed, eng = _port_graph(router)

    class PredictOnly:
        async def predict(self, msg):
            return msg

    async def run():
        out = []
        for engine in (routed, GraphEngine(builtin), PredictOnly()):
            server = await _port_server(engine)
            try:
                out.append(await asyncio.to_thread(_http, server.port, {
                    "jsonData": {"prompt_ids": [1, 2], "n_new": 2}}))
            finally:
                await server.stop()
        return out

    for code, body in asyncio.run(run()):
        assert code == 501
        assert body["status"]["reason"] == "STREAM_UNSUPPORTED"
    eng.close()


def test_error_mid_stream_sends_an_error_event():
    class Flaky:
        def stream(self, msg):
            async def gen():
                yield {"token": 1, "i": 0}
                raise RuntimeError("device lost")

            return gen()

        async def predict(self, msg):
            return msg

    async def run():
        server = await _port_server(Flaky())
        try:
            return await asyncio.to_thread(_http, server.port,
                                           {"jsonData": {}})
        finally:
            await server.stop()

    code, events = asyncio.run(run())
    assert code == 200
    assert events == [{"token": 1, "i": 0},
                      {"error": "RuntimeError: device lost"}]


@pytest.mark.parametrize("graph_file", ["llm.json", "llm-slab.json"])
def test_local_runner_streams_what_it_predicts(graph_file, tmp_path):
    """The example graphs booted by the local runner on the CPU, with a
    speculative draft (the served model itself): the stream's ids equal
    the same request's ``/predictions`` ids."""
    from pathlib import Path

    from seldon_core_tpu_torch.operator.local import serve

    path = (Path(__file__).resolve().parent.parent / "seldon_core_tpu_torch"
            / "examples" / graph_file)
    body = {"jsonData": {"prompt_ids": _prompt(9, 4), "n_new": 7}}

    async def run():
        server, local = await serve(str(path), port=0, host="127.0.0.1",
                                    device="cpu")
        comp = local.engine.node_impl("llm").user
        eng = comp.engine
        # speculate with the served weights as their own draft
        spec_kw = dict(draft_params=eng.params, draft_cfg=eng.cfg,
                       max_slots=eng.max_slots, max_len=eng.max_len)
        if hasattr(eng, "paged_cfg"):
            comp.engine = tllm.PagedLLMEngine(eng.params, eng.cfg,
                                              eng.paged_cfg, **spec_kw)
        else:
            comp.engine = tllm.LLMEngine(eng.params, eng.cfg, **spec_kw)
        eng.close()
        try:
            s = await asyncio.to_thread(_http, server.port, body)
            p = await asyncio.to_thread(_http, server.port, body,
                                        "/api/v0.1/predictions")
            return s, p, comp.engine
        finally:
            await server.stop()

    (sc, events), (pc, pred), spec = asyncio.run(run())
    spec.close()
    assert sc == pc == 200
    ids = pred["jsonData"]["ids"]
    assert events[-1]["ids"] == ids
    assert [e["token"] for e in events[:-1]] == ids[9:]
    assert spec.spec_stats["accepted"] == spec.spec_stats["drafted"] > 0
