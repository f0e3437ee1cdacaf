"""The port's tracing (``seldon_core_tpu_torch/utils/tracing.py``) against
the reference's on the CPU.

The cases of the reference's ``tests/test_tracing.py``, each run through
both packages on the same inputs: W3C ``traceparent`` / ``tracestate``
parse and format EQUAL on valid and malformed headers; the trace id EQUAL
for the same puid; span trees with the same names, kinds and parenthood
on the walk and the fused plan; one batch span linked to each member
request; the framed wire's meta carrying the context across a hop (the
transport-side copy EQUAL to the reference's); OTLP JSON EQUAL apart from
times and span ids; tail sampling decisions and histogram exemplars
EQUAL; config messages EQUAL.  Then the port's own device-trace window
(``torch.profiler`` over CPU activity in these tests): one session per
process, a start that fails is torn down, a window closed from another
thread writes its trace.
"""

import asyncio
import json
import os
import threading

import numpy as np
import pytest

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import resolve_component as jresolve
from seldon_core_tpu.runtime.batcher import BatcherConfig as JBatcherConfig
from seldon_core_tpu.serving import framed as jframed
from seldon_core_tpu.utils import metrics as jmetrics
from seldon_core_tpu.utils import tracing as jt
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import resolve_component as tresolve
from seldon_core_tpu_torch.runtime.batcher import BatcherConfig as TBatcherConfig
from seldon_core_tpu_torch.serving import framed as tframed
from seldon_core_tpu_torch.utils import metrics as tmetrics
from seldon_core_tpu_torch.utils import tracing as tt

TIMEOUT = 120
TID = "ab" * 16
SID = "cd" * 8


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


def ctx_tuple(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled,
                                     ctx.state)


# ---- W3C context ---------------------------------------------------------

HEADERS = [
    f"00-{TID}-{SID}-01",
    f"00-{TID}-{SID}-00",
    f"  00-{TID.upper()}-{SID}-01  ",
    f"01-{TID}-{SID}-01-future",
    f"00-{TID}-{SID}-01-extra",
    "",
    "garbage",
    "00-" + "0" * 32 + f"-{SID}-01",
    f"00-{TID}-" + "0" * 16 + "-01",
    f"ff-{TID}-{SID}-01",
    f"00-short-{SID}-01",
    f"00-{TID}-{SID}-1",
    f"0g-{TID}-{SID}-01",
    None,
    123,
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_equal(header):
    assert ctx_tuple(tt.parse_traceparent(header)) == \
        ctx_tuple(jt.parse_traceparent(header))


@pytest.mark.parametrize("sampled", [True, False])
@pytest.mark.parametrize("state", [(), (("drill-id", "d7"), ("k", "v"))])
def test_traceparent_format_and_headers_equal(sampled, state):
    t = tt.TraceContext(TID, SID, sampled, state)
    j = jt.TraceContext(TID, SID, sampled, state)
    assert tt.format_traceparent(t) == jt.format_traceparent(j)
    assert tt.trace_headers(t) == jt.trace_headers(j)
    h = jt.trace_headers(j)
    assert ctx_tuple(tt.trace_from_headers(h)) == \
        ctx_tuple(jt.trace_from_headers(h))
    assert tt.trace_headers(None) == jt.trace_headers(None) == {}
    # a context without a span gets a fresh span id in both
    fresh = tt.format_traceparent(tt.TraceContext(TID, "", sampled))
    assert tt.parse_traceparent(fresh).trace_id == TID


@pytest.mark.parametrize("raw", ["a=1,b=2", " a = 1 , ,bad, c=3 ",
                                 ",".join(f"k{i}=v" for i in range(40))])
def test_tracestate_parse_equal(raw):
    h = {"traceparent": f"00-{TID}-{SID}-01", "tracestate": raw}
    assert ctx_tuple(tt.trace_from_headers(h)) == \
        ctx_tuple(jt.trace_from_headers(h))


@pytest.mark.parametrize("tags", [
    {"trace-id": TID, "trace-flags": "00", "trace-state": "a=1"},
    {"trace-parent": f"00-{TID}-{SID}-01", "trace-state": "x=y"},
    {"trace-parent": "junk", "trace-id": TID},
    {"trace-id": "nothex"},
    {},
])
def test_trace_from_meta_and_stamp_equal(tags):
    t, j = TMessage(), JMessage()
    t.meta.tags.update(tags)
    j.meta.tags.update(tags)
    tc, jc = tt.trace_from_meta(t.meta), jt.trace_from_meta(j.meta)
    assert ctx_tuple(tc) == ctx_tuple(jc)
    t2, j2 = TMessage(), JMessage()
    tt.stamp_trace_meta(t2.meta, tc)
    jt.stamp_trace_meta(j2.meta, jc)
    assert t2.meta.tags == j2.meta.tags


@pytest.mark.parametrize("puid", [TID, "12" * 16, "not-a-puid", ""])
def test_trace_id_equal_for_the_same_puid(puid):
    tc = tt.Tracer().new_context(trace_hint=puid)
    jc = jt.Tracer().new_context(trace_hint=puid)
    if jt._is_hex(puid, 32):
        assert tc.trace_id == jc.trace_id == puid
    else:  # both mint a random 128-bit id
        assert len(tc.trace_id) == len(jc.trace_id) == 32


# ---- span trees through the engines ---------------------------------------

COMBINER = {"name": "combiner", "implementation": "AVERAGE_COMBINER",
            "type": "COMBINER",
            "children": [{"name": "m1", "implementation": "SIMPLE_MODEL"},
                         {"name": "m2", "implementation": "SIMPLE_MODEL"}]}
ROUTER = {"name": "router", "implementation": "RANDOM_ABTEST",
          "type": "ROUTER", "parameters": [
              {"name": "ratioA", "value": "1.0", "type": "FLOAT"}],
          "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                       {"name": "b", "implementation": "SIMPLE_MODEL"}]}


def tree(d):
    """Names, kinds and parenthood of a span dict, without ids or times."""
    return (d["name"], d["kind"],
            sorted(tree(c) for c in d.get("children", ())))


def parented(d, parent=None):
    """Every span's parent span id is its parent's span id."""
    if parent is not None:
        assert d["parent_span_id"] == parent["span_id"]
        assert d["trace_id"] == parent["trace_id"]
    for c in d.get("children", ()):
        parented(c, d)


@pytest.mark.parametrize("graph", [COMBINER, ROUTER],
                         ids=["combiner", "router"])
@pytest.mark.parametrize("mode", ["walk", "fused"])
def test_span_trees_equal(graph, mode):
    outs = {}
    for side, Engine, Msg in (("port", TEngine, TMessage),
                              ("ref", JEngine, JMessage)):
        tracer = (tt if side == "port" else jt).Tracer()
        eng = Engine(graph, name="p", plan_mode=mode, tracer=tracer)
        m = Msg.from_ndarray(np.ones((1, 2)))
        m.meta.puid = TID
        out = run(eng.predict(m))
        assert out.status.status == "SUCCESS"
        root = tracer.get(TID).to_dict()
        parented(root)
        outs[side] = (tree(root), root["trace_id"], out.meta.tags)
    assert outs["port"] == outs["ref"]
    assert outs["port"][1] == TID


def test_remote_parent_and_concurrent_contexts_equal():
    """A bound inbound context parents the root span; concurrent requests
    under distinct contexts keep their own trace ids (contextvars do not
    bleed across tasks)."""
    tids = [f"{i:032x}" for i in range(1, 7)]
    res = {}
    for side, Engine, Msg, t in (("port", TEngine, TMessage, tt),
                                 ("ref", JEngine, JMessage, jt)):
        tracer = t.Tracer()
        eng = Engine({"name": "m", "implementation": "SIMPLE_MODEL"},
                     tracer=tracer)

        async def one(tid, eng=eng, Msg=Msg, t=t):
            with t.trace_scope(t.TraceContext(tid, SID, True)):
                return await eng.predict(Msg.from_ndarray(np.ones((1, 2))))

        async def drive(one=one):
            return await asyncio.gather(*(one(x) for x in tids))

        outs = run(drive())
        got = []
        for tid, out in zip(tids, outs):
            root = tracer.get(out.meta.puid)
            got.append((out.meta.tags["trace-id"], root.trace_id,
                        root.parent_span_id))
        res[side] = got
    assert res["port"] == res["ref"] == [(x, x, SID) for x in tids]


def test_batch_span_links_to_each_member():
    """One coalesced batch serves N traces: one batch span, linked (not
    parented) to every member's context."""
    tids = [f"{i:032x}" for i in range(1, 7)]
    spec = {"name": "m0", "type": "MODEL", "parameters": [
        {"name": "model_class", "type": "STRING", "value": None},
        {"name": "hidden", "value": "32", "type": "INT"}]}
    res = {}
    for side in ("port", "ref"):
        t = tt if side == "port" else jt
        s = json.loads(json.dumps(spec))
        s["parameters"][0]["value"] = (
            "seldon_core_tpu_torch.models.mlp:MNISTMLP" if side == "port"
            else "seldon_core_tpu.models.mlp:MNISTMLP")
        tracer = t.Tracer(collector=t.SpanCollector(service="engine"))
        if side == "port":
            eng = TEngine(s, resolver=lambda u: tresolve(
                u, {"seldon.io/batching": "false"}, "cpu"),
                name="p", plan_mode="fused", tracer=tracer,
                plan_batcher=TBatcherConfig(max_batch_size=8,
                                            max_delay_ms=25.0))
            Msg = TMessage
        else:
            eng = JEngine(s, resolver=lambda u: jresolve(
                u, {"seldon.io/batching": "false"}),
                name="p", plan_mode="fused", tracer=tracer,
                plan_batcher=JBatcherConfig(max_batch_size=8,
                                            max_delay_ms=25.0))
            Msg = JMessage
        rng = np.random.default_rng(0)

        async def one(tid, eng=eng, Msg=Msg, rng=rng):
            m = Msg.from_ndarray(rng.normal(size=(1, 784)).astype(
                np.float32))
            m.meta.puid = tid
            return await eng.predict(m)

        async def drive(one=one):
            return await asyncio.gather(*(one(x) for x in tids))

        outs = run(drive())
        assert all(o.status.status == "SUCCESS" for o in outs)
        batches = [r for r in tracer.collector.query(n=100)
                   if r["root"]["name"].startswith("batch:")]
        assert len(batches) == 1
        root = batches[0]["root"]
        res[side] = (sorted(ln["trace_id"] for ln in root["links"]),
                     sorted({ln["attributes"]["kind"]
                             for ln in root["links"]}),
                     {k: root["attributes"][k] for k in
                      ("rows", "bucket", "n_requests", "pad_rows")})
        # each link points at the member's segment span
        for rec in tracer.collector.query(n=100):
            if rec["root"]["name"] == "predict":
                seg = rec["root"]["children"][0]
                assert {"trace_id": rec["trace_id"],
                        "span_id": seg["span_id"],
                        "attributes": {"kind": "batched-request"}} \
                    in root["links"]
    assert res["port"] == res["ref"]
    assert res["port"][0] == tids


# ---- hops ------------------------------------------------------------------


@pytest.mark.parametrize("state", [(), (("drill-id", "d1"),)])
def test_framed_transport_copy_equal(state):
    """The framed client's transport-side copy carries the full
    traceparent (and tracestate) in ``meta.tags``, as the reference's
    does, and leaves the caller's message alone; the server side binds it
    and strips the transport tag."""
    t, j = TMessage.from_ndarray(np.ones((1, 2))), \
        JMessage.from_ndarray(np.ones((1, 2)))
    for m in (t, j):
        m.meta.puid = TID
        m.meta.tags["x"] = "y"
    with tt.trace_scope(tt.TraceContext(TID, SID, True, state)):
        tc = tframed._traced_copy(t)
    with jt.trace_scope(jt.TraceContext(TID, SID, True, state)):
        jc = jframed._traced_copy(j)
    assert tc.meta.to_dict() == jc.meta.to_dict()
    assert t.meta.tags == {"x": "y"}
    assert tframed._traced_copy(t) is t  # no context: no copy
    with tframed._bind_trace(tc):
        assert ctx_tuple(tt.current_trace()) == (TID, SID, True, state)
    assert "trace-parent" not in tc.meta.tags


def test_framed_hop_parents_the_remote_root():
    """Across a real framed hop, the remote engine's root span is a child
    of the caller's span, in the caller's trace."""
    tracer = tt.Tracer()
    eng = TEngine({"name": "m", "implementation": "SIMPLE_MODEL"},
                  tracer=tracer)

    async def call():
        async with tframed.AsyncFramedComponentServer(eng) as srv:
            c = await tframed.AsyncFramedClient(timeout=30).connect(
                "127.0.0.1", srv.port)
            try:
                with tt.trace_scope(tt.TraceContext(TID, SID, True)):
                    return await c.predict(
                        TMessage.from_ndarray(np.ones((1, 2))))
            finally:
                c.close()

    out = run(call())
    assert out.meta.tags["trace-id"] == TID
    assert "trace-parent" not in out.meta.tags
    root = tracer.get(out.meta.puid)
    assert root.trace_id == TID and root.parent_span_id == SID


def test_rest_hop_carries_trace_headers():
    """``RemoteComponent`` sends the ambient context as ``traceparent``
    and ``tracestate`` on every call."""
    from seldon_core_tpu_torch.serving.client import RemoteComponent

    seen = []

    async def handle(reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode().split("\r\n")[1:]
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in lines if ln)}
        await reader.readexactly(int(hdrs["content-length"]))
        seen.append(hdrs)
        body = json.dumps({"data": {"ndarray": [[1.0]]}}).encode()
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                     b"\r\nContent-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        await writer.drain()
        writer.close()

    async def call():
        srv = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        rc = RemoteComponent(f"http://127.0.0.1:{port}")
        try:
            with tt.trace_scope(tt.TraceContext(TID, SID, True,
                                                (("a", "1"),))):
                await rc.predict(TMessage.from_ndarray(np.ones((1, 1))))
            await rc.predict(TMessage.from_ndarray(np.ones((1, 1))))
        finally:
            await rc.close()
            srv.close()

    run(call())
    assert seen[0]["traceparent"] == f"00-{TID}-{SID}-01"
    assert seen[0]["tracestate"] == "a=1"
    assert "traceparent" not in seen[1]


# ---- export, sampling, exemplars, config --------------------------------


def build_tree(t):
    """The same small span tree through a module's tracer."""
    tracer = t.Tracer(collector=t.SpanCollector(service="engine"))
    with t.trace_scope(t.TraceContext(TID, SID, True, (("drill-id", "d"),))):
        with tracer.trace("p1", graph="g", replica="r0") as root:
            root.add_event("degraded", reason="breaker")
            with tracer.span("node", kind="MODEL", rows=3, ok=True,
                             ms=1.5) as sp:
                sp.add_link("12" * 16, "34" * 8, kind="batched-request")
            with pytest.raises(ValueError):
                with tracer.span("bad", kind="ROUTER"):
                    raise ValueError("x")
    return tracer


VOLATILE = {"startTimeUnixNano", "endTimeUnixNano", "timeUnixNano",
            "spanId", "parentSpanId"}


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def test_otlp_json_equal_apart_from_times_and_span_ids():
    tp, jr = build_tree(tt), build_tree(jt)
    a = tt.otlp_trace(tp.get("p1"), "engine")
    b = jt.otlp_trace(jr.get("p1"), "engine")
    assert strip(a) == strip(b)
    rec_t, rec_j = tp.collector.query()[0], jr.collector.query()[0]
    assert {k: rec_t[k] for k in ("trace_id", "status", "kept_by",
                                  "replica", "tracestate")} == \
        {k: rec_j[k] for k in ("trace_id", "status", "kept_by", "replica",
                               "tracestate")}


def test_file_sink_rotates_as_the_reference(tmp_path):
    for t, d in ((tt, tmp_path / "port"), (jt, tmp_path / "ref")):
        sink = t.FileSpanSink(str(d / "t.jsonl"), max_bytes=300, backups=2)
        for i in range(6):
            sink.write({"i": i, "pad": "x" * 100})
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_text() == \
            (tmp_path / "ref" / n).read_text()


def test_collector_sampling_decisions_equal():
    res = {}
    for name, t in (("port", tt), ("ref", jt)):
        col = t.SpanCollector(slow_ms=10.0, max_traces=4)
        kept = []
        for i, (sampled, err, ms) in enumerate([
                (True, False, 1), (False, False, 1), (False, True, 1),
                (False, False, 50), (True, True, 50), (False, False, 2)]):
            sp = t.Span(name="predict", kind="request", start_ns=0,
                        end_ns=int(ms * 1e6), trace_id=f"{i:032x}",
                        span_id=SID, status="ERROR: X" if err else "OK",
                        attributes={"deployment": "d"})
            kept.append(col.offer(sp, sampled=sampled))
        recs = [(r["trace_id"], r["kept_by"], r["status"])
                for r in col.query(n=10)]
        res[name] = (kept, col.stats(), recs,
                     [r["trace_id"] for r in col.query(status="error")],
                     [r["trace_id"] for r in col.query(min_duration_ms=20)])
    assert res["port"] == res["ref"]


def test_histogram_exemplars_equal():
    lines = {}
    for name, m, t in (("port", tmetrics, tt), ("ref", jmetrics, jt)):
        reg = m.MetricsRegistry()
        reg.exemplar_labels["replica"] = "r1"
        with t.trace_scope(t.TraceContext(TID, SID, True)):
            reg.observe("seldon_api_executor_server_requests_seconds",
                        0.02, {"deployment": "d"})
        with t.trace_scope(t.TraceContext("12" * 16, SID, False)):
            reg.observe("seldon_api_executor_server_requests_seconds",
                        3.0, {"deployment": "d"})
        out = []
        for ln in reg.render().splitlines():
            head, sep, ex = ln.partition(" # ")
            if sep:  # the exemplar's timestamp is the observation's
                ex = " ".join(ex.split(" ")[:2])
            out.append(head + sep + ex)
        lines[name] = out
    assert lines["port"] == lines["ref"]
    assert any(f'trace_id="{TID}",replica="r1"' in ln
               for ln in lines["port"])
    assert not any("12" * 16 in ln for ln in lines["port"])


@pytest.mark.parametrize("ann", [
    {},
    {"seldon.io/tracing": "true", "seldon.io/trace-sample": "0.25",
     "seldon.io/trace-export": "/x.jsonl", "seldon.io/trace-slow-ms": "9",
     "seldon.io/tracing-max": "7"},
    {"seldon.io/trace-sample": "2"},
    {"seldon.io/trace-sample": "abc"},
    {"seldon.io/trace-slow-ms": "0"},
    {"seldon.io/trace-slow-ms": "x"},
    {"seldon.io/tracing-max": "-1"},
    {"seldon.io/tracing-max": "1.5"},
])
def test_trace_config_equal(ann, monkeypatch):
    for k in ("SELDON_TRACING", "SELDON_TRACE_SAMPLE",
              "SELDON_TRACE_EXPORT"):
        monkeypatch.delenv(k, raising=False)

    def parse(t):
        try:
            return t.trace_config_from_annotations(ann, "d/p").__dict__
        except ValueError as e:
            return str(e)

    assert parse(tt) == parse(jt)


# ---- the port's device-trace window ----------------------------------------


def test_device_profile_window_writes_a_trace(tmp_path):
    import torch

    assert not tt.profiler_active()
    with tt.profile_annotation("idle"):  # no window: a no-op
        pass
    with tt.xla_profile(str(tmp_path)) as session:
        assert tt.profiler_active()
        with tt.profile_annotation("seldon.segment.x"):
            torch.ones(8) @ torch.ones(8)
        with tt.device_profile(str(tmp_path / "nested")) as nested:
            assert nested is None  # one session per process
    assert not tt.profiler_active()
    assert session.path is not None and os.path.getsize(session.path) > 0
    assert json.loads(open(session.path).read())["traceEvents"] is not None
    assert not (tmp_path / "nested").exists()


def test_device_profile_closes_from_another_thread(tmp_path):
    """A capture window opened on one thread and closed on another (the
    host sampler's) still stops its session and writes the trace."""
    import contextlib

    stack = contextlib.ExitStack()
    session = stack.enter_context(tt.device_profile(str(tmp_path)))
    t = threading.Thread(target=stack.close)
    t.start()
    t.join(60)
    assert not tt.profiler_active()
    assert session.path is not None and os.path.exists(session.path)


def test_device_profile_failed_start_is_torn_down(tmp_path, monkeypatch):
    import torch

    real = torch.profiler.profile
    stops = []

    class Broken:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("no profiler")

        def stop(self):
            stops.append(1)

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="no profiler"):
        with tt.device_profile(str(tmp_path)):
            pass
    assert stops == [1] and not tt.profiler_active()
    monkeypatch.setattr(torch.profiler, "profile", real)
    with tt.device_profile(str(tmp_path)) as session:
        pass
    assert session.path is not None
