"""The port's native tiers against the reference's on the CPU.

- ``FrameCodec.encode`` gives the reference's bytes for every frame dtype
  (a bfloat16 torch tensor against an ``ml_dtypes`` array included), and
  each codec decodes the other's frames; the message and feedback codecs
  of ``serving/framed.py`` give the reference's bytes.
- The reference's ``AsyncFramedClient`` against the port's
  ``FramedComponentServer``, and the port's against the reference's,
  answer as each package's own pair does, errors included; the port's
  ``AsyncFramedComponentServer`` and ``FramedClient`` too.
- ``NativeRestServer``: the same requests to the port's and the
  reference's, over the same engine and component, answer the same status
  and JSON, and the same server-sent events over chunked encoding.  The
  port's native tier answers through the Python tier's route tables, so
  its ``/metrics`` series are those of the reference's Python (aiohttp)
  tier, and a ``/pause`` on either tier drains both.

The native library builds with ``g++`` at first use into
``build/torch_native/``.  Every socket test runs under its own timeout
(``_run``, client timeouts).
"""

import asyncio
import json
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.native import FrameCodec as JCodec
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.runtime.component import (
    SeldonComponentError as JComponentError,
)
from seldon_core_tpu.serving import framed as jframed
from seldon_core_tpu.serving.native_http import (
    NativeRestServer as JNativeRest,
)
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu.utils.metrics import EngineMetrics as JMetrics
from seldon_core_tpu_torch import native
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.runtime.component import (
    SeldonComponentError as TComponentError,
)
from seldon_core_tpu_torch.serving import framed as tframed
from seldon_core_tpu_torch.serving.native_http import NativeRestServer
from seldon_core_tpu_torch.serving.rest import RestServer
from seldon_core_tpu_torch.utils.metrics import EngineMetrics as TMetrics

TIMEOUT = 120
FRAME_DTYPES = ["float32", "float64", "bfloat16", "float16", "int8", "int16",
                "int32", "int64", "uint8", "bool"]


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _values(dtype, shape=(3, 5), seed=0):
    x = np.random.default_rng(seed).normal(size=shape) * 30
    if dtype == "bool":
        return x > 0
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    if dtype.startswith("int") or dtype == "uint8":
        info = np.iinfo(dtype)
        return np.clip(np.round(x), info.min, info.max).astype(dtype)
    return x.astype(dtype)


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("dtype", FRAME_DTYPES)
def test_frame_codec_bytes_equal_the_reference(dtype):
    x = _values(dtype)
    y = np.arange(7, dtype=np.int32)
    meta = json.dumps({"names": ["a"], "k": dtype}).encode()
    want = JCodec().encode(native.MSG_PREDICT, meta, [x, y], flags=3)
    tc = native.FrameCodec()
    assert tc.encode(native.MSG_PREDICT, meta, [x, y], flags=3) == want
    assert tc.encode(native.MSG_PREDICT, meta, [_torch(x), y],
                     flags=3) == want
    frame = tc.decode(want)
    assert frame.msg_type == native.MSG_PREDICT and frame.meta == meta
    np.testing.assert_array_equal(_np(frame.tensors[0]), x)
    np.testing.assert_array_equal(frame.tensors[1], y)
    if dtype == "bfloat16":
        assert frame.tensors[0].dtype == torch.bfloat16
    jframe = JCodec().decode(tc.encode(native.MSG_RESPONSE, b"", [x]))
    np.testing.assert_array_equal(np.asarray(jframe.tensors[0]), x)


def test_message_and_feedback_codecs_give_the_reference_bytes():
    x = _values("float32")
    body = {"data": {"names": ["p", "q", "r", "s", "t"],
                     "ndarray": x.tolist()},
            "meta": {"puid": "abc", "tags": {"t": 1},
                     "routing": {"r": 1}}}
    jm, tm = JMessage.from_dict(body), TMessage.from_dict(body)
    jc, tc = JCodec(), native.FrameCodec()
    assert tframed.encode_message(tc, tm) == jframed.encode_message(jc, jm)
    for other in ({"strData": "s"}, {"jsonData": {"a": [1]}},
                  {"binData": "AAEC"}, {"status": {"code": 503,
                                                   "status": "FAILURE"}}):
        assert tframed.encode_message(tc, TMessage.from_dict(other)) == \
            jframed.encode_message(jc, JMessage.from_dict(other))
    fb = {"request": body, "response": {"meta": {"routing": {"r": 0}}},
          "truth": {"data": {"ndarray": [[1.0]]}}, "reward": 0.5}
    want = jframed.encode_feedback(jc, JFeedback.from_dict(fb))
    assert tframed.encode_feedback(tc, TFeedback.from_dict(fb)) == want
    got = tframed.decode_feedback(tc.decode(want))
    assert got.reward == 0.5 and got.response.meta.routing == {"r": 0}
    np.testing.assert_array_equal(got.request.data, x)
    back = tframed.decode_message(tc.decode(jframed.encode_message(jc, jm)))
    assert back.names == jm.names and back.encoding == "binTensor"
    assert back.meta.to_dict() == jm.meta.to_dict()
    np.testing.assert_array_equal(back.data, np.asarray(jm.data))


class Scale:
    def predict(self, X, names):
        if np.asarray(X).size == 0:
            raise ValueError("empty input")
        return np.asarray(X) * 3.0

    def send_feedback(self, X, names, reward, truth, routing=None):
        return np.array([[reward]])

    def tags(self):
        return {"s": "3"}


def _frame_calls(client, msg_cls, fb_cls, x):
    """A predict, a feedback and a failing predict through ``client``."""
    async def calls():
        out = (await client.predict(msg_cls.from_ndarray(x, names=["a", "b"])
                                    )).to_dict()
        fb = (await client.send_feedback(fb_cls(
            request=msg_cls.from_ndarray(x), reward=2.0))).to_dict()
        try:
            await client.predict(msg_cls.from_ndarray(np.zeros((0, 2))))
            err = None
        except RuntimeError as e:
            err = str(e)
        return out, fb, err
    return calls()


def test_framed_clients_and_servers_of_the_two_packages_interoperate():
    x = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    jsrv = jframed.FramedComponentServer(JHandle(Scale(), name="s")).start()
    tsrv = tframed.FramedComponentServer(THandle(Scale(), name="s")).start()

    async def run():
        tasync = await tframed.AsyncFramedComponentServer(
            THandle(Scale(), name="s")).start()
        res = {}
        try:
            for cname, ccls, mcls, fcls in (
                    ("ref", jframed.AsyncFramedClient, JMessage, JFeedback),
                    ("port", tframed.AsyncFramedClient, TMessage, TFeedback)):
                for sname, port in (("ref", jsrv.port), ("port", tsrv.port),
                                    ("async", tasync.port)):
                    c = await ccls(timeout=30).connect("127.0.0.1", port)
                    try:
                        res[cname, sname] = await _frame_calls(c, mcls, fcls,
                                                               x)
                    finally:
                        c.close()
        finally:
            await tasync.stop()
        return res

    try:
        res = _run(run())
        with tframed.FramedClient("127.0.0.1", tsrv.port, timeout=30) as c:
            blocking = c.predict(TMessage.from_ndarray(x, names=["a", "b"]))
    finally:
        jsrv.stop()
        tsrv.stop()
    want = res["ref", "ref"]
    assert want[2] is not None and "empty input" in want[2]
    np.testing.assert_array_equal(JMessage.from_dict(want[0]).data, x * 3.0)
    for key, got in res.items():
        assert got == want, key
    assert blocking.to_dict() == want[0]


class _Streamer:
    """A message-level component with a stream of three events, the last
    carrying custom metrics; ``pkg`` picks the package's message and error
    classes."""

    accepts_messages = True

    def __init__(self, pkg):
        self.msg_cls = JMessage if pkg == "ref" else TMessage
        self.err_cls = JComponentError if pkg == "ref" else \
            TComponentError

    def predict(self, msg):
        return self.msg_cls(json_data={"n": len(msg.json_data["ids"])})

    async def stream(self, msg):
        ids = msg.json_data["ids"]
        if not ids:
            raise self.err_cls("no ids", 400, "BAD")
        for t in ids[:2]:
            yield {"token": t}
        yield {"done": True, "ids": ids,
               "metrics": [{"key": "tokens", "type": "COUNTER",
                            "value": 2}]}


def _http(port, path, body=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw, code, ctype = r.read().decode(), r.status, \
                r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        raw, code, ctype = e.read().decode(), e.code, ""
    if ctype.startswith("text/event-stream"):
        return code, [json.loads(ln[6:]) for ln in raw.split("\n\n")
                      if ln.startswith("data: ")]
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def test_native_rest_server_answers_like_the_reference():
    node = {"name": "echo", "type": "MODEL"}
    x = np.random.default_rng(4).normal(size=(2, 2)).tolist()
    steps = [("/api/v0.1/predictions", {"jsonData": {"ids": [1, 2]}}),
             ("/api/v1.0/predictions", {"jsonData": {"ids": [3]}}),
             ("/api/v0.1/predictions", b"{bad"),
             ("/api/v0.1/predictions", b""),
             ("/api/v0.1/feedback", {"reward": 1.0}),
             ("/api/v0.1/feedback", {"reward": "x"}),
             ("/predict", {"jsonData": {"ids": [1, 2, 3]}}),
             ("/route", {"data": {"ndarray": x}}),
             ("/api/v0.1/stream", {"jsonData": {"ids": [4, 5, 6]}}),
             ("/stream", {"jsonData": {"ids": [7, 8]}}),
             ("/stream", {"jsonData": {"ids": []}}),
             ("/ready", None), ("/live", None), ("/nowhere", None),
             ("/metrics", None)]

    def ref_engine(jmet):
        return JEngine(node, name="main", metrics_sink=jmet, resolver=lambda
                       u: JHandle(_Streamer("ref"), name="echo"))

    async def run():
        jmet, tmet = JMetrics(deployment="d"), TMetrics(deployment="d")
        amet = JMetrics(deployment="d")
        teng = TEngine(node, name="main", metrics_sink=tmet, resolver=lambda
                       u: THandle(_Streamer("port"), name="echo"))
        jsrv = JNativeRest(engine=ref_engine(jmet), component=JHandle(
            _Streamer("ref"), name="echo"), metrics=jmet, bind="127.0.0.1")
        tsrv = NativeRestServer(engine=teng, component=THandle(
            _Streamer("port"), name="echo"), metrics=tmet, bind="127.0.0.1")
        # the reference's Python tier, for the /metrics series
        asrv = await start_server(build_app(
            engine=ref_engine(amet), component=JHandle(
                _Streamer("ref"), name="echo"), metrics=amet),
            "127.0.0.1", 0)
        await jsrv.start()
        await tsrv.start()
        try:
            out = []
            for path, body in steps:
                out.append((path, await asyncio.to_thread(
                    _http, jsrv.port, path, body), await asyncio.to_thread(
                    _http, tsrv.port, path, body)))
                aio = await asyncio.to_thread(
                    _http, asrv.addresses[0][1], path, body)
            return out, aio
        finally:
            await tsrv.stop()
            await jsrv.stop()
            await asrv.cleanup()

    answers, (ac, ab) = _run(run())
    for path, (jc, jb), (tc, tb) in answers:
        assert tc == jc, (path, jb, tb)
        if path == "/metrics":
            assert ac == 200
            assert [ln.rsplit(" ", 1)[0] for ln in tb.splitlines()] == \
                [ln.rsplit(" ", 1)[0] for ln in ab.splitlines()]
            assert 'tokens{model_name="predictor"} 2.0' in tb
            assert 'tokens{model_name="echo"} 2.0' in tb
        else:
            if isinstance(jb, dict):
                jb.get("meta", {}).pop("puid", None)
                tb.get("meta", {}).pop("puid", None)
            assert tb == jb, path
    codes = [c for _, (c, _), _ in answers]
    assert codes == [200, 200, 400, 400, 200, 400, 200, 200, 200, 200, 400,
                     200, 200, 404, 200]


def test_pause_on_either_tier_drains_both():
    """The runner's two tiers over one ``RestServer``: ``/pause`` on the
    Python tier turns the native tier's predictions, stream and ``/ready``
    into 503 with the reference's paused body, and ``/unpause`` on the
    native tier restores both."""
    node = {"name": "echo", "type": "MODEL"}
    pred = ("/api/v0.1/predictions", {"jsonData": {"ids": [1, 2]}})
    stream = ("/api/v0.1/stream", {"jsonData": {"ids": [3, 4]}})

    async def run():
        teng = TEngine(node, name="main", resolver=lambda u: THandle(
            _Streamer("port"), name="echo"))
        rest = await RestServer(teng, host="127.0.0.1", port=0).start()
        nat = NativeRestServer(rest=rest, bind="127.0.0.1")
        await nat.start()

        async def call(port, path, body=None):
            return await asyncio.to_thread(_http, port, path, body)

        try:
            out = {"before": await call(nat.port, *pred)}
            out["pause"] = await call(rest.port, "/pause")
            for tier, port in (("native", nat.port), ("python", rest.port)):
                out[tier, "paused"] = [await call(port, *pred),
                                       await call(port, *stream),
                                       await call(port, "/ready")]
            out["unpause"] = await call(nat.port, "/unpause")
            for tier, port in (("native", nat.port), ("python", rest.port)):
                out[tier, "after"] = [await call(port, *pred),
                                      await call(port, *stream),
                                      await call(port, "/ready")]
            return out
        finally:
            await nat.stop()
            await rest.stop()

    out = _run(run())
    paused = (503, {"status": {"code": 503, "info": "paused", "reason": "",
                               "status": "FAILURE"}})
    assert out["before"][0] == 200
    assert out["pause"] == (200, "paused inflight=0")
    assert out["unpause"] == (200, "unpaused")
    for tier in ("native", "python"):
        assert out[tier, "paused"] == [paused, paused, (503, "paused")], tier
        (pc, pb), (sc, events), ready = out[tier, "after"]
        assert pc == 200 and pb["jsonData"] == {"n": 2}
        assert sc == 200 and [e.get("token") for e in events] == [3, 4, None]
        assert ready == (200, "ready")


def test_native_batch_queue_forms_the_reference_batches():
    """The same submissions to the port's and the reference's
    ``NativeBatchQueue`` come out as the same batches."""
    from seldon_core_tpu.native import NativeBatchQueue as JQueue

    subs = [(1, 3, 0), (2, 5, 0), (3, 2, 1), (4, 7, 0), (5, 1, 1), (6, 8, 0)]
    out = []
    for cls in (JQueue, native.NativeBatchQueue):
        q = cls(max_batch_rows=8, max_delay_s=0.0, buckets=(2, 4, 8))
        for req, rows, lane in subs:
            q.submit(req, rows, lane)
        batches = []
        while (b := q.wait_batch(0.05)) is not None:
            batches.append(b)
        assert q.pending == 0
        q.close()
        out.append(batches)
    assert out[1] == out[0] and len(out[0]) >= 3
    with pytest.raises(ValueError, match="rejected"):
        native.NativeBatchQueue(4, 0.0).submit(1, 9)


class _Async:
    """An async component (as a batched model or an LLM is)."""

    accepts_messages = True

    async def predict(self, msg):
        await asyncio.sleep(0)
        return TMessage(data=np.asarray(msg.data) + 1.0)


def test_framed_server_awaits_an_async_target_on_its_own_loop():
    srv = tframed.FramedComponentServer(THandle(_Async(), name="a")).start()
    try:
        with tframed.FramedClient("127.0.0.1", srv.port, timeout=30) as c:
            outs = [c.predict(TMessage.from_ndarray(np.full((1, 2), i)))
                    for i in range(3)]
    finally:
        srv.stop()
    assert [o.host_data().tolist() for o in outs] == [
        [[1.0, 1.0]], [[2.0, 2.0]], [[3.0, 3.0]]]
