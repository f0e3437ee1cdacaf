"""The port's native gRPC tier (``NativeGrpcServer`` over the C++ h2c
server) against the reference's on the CPU.

The same deployments and components behind the reference's
``NativeGrpcServer`` and the port's, called by a real ``grpc.aio`` client
on the shared protobuf classes: the answers' bytes EQUAL (``Seldon``
service, component services, an unknown method's ``UNIMPLEMENTED``, a
handler error's ``INTERNAL`` with its message, 1 MiB tensors both ways past
the flow-control windows), the ``Stream`` RPC's events EQUAL the
reference's for ``llm.json``'s model on the reference's weights, and the
runner's deployment answers on its native gRPC tier as on its ``grpc.aio``
tier.  Two port servers share one port with ``reuseport``.
"""

import asyncio
import socket

import grpc
import grpc.aio
import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.serving import native_http as jnative
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.operator.local import LocalDeployment
from seldon_core_tpu_torch.graph.spec import load_deployment
from seldon_core_tpu_torch.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.proto.convert import (
    message_from_proto,
    message_to_proto,
)
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.runtime.paged import PagedConfig
from seldon_core_tpu_torch.serving import grpc_api as tg
from seldon_core_tpu_torch.serving import native_http as tnative

TIMEOUT = 180
SIDES = {"ref": (jnative, JEngine, JHandle, JMessage),
         "port": (tnative, TEngine, THandle, TMessage)}
REQ = pb.SeldonMessage.FromString(message_to_proto(TMessage.from_dict(
    {"data": {"names": ["a", "b"], "ndarray": [[1.0, 2.0]]}}))
    .SerializeToString())


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _unary(ch, path, req_cls=pb.SeldonMessage):
    return ch.unary_unary(path, request_serializer=req_cls.SerializeToString,
                          response_deserializer=pb.SeldonMessage.FromString)


async def _calls(side, calls, deployment=None, component=None):
    """``calls``: (path, request, request class); answers as
    ``("ok", bytes)`` or ``("error", code, details)``."""
    mod = SIDES[side][0]
    srv = mod.NativeGrpcServer(deployment=deployment, component=component,
                               bind="127.0.0.1")
    port = await srv.start()
    ch = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
    out = []
    try:
        for path, req, cls in calls:
            try:
                resp = await _unary(ch, path, cls)(req, timeout=30)
                d = message_from_proto(resp).to_dict()
                d.get("meta", {}).pop("puid", None)
                out.append(("ok", d))
            except grpc.aio.AioRpcError as e:
                out.append(("error", e.code(), e.details()))
    finally:
        await ch.close()
        await srv.stop()
    return out


def _both(make_calls, **kw):
    got = {}
    for side in ("ref", "port"):
        calls, targets = make_calls(side)
        got[side] = _run(_calls(side, calls, **targets))
    assert got["port"] == got["ref"]
    return got["port"]


def test_seldon_service_and_unknown_method():
    def make(side):
        _, E, _, _ = SIDES[side]
        eng = E({"name": "m", "implementation": "SIMPLE_MODEL"})
        fb = pb.Feedback(reward=1.0)
        return ([("/seldon.tpu.Seldon/Predict", REQ, pb.SeldonMessage)] * 3
                + [("/seldon.tpu.Seldon/SendFeedback", fb, pb.Feedback),
                   ("/seldon.tpu.Nope/Missing", REQ, pb.SeldonMessage)],
                {"deployment": eng})

    out = _both(make)
    assert out[0][1]["data"]["ndarray"] == [[1.0, 2.0, 3.0]]
    assert out[3][1]["status"]["status"] == "SUCCESS"
    assert out[4][:2] == ("error", grpc.StatusCode.UNIMPLEMENTED)


def test_component_services():
    class Comp:
        def predict(self, X, names=None):
            return np.asarray(X) * 2

        def route(self, X, names=None):
            return 0

        def send_feedback(self, request, names, reward, truth, routing=None):
            return None

    def make(side):
        _, _, H, _ = SIDES[side]
        handle = H(Comp(), name="c")
        return ([("/seldon.tpu.Model/Predict", REQ, pb.SeldonMessage),
                 ("/seldon.tpu.Generic/Route", REQ, pb.SeldonMessage),
                 ("/seldon.tpu.Router/Route", REQ, pb.SeldonMessage),
                 ("/seldon.tpu.Generic/SendFeedback", pb.Feedback(reward=0.5),
                  pb.Feedback)],
                {"component": handle})

    out = _both(make)
    assert out[0][1]["data"]["ndarray"] == [[2.0, 4.0]]
    assert out[1][1]["data"]["ndarray"] == [[0]]


def test_handler_errors_are_internal_with_their_text():
    def make(side):
        M = SIDES[side][3]

        class Boom:
            async def predict(self, msg):
                raise RuntimeError("50% of café failed: %d")

            async def send_feedback(self, fb):
                return M()

        return ([("/seldon.tpu.Seldon/Predict", REQ, pb.SeldonMessage)],
                {"deployment": Boom()})

    out = _both(make)
    assert out[0][:2] == ("error", grpc.StatusCode.INTERNAL)
    assert "50% of café failed: %d" in out[0][2]


def test_large_tensors_cross_the_flow_control_windows():
    big = np.arange(256 * 1024, dtype=np.float32).reshape(512, -1)
    req = message_to_proto(TMessage(data=big, encoding="binTensor"))

    def make(side):
        M = SIDES[side][3]

        class Echo:
            async def predict(self, msg):
                return M(data=msg.host_data(), encoding="binTensor")

            async def send_feedback(self, fb):
                return M()

        return ([("/seldon.tpu.Seldon/Predict", req, pb.SeldonMessage)],
                {"deployment": Echo()})

    out = _both(make)
    assert out[0][0] == "ok"


def _llm():
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
        convert.params_from_jax(jax.tree.map(np.asarray, j.engine.params)),
        cfg, PagedConfig(65, 16), max_slots=4)
    return j, tllm.LLMComponent(engine, n_new=8)


def test_stream_events_equal_the_references():
    j, t = _llm()

    async def events(side, comp):
        srv = SIDES[side][0].NativeGrpcServer(component=comp,
                                              bind="127.0.0.1")
        port = await srv.start()
        ch = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        out = []
        try:
            for path in ("/seldon.tpu.Generic/Stream",
                         "/seldon.tpu.Model/Stream"):
                call = ch.unary_stream(
                    path, request_serializer=pb.SeldonMessage.SerializeToString,
                    response_deserializer=pb.SeldonMessage.FromString)
                for p in ([3, 1, 4, 1, 5], [], list(range(2, 30))):
                    req = message_to_proto(TMessage(
                        json_data={"prompt_ids": p, "n_new": 6}))
                    out.append([message_from_proto(r).json_data
                                async for r in call(req, timeout=60)])
            # an error before the first event: a FAILURE message
            bad = message_to_proto(TMessage(json_data={
                "prompt_ids": [1] * 120, "n_new": 60}))
            got = [message_from_proto(r) async for r in call(bad, timeout=60)]
            out.append([(m.status.status, m.status.code) for m in got])
        finally:
            await ch.close()
            await srv.stop()
        return out

    want = _run(events("ref", j))
    got = _run(events("port", t))
    t.engine.close()

    def ids(evs):
        return [[e.get("token") for e in s[:-1]] + [s[-1]["ids"]]
                for s in evs[:-1]]

    assert ids(got) == ids(want)
    assert got[-1] == want[-1] == [("FAILURE", 500)]


def test_runner_deployment_answers_alike_on_both_grpc_tiers():
    dep = load_deployment({"spec": {"name": "d", "predictors": [
        {"name": "main", "graph": {
            "name": "combo", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [{"name": "m1", "implementation": "SIMPLE_MODEL"},
                         {"name": "m2", "implementation": "SIMPLE_MODEL"}]}}]}})

    async def run():
        local = LocalDeployment(dep, device="cpu")
        aio = tg.GrpcServer([tg.seldon_service_handler(local)], port=0,
                            host="127.0.0.1")
        aport = await aio.start()
        nat = tnative.NativeGrpcServer(deployment=local, bind="127.0.0.1")
        nport = await nat.start()
        try:
            outs = []
            for port in (aport, nport):
                c = tg.SeldonGrpcClient(f"127.0.0.1:{port}")
                o = (await c.predict(TMessage.from_dict(
                    {"data": {"ndarray": [[1.0, 2.0]]}}))).to_dict()
                o["meta"].pop("puid")
                outs.append(o)
                await c.close()
            return outs
        finally:
            await nat.stop()
            await aio.stop()

    a, n = _run(run())
    assert a == n and a["status"]["status"] == "SUCCESS"


def test_two_native_grpc_servers_share_one_port_with_reuseport():
    from seldon_core_tpu_torch.serving.workers import pick_free_port

    port = pick_free_port()

    async def run():
        a = tnative.NativeGrpcServer(
            deployment=TEngine({"name": "m",
                                "implementation": "SIMPLE_MODEL"}),
            port=port, bind="127.0.0.1", reuseport=True)
        b = tnative.NativeGrpcServer(
            deployment=TEngine({"name": "m",
                                "implementation": "SIMPLE_MODEL"}),
            port=port, bind="127.0.0.1", reuseport=True)
        await a.start()
        await b.start()
        try:
            assert a.port == b.port == port
            c = tg.SeldonGrpcClient(f"127.0.0.1:{port}")
            out = await c.predict(TMessage(data=np.ones((1, 2))))
            await c.close()
            return out.status.status
        finally:
            await a.stop()
            await b.stop()

    assert _run(run()) == "SUCCESS"
    with socket.socket() as s:  # without reuseport a taken port is refused
        s.bind(("127.0.0.1", 0))
        s.listen()
        with pytest.raises(OSError):
            tnative.NativeGrpcServer(component=object(), bind="127.0.0.1",
                                     port=s.getsockname()[1])
