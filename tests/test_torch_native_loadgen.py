"""The port's native load generator (``native.run_native_load`` over
``native/loadgen.cc``) on the CPU.

The reference's four ``TestNativeLoadgen`` cases on the port's
``NativeHttpServer``: REST and gRPC against a static answer, errors counted
when every answer carries grpc-status 13, and the h2 client against the
port's own gRPC tiers (``grpc.aio`` and the native h2c server) over a
SIMPLE_MODEL engine.  Then the port's ``NativeRestServer`` over the same
engine, driven from an executor while its own loop serves, and the
result's shape (keys, nesting, types) held to the reference's on one
static server.
"""

import asyncio
import json

import pytest

from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.native import NativeHttpServer, run_native_load
from seldon_core_tpu_torch.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.proto.convert import message_to_proto

PAYLOAD = {"data": {"names": ["a", "b"], "ndarray": [[1.0, 2.0]]}}
PREDICT = "/seldon.tpu.Seldon/Predict"
KEYS = {"requests", "errors", "seconds", "req_per_s", "latency_ms"}


def _engine() -> GraphEngine:
    return GraphEngine({"name": "m", "implementation": "SIMPLE_MODEL"})


def _request_bytes() -> bytes:
    return message_to_proto(SeldonMessage.from_dict(PAYLOAD)) \
        .SerializeToString()


def test_rest_static():
    srv = NativeHttpServer(submit=None, http2=False).start()
    try:
        srv.set_static_response(200, b'{"ok":true}')
        res = run_native_load(
            "rest", "127.0.0.1", srv.port, "/p", b'{"x":1}',
            connections=4, seconds=0.5, warmup_s=0.1,
        )
        assert res["errors"] == 0
        assert res["requests"] > 50
        assert res["latency_ms"]["p50"] > 0
        assert set(res) == KEYS
    finally:
        srv.stop()


def test_grpc_static():
    resp = pb.SeldonMessage()
    resp.strData = "y"
    srv = NativeHttpServer(submit=None, http2=True).start()
    try:
        srv.set_static_response(0, resp.SerializeToString())
        req = pb.SeldonMessage()
        req.strData = "x"
        res = run_native_load(
            "grpc", "127.0.0.1", srv.port, PREDICT,
            req.SerializeToString(), connections=2, streams_per_conn=8,
            seconds=0.5, warmup_s=0.1,
        )
        assert res["errors"] == 0
        assert res["requests"] > 50
    finally:
        srv.stop()


def test_errors_counted():
    """grpc-status != 0 counts as an error, not as a pass."""
    srv = NativeHttpServer(submit=None, http2=True).start()
    try:
        srv.set_static_response(13, b"")  # INTERNAL, trailers only
        res = run_native_load(
            "grpc", "127.0.0.1", srv.port, "/x",
            pb.SeldonMessage().SerializeToString(),
            connections=1, streams_per_conn=2, seconds=0.3, warmup_s=0.05,
        )
        assert res["requests"] > 0
        assert res["errors"] == res["requests"]
    finally:
        srv.stop()


def test_bad_runs_raise_and_a_refused_port_completes_nothing():
    """The C side's refusals raise (no connections: code -1; a gRPC body
    over its 60000-byte frame: code -2).  A port that refuses every
    connection completes no request and counts no error, as the
    reference's binding reports it: a caller gates on ``requests``."""
    with pytest.raises(KeyError):
        run_native_load("h3", "127.0.0.1", 1, "/", b"")
    srv = NativeHttpServer(submit=None, http2=False).start()
    port = srv.port
    with pytest.raises(RuntimeError, match=r"loadgen failed \(code -1\)"):
        run_native_load("rest", "127.0.0.1", port, "/p", b"{}",
                        connections=0, seconds=0.2, warmup_s=0.05)
    with pytest.raises(RuntimeError, match=r"loadgen failed \(code -2\)"):
        run_native_load("grpc", "127.0.0.1", port, PREDICT,
                        b"x" * 60000, connections=1, seconds=0.2,
                        warmup_s=0.05)
    srv.stop()  # nothing listens there now
    res = run_native_load("rest", "127.0.0.1", port, "/p", b"{}",
                          connections=1, seconds=0.2, warmup_s=0.05)
    assert (res["requests"], res["errors"]) == (0, 0)


@pytest.mark.parametrize("tier", ["grpc_aio", "native"])
def test_grpc_loadgen_against_the_port_grpc_tiers(tier):
    """The h2 client against the port's ``grpc.aio`` server and its native
    h2c server, each over a SIMPLE_MODEL engine on this loop."""

    async def run():
        eng = _engine()
        if tier == "grpc_aio":
            from seldon_core_tpu_torch.serving.grpc_api import (
                GrpcServer,
                seldon_service_handler,
            )

            server = GrpcServer([seldon_service_handler(eng)], port=0,
                                host="127.0.0.1")
        else:
            from seldon_core_tpu_torch.serving.native_http import (
                NativeGrpcServer,
            )

            server = NativeGrpcServer(deployment=eng, bind="127.0.0.1")
        port = await server.start()
        try:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, lambda: run_native_load(
                "grpc", "127.0.0.1", port, PREDICT, _request_bytes(),
                connections=2, streams_per_conn=4, seconds=0.5,
                warmup_s=0.1))
        finally:
            await server.stop()

    res = asyncio.run(asyncio.wait_for(run(), 120))
    assert res["errors"] == 0
    assert res["requests"] > 10


def test_native_rest_tier_keeps_serving_while_the_load_runs():
    """``run_native_load`` in an executor frees the GIL for its window, so
    the ``NativeRestServer``'s loop, in this thread, answers every
    request: errors 0."""
    from seldon_core_tpu_torch.serving.native_http import NativeRestServer

    async def run():
        eng = _engine()
        server = NativeRestServer(eng, bind="127.0.0.1")
        port = await server.start()
        try:
            loop = asyncio.get_running_loop()
            res = await loop.run_in_executor(None, lambda: run_native_load(
                "rest", "127.0.0.1", port, "/api/v0.1/predictions",
                json.dumps(PAYLOAD).encode(), connections=4, seconds=0.5,
                warmup_s=0.1))
            return res
        finally:
            await server.stop()

    res = asyncio.run(asyncio.wait_for(run(), 120))
    assert res["errors"] == 0
    assert res["requests"] > 10
    assert res["latency_ms"]["p99"] >= res["latency_ms"]["p50"] > 0


def test_result_has_the_references_shape():
    """Keys, nesting and types of one run on one static server, the
    reference's binding against the port's."""
    from seldon_core_tpu.native import run_native_load as jrun

    def shape(d):
        return {k: shape(v) if isinstance(v, dict) else type(v)
                for k, v in d.items()}

    srv = NativeHttpServer(submit=None, http2=False).start()
    try:
        srv.set_static_response(200, b'{"ok":true}')
        args = ("rest", "127.0.0.1", srv.port, "/p", b'{"x":1}')
        kw = dict(connections=2, seconds=0.3, warmup_s=0.05)
        ref, port = jrun(*args, **kw), run_native_load(*args, **kw)
    finally:
        srv.stop()
    assert shape(port) == shape(ref)
    assert shape(port) == {
        "requests": int, "errors": int, "seconds": float,
        "req_per_s": float,
        "latency_ms": {"p50": float, "p90": float, "p99": float,
                       "mean": float}}
    for res in (ref, port):
        assert res["errors"] == 0 and res["requests"] > 0
