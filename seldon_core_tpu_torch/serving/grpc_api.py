"""gRPC: the per-role component services and the external ``Seldon``
service (port of ``seldon_core_tpu/serving/grpc_api.py``).

Services and methods, under the package ``seldon.tpu`` of
``proto/prediction_pb2.py`` (the reference's, byte for byte):
``Model{Predict,SendFeedback,Stream}``, ``Router{Route,SendFeedback}``,
``Transformer{TransformInput}``, ``OutputTransformer{TransformOutput}``,
``Combiner{Aggregate}``, ``Generic`` (all of them and ``Stream``) and the
external ``Seldon{Predict,SendFeedback}``.  The stubs are written by hand:
each method is a ``unary_unary`` (``Stream``: ``unary_stream``) handler
with the protobuf classes as codecs, and a client calls the same paths, so
the port's servers and clients and the reference's talk to each other.

``Stream`` sends one ``jsonData`` message per event of the component's
``stream(msg)`` (an LLM's tokens, then its done event).  A client that
cancels the call closes the generator, which frees an LLM request's slot
and pages.

:class:`GrpcComponentClient` keeps one channel per event loop: a
``grpc.aio`` channel belongs to the loop that made it, so the client makes
its channel inside the loop that first uses it, and a new one if it is used
from another loop later.  Server and client refuse ``DeviceTensorRef``
payloads (the device plane, slice 4e of the port).  A server binds its
port with ``SO_REUSEPORT`` only when asked (``reuse_port``): grpc's own
default would let two servers take one port without an error.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Optional, Sequence

import grpc
import grpc.aio
import numpy as np

from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, Status
from seldon_core_tpu_torch.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.proto.convert import (
    feedback_from_proto,
    feedback_to_proto,
    message_from_proto,
    message_to_proto,
)
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.utils import maybe_await as _maybe_await

__all__ = ["SERVICE_METHODS", "STREAMING_METHODS", "grpc_options",
           "component_service_handlers", "seldon_service_handler",
           "GrpcServer", "GrpcComponentClient", "SeldonGrpcClient",
           "serve_grpc_component"]

logger = logging.getLogger(__name__)

_PKG = "seldon.tpu"

# service -> method -> (request class, response class)
SERVICE_METHODS: dict[str, dict[str, tuple[Any, Any]]] = {
    "Model": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Router": {
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Transformer": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "OutputTransformer": {
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "Combiner": {
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
    },
    "Generic": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Seldon": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
}

# server-streaming methods (one request, a stream of answers)
STREAMING_METHODS: dict[str, dict[str, tuple]] = {
    "Model": {"Stream": (pb.SeldonMessage, pb.SeldonMessage)},
    "Generic": {"Stream": (pb.SeldonMessage, pb.SeldonMessage)},
}

# big tensors: the reference's seldon.io/grpc-max-message-size default
DEFAULT_MAX_MESSAGE_SIZE = 100 * 1024 * 1024


def grpc_options(max_message_size: int = DEFAULT_MAX_MESSAGE_SIZE) -> list:
    return [("grpc.max_send_message_length", max_message_size),
            ("grpc.max_receive_message_length", max_message_size)]


def _branch_message(branch: int) -> SeldonMessage:
    """A router's answer on the wire: its branch as a 1x1 ndarray."""
    return SeldonMessage(data=np.asarray([[int(branch)]]), encoding="ndarray")


def _extract_branch(msg: SeldonMessage) -> int:
    arr = msg.host_data()
    if arr is None:
        return -1
    return int(np.asarray(arr).ravel()[0])


def _failure(e: Exception) -> SeldonMessage:
    return SeldonMessage(status=Status.failure(
        getattr(e, "status_code", 500), f"{type(e).__name__}: {e}",
        "INTERNAL"))


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class _ComponentRpc:
    """A component (``ComponentHandle``, ``BatchedModel``, an LLM
    component) behind the rpc methods; a component error answers a
    FAILURE status."""

    def __init__(self, handle: Any):
        self.handle = handle

    async def call(self, method: str, request_pb):
        h = self.handle
        try:
            if method == "Predict":
                out = await _maybe_await(h.predict(
                    message_from_proto(request_pb)))
            elif method == "TransformInput":
                out = await _maybe_await(h.transform_input(
                    message_from_proto(request_pb)))
            elif method == "TransformOutput":
                out = await _maybe_await(h.transform_output(
                    message_from_proto(request_pb)))
            elif method == "Route":
                branch = await _maybe_await(h.route(
                    message_from_proto(request_pb)))
                out = _branch_message(int(branch))
            elif method == "Aggregate":
                out = await _maybe_await(h.aggregate(
                    [message_from_proto(m) for m in request_pb.seldonMessages]))
            elif method == "SendFeedback":
                out = await _maybe_await(h.send_feedback(
                    feedback_from_proto(request_pb)))
                if out is None:
                    out = SeldonMessage(status=Status())
            else:
                raise ValueError(f"unknown method {method}")
        except Exception as e:
            logger.exception("gRPC component method %s failed", method)
            out = _failure(e)
        return message_to_proto(out)


def _unary_handler(rpc: _ComponentRpc, method: str, req_cls, resp_cls):
    async def handler(request_pb, context):
        return await rpc.call(method, request_pb)

    return grpc.unary_unary_rpc_method_handler(
        handler, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


async def stream_events(handle: Any, msg: SeldonMessage):
    """The answers of a ``Stream`` call: each event of ``handle.stream(msg)``
    as a ``jsonData`` message, a FAILURE message for an error, and the
    generator closed at the end, also when the call is cancelled."""
    agen = handle.stream(msg)
    try:
        async for event in agen:
            yield message_to_proto(SeldonMessage(json_data=event))
    except asyncio.CancelledError:
        raise
    except Exception as e:
        logger.exception("gRPC stream failed")
        yield message_to_proto(_failure(e))
    finally:
        await agen.aclose()


def _stream_handler(handle: Any, req_cls, resp_cls):
    async def handler(request_pb, context):
        async for out in stream_events(handle, message_from_proto(request_pb)):
            yield out

    return grpc.unary_stream_rpc_method_handler(
        handler, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


_ROLE_BY_TYPE = {"MODEL": "Model", "ROUTER": "Router",
                 "TRANSFORMER": "Transformer",
                 "OUTPUT_TRANSFORMER": "OutputTransformer",
                 "COMBINER": "Combiner", "OUTLIER_DETECTOR": "Transformer"}
_METHOD_ATTR = {"Predict": "predict", "TransformInput": "transform_input",
                "TransformOutput": "transform_output", "Route": "route",
                "Aggregate": "aggregate", "SendFeedback": "send_feedback"}


def component_service_handlers(handle: Any, service_type: str = "") -> list:
    """The handlers of one component: ``Generic`` and the service of its
    role (``service_type``), each with only the methods the component
    implements, and ``Stream`` where it streams."""
    rpc = _ComponentRpc(handle)
    has = getattr(handle, "has", None)

    def supported(method: str) -> bool:
        attr = _METHOD_ATTR[method]
        if has is not None:
            return bool(has(attr))
        return callable(getattr(handle, attr, None))

    services = {"Generic"}
    role = _ROLE_BY_TYPE.get(service_type.upper())
    if role:
        services.add(role)
    can_stream = callable(getattr(handle, "stream", None))
    out = []
    for svc in sorted(services):
        methods = {m: _unary_handler(rpc, m, req, resp)
                   for m, (req, resp) in SERVICE_METHODS[svc].items()
                   if supported(m)}
        if can_stream:
            for m, (req, resp) in STREAMING_METHODS.get(svc, {}).items():
                methods[m] = _stream_handler(handle, req, resp)
        if methods:
            out.append(grpc.method_handlers_generic_handler(
                f"{_PKG}.{svc}", methods))
    return out


def seldon_service_handler(deployment: Any, auth: Optional[Any] = None
                           ) -> Any:
    """The external ``Seldon`` service over anything with async
    ``predict(msg)`` and ``send_feedback(fb)`` (an engine, a deployment).

    ``auth(metadata) -> principal or None`` checks each call's metadata
    (the reference's ``oauth_token`` convention); None answers
    ``UNAUTHENTICATED``."""

    async def _check(context) -> bool:
        if auth is None:
            return True
        md = {k: v for k, v in (context.invocation_metadata() or [])}
        if auth(md) is None:
            await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                "invalid or missing oauth_token")
            return False
        return True

    async def predict(request_pb, context):
        if not await _check(context):
            return pb.SeldonMessage()
        out = await deployment.predict(message_from_proto(request_pb))
        return message_to_proto(out)

    async def send_feedback(request_pb, context):
        if not await _check(context):
            return pb.SeldonMessage()
        out = await deployment.send_feedback(feedback_from_proto(request_pb))
        return message_to_proto(out)

    return grpc.method_handlers_generic_handler(f"{_PKG}.Seldon", {
        "Predict": grpc.unary_unary_rpc_method_handler(
            predict, request_deserializer=pb.SeldonMessage.FromString,
            response_serializer=pb.SeldonMessage.SerializeToString),
        "SendFeedback": grpc.unary_unary_rpc_method_handler(
            send_feedback, request_deserializer=pb.Feedback.FromString,
            response_serializer=pb.SeldonMessage.SerializeToString),
    })


class GrpcServer:
    """A ``grpc.aio`` server over ``handlers`` (the microservice's component
    services, the engine's ``Seldon`` service).  Make it inside the event
    loop that serves it."""

    def __init__(self, handlers: Sequence[Any], port: int = 5000,
                 host: str = "0.0.0.0",
                 max_message_size: int = DEFAULT_MAX_MESSAGE_SIZE,
                 reuse_port: bool = False):
        self.server = grpc.aio.server(options=grpc_options(max_message_size)
                                      + [("grpc.so_reuseport",
                                          1 if reuse_port else 0)])
        for h in handlers:
            self.server.add_generic_rpc_handlers((h,))
        self.port = self.server.add_insecure_port(f"{host}:{port}")

    async def start(self) -> int:
        await self.server.start()
        return self.port

    async def stop(self, grace: float = 1.0) -> None:
        await self.server.stop(grace)

    async def wait(self) -> None:
        await self.server.wait_for_termination()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class _Stub:
    """The callables of one service's methods on a channel."""

    def __init__(self, channel: grpc.aio.Channel, service: str):
        self._calls = {}
        for method, (req_cls, resp_cls) in SERVICE_METHODS[service].items():
            self._calls[method] = channel.unary_unary(
                f"/{_PKG}.{service}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)
        for method, (req_cls, resp_cls) in STREAMING_METHODS.get(
                service, {}).items():
            self._calls[method] = channel.unary_stream(
                f"/{_PKG}.{service}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

    def __getattr__(self, item):
        try:
            return self._calls[item]
        except KeyError:
            raise AttributeError(item) from None


class _LoopChannel:
    """One ``grpc.aio`` channel to ``target`` per event loop, made inside
    the loop that uses it, with the stubs of its services."""

    def __init__(self, target: str, max_message_size: int):
        self.target = target
        self.options = grpc_options(max_message_size)
        self._loop = None
        self._channel = None
        self._stubs: dict[str, _Stub] = {}

    def stub(self, service: str) -> _Stub:
        loop = asyncio.get_running_loop()
        if self._channel is None or self._loop is not loop:
            # a channel of a finished loop cannot be closed from this one;
            # it is dropped with its loop
            self._channel = grpc.aio.insecure_channel(self.target,
                                                      options=self.options)
            self._loop = loop
            self._stubs = {}
        s = self._stubs.get(service)
        if s is None:
            s = self._stubs[service] = _Stub(self._channel, service)
        return s

    async def close(self) -> None:
        if self._channel is not None and \
                self._loop is asyncio.get_running_loop():
            await self._channel.close()
        self._channel = None
        self._stubs = {}


def _device_refs_enabled():
    """The process-wide ``DeviceTensorRef`` opt-in, env
    ``SELDON_DEVICE_REFS``: ``1`` in-process refs (loopback serving only),
    ``shm`` same-host shared memory."""
    import os

    v = os.environ.get("SELDON_DEVICE_REFS", "")
    return "shm" if v == "shm" else v == "1"


class GrpcComponentClient:
    """Calls a component over gRPC: the method surface of the REST
    ``RemoteComponent``, so the runner picks either by the node's
    ``endpoint.type``.  Errors map as the reference's: a FAILURE answer
    keeps its code and reason, a deadline is 504 ``DEADLINE_EXCEEDED``, an
    unreachable server 503 ``TRANSPORT``, any other rpc error 500
    ``RPC``."""

    def __init__(self, target: str, methods: Sequence[str] = (),
                 timeout_s: float = 30.0,
                 max_message_size: int = DEFAULT_MAX_MESSAGE_SIZE,
                 name: str = "", device_refs=None):
        self.target = target
        self.name = name or target
        self._chan = _LoopChannel(target, max_message_size)
        self._methods = set(methods) or {
            "predict", "route", "aggregate", "transform_input",
            "transform_output", "send_feedback", "stream"}
        self.timeout = timeout_s
        if device_refs is None:
            device_refs = _device_refs_enabled()
        self.device_refs = device_refs

    def _encode(self, msg: SeldonMessage):
        return message_to_proto(msg, device_refs=self.device_refs)

    def has(self, method: str) -> bool:
        return method in self._methods

    async def close(self) -> None:
        await self._chan.close()

    async def _unary(self, service: str, method: str, req_pb):
        try:
            return await getattr(self._chan.stub(service), method)(
                req_pb, timeout=self.timeout)
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise SeldonComponentError(
                    f"{service}.{method} deadline exceeded after "
                    f"{self.timeout}s", 504, "DEADLINE_EXCEEDED") from None
            if e.code() == grpc.StatusCode.UNAVAILABLE:
                raise SeldonComponentError(
                    f"{service}.{method} unavailable: {e.details()}", 503,
                    "TRANSPORT") from None
            raise SeldonComponentError(
                f"{service}.{method} rpc failed: {e.code().name} "
                f"{e.details()}", 500, "RPC") from None

    async def _message(self, service: str, method: str,
                       msg: SeldonMessage) -> SeldonMessage:
        resp = await self._unary(service, method, self._encode(msg))
        return self._ok(message_from_proto(resp))

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._message("Model", "Predict", msg)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._message("Transformer", "TransformInput", msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._message("OutputTransformer", "TransformOutput",
                                   msg)

    async def route(self, msg: SeldonMessage) -> int:
        return _extract_branch(await self._message("Router", "Route", msg))

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        lst = pb.SeldonMessageList()
        for m in msgs:
            message_to_proto(m, lst.seldonMessages.add())
        resp = await self._unary("Combiner", "Aggregate", lst)
        return self._ok(message_from_proto(resp))

    async def send_feedback(self, fb: Feedback) -> Optional[SeldonMessage]:
        # Generic serves every role, so routers and combiners get feedback
        resp = await self._unary("Generic", "SendFeedback",
                                 feedback_to_proto(fb))
        return message_from_proto(resp)

    async def stream(self, msg: SeldonMessage,
                     timeout_s: Optional[float] = None):
        """The events of the ``Generic.Stream`` call as dicts.  Closing the
        iterator cancels the call, which closes the server's generator.
        ``timeout_s`` bounds the whole stream (none by default: a
        generation lasts as long as its request asks)."""
        call = self._chan.stub("Generic").Stream(self._encode(msg),
                                                 timeout=timeout_s)
        try:
            async for resp in call:
                out = self._ok(message_from_proto(resp))
                yield out.json_data
        finally:
            call.cancel()

    @staticmethod
    def _ok(msg: SeldonMessage) -> SeldonMessage:
        if msg.status is not None and msg.status.status == "FAILURE":
            raise SeldonComponentError(
                msg.status.info, status_code=msg.status.code or 500,
                reason=msg.status.reason)
        return msg


async def serve_grpc_component(handle: Any, host: str = "0.0.0.0",
                               port: int = 9000,
                               annotations: Optional[dict] = None) -> None:
    """The microservice's GRPC mode: serve ``handle`` until cancelled;
    ``seldon.io/grpc-max-message-size`` sets the message limit."""
    ann = annotations or {}
    max_size = int(ann.get("seldon.io/grpc-max-message-size",
                           DEFAULT_MAX_MESSAGE_SIZE))
    server = GrpcServer(
        component_service_handlers(handle,
                                   getattr(handle, "service_type", "")),
        port=port, host=host, max_message_size=max_size)
    bound = await server.start()
    print(f"component {getattr(handle, 'name', '?')!r} serving gRPC on "
          f"{host}:{bound}", flush=True)
    try:
        await server.wait()
    finally:
        await server.stop(0)


class SeldonGrpcClient:
    """A client of the external ``Seldon`` service (an engine); ``token``
    goes as ``oauth_token`` metadata."""

    def __init__(self, target: str, token: str = "", timeout_s: float = 30.0,
                 max_message_size: int = DEFAULT_MAX_MESSAGE_SIZE):
        self._chan = _LoopChannel(target, max_message_size)
        self.token = token
        self.timeout = timeout_s

    def _metadata(self) -> tuple:
        return (("oauth_token", self.token),) if self.token else ()

    async def close(self) -> None:
        await self._chan.close()

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        resp = await self._chan.stub("Seldon").Predict(
            message_to_proto(msg), timeout=self.timeout,
            metadata=self._metadata())
        return message_from_proto(resp)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        resp = await self._chan.stub("Seldon").SendFeedback(
            feedback_to_proto(fb), timeout=self.timeout,
            metadata=self._metadata())
        return message_from_proto(resp)
