"""REST serving on the standard library (port of
``seldon_core_tpu/serving/rest.py``).

One small HTTP/1.1 server on ``asyncio.start_server`` (keep-alive,
``Content-Length`` bodies, raw JSON or the reference's form-encoded
``json=`` field) carries two surfaces, as the reference's aiohttp app does:

- the **engine API** (:class:`EngineServer`): ``POST /api/v0.1/predictions``
  (and ``/api/v1.0/predictions``), ``POST /api/v0.1/feedback``,
  ``POST /api/v0.1/stream`` (server-sent events), ``GET /ready``,
  ``/live``, ``/pause``, ``/unpause``, ``/metrics`` and ``/seldon.json``.
  While paused, predictions, the stream and ``/ready`` answer 503;
  ``/pause`` waits (``?timeout=`` seconds, 10 by default) for the requests
  in flight to drain.
- the **component API** (:class:`ComponentServer`), the reference
  engine's southbound calls: ``POST /predict``, ``/transform-input``,
  ``/transform-output``, ``/route``, ``/aggregate``, ``/send-feedback``,
  ``/stream`` (when the component has ``stream``), ``GET /health/status``,
  ``/metrics`` and ``/seldon.json``.

Status codes and error bodies are the reference's: a FAILURE status's code
is the HTTP status (429, an admission or queue shed, adds ``Retry-After:
1``), a body that is empty or not JSON answers 400.  The QoS headers
``X-Seldon-Priority`` and ``X-Seldon-Deadline-Ms`` bind the request's QoS
context for the engine's walk (``qos/``).  ``reuse_port`` binds the port
with ``SO_REUSEPORT``, so worker processes can share it
(``serving/workers.py``).  ``/metrics`` renders :class:`EngineMetrics`: every
answered request is observed, and the ``metrics`` of a stream event and of
a component's response meta are merged into it.

A stream's first event is awaited before the headers go out, so an error
the generator raises early (a bad request, a prompt over ``max_len``)
answers as JSON with its status.  Once the headers are out, an error sends
an ``{"error": ...}`` event and ends the stream.  The stream's response has
no length: it is sent with ``Connection: close`` and ends when the
connection does.  A client that closes its end stops the stream at once:
the generator is closed, which frees an LLM request's slot and pages.

Every message answer names this process for the device plane
(``X-Seldon-Device-Plane: <process token>|<host token>``, read by a
plane-enabled ``RemoteComponent``), and a request whose tensor rides a
``deviceRef`` is resolved through ``runtime/device_registry.py`` (an
unresolvable one answers 400 naming ``DeviceTensorRef``, the sender's
cue to downgrade).  ``GET /admin/artifacts`` (``?coverage=1``) answers the
artifact plane's posture, or 404 when the deployment has none
(``artifacts/http.py``).

Observability (the reference's routes and bodies): W3C ``traceparent`` /
``tracestate`` headers bind the trace context of a prediction, as the QoS
headers bind its QoS context.  ``GET /trace`` lists recent span trees
(``?n=``), one by ``?puid=``, the collector's ``?stats=1`` or its
filtered view (``?status= ?min_ms= ?drill= ?trace_id= ?replica=``), 404
without a tracer.  ``GET /admin/introspect``, ``/admin/flightrecorder`` and
``/admin/health`` read the health plane (``health/http.py``);
``/admin/profile``, ``/admin/profile/capture``, ``/admin/profile/compile``
and ``/admin/profile/capacity`` the profiling plane (``profiling/
http.py``); each answers 404 with an enable hint when its plane is off
and 400 for a malformed number.  The engine's answer says which replica
served (``X-Seldon-Replica``) when it has one.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import parse_qs

import numpy as np

from seldon_core_tpu_torch.graph.engine import _maybe_await
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, Status
from seldon_core_tpu_torch.qos.context import qos_from_headers, qos_scope
from seldon_core_tpu_torch.runtime.component import (
    SeldonComponentError,
    validate_metrics,
)
from seldon_core_tpu_torch.serving.bodies import BadRequest as _BadRequest
from seldon_core_tpu_torch.serving.client import (
    DEVICE_PLANE_HEADER,
    plane_identity,
)
from seldon_core_tpu_torch.serving.bodies import (
    HELPER_BYTES,
    BodyParser,
    payload_json,
)
from seldon_core_tpu_torch.utils.metrics import EngineMetrics
from seldon_core_tpu_torch.utils.tracing import (
    trace_from_headers,
    trace_scope,
)

__all__ = ["RestServer", "EngineServer", "ComponentServer", "Request",
           "Response", "EventStream"]

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 499: "Client Closed Request",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}
_EMPTY = object()  # a stream that ended before its first event
_MAX_BODY = 256 << 20
_JSON = "application/json"
_TEXT = "text/plain"


def _err_json(code: int, info: str, reason: str = "") -> bytes:
    return SeldonMessage(
        status=Status.failure(code, info, reason)).to_json().encode()


def _parse_msg(d: Any) -> SeldonMessage:
    try:
        return SeldonMessage.from_dict(d)
    except Exception as e:
        raise _BadRequest(f"bad SeldonMessage: {e}")


def _parse_feedback(d: Any) -> Feedback:
    try:
        return Feedback.from_dict(d)
    except Exception as e:
        raise _BadRequest(f"bad Feedback: {e}")


def _decode(body: bytes, ctype: str, kind, parser: Optional[BodyParser]):
    """``body`` as ``kind``; a body of at least ``HELPER_BYTES`` is parsed
    by ``parser``'s helper process (``serving/bodies.py``)."""
    if parser is not None and len(body) >= HELPER_BYTES:
        d = parser.parse(body, ctype)
    else:
        d = payload_json(body, ctype)
    if kind is SeldonMessage:
        return _parse_msg(d)
    if kind is Feedback:
        return _parse_feedback(d)
    return d


class Request:
    """One parsed HTTP request."""

    __slots__ = ("method", "path", "query", "headers", "body", "_server")

    def __init__(self, method: str, target: str, headers: dict, body: bytes,
                 server: "RestServer"):
        path, _, qs = target.partition("?")
        self.method = method
        self.path = path
        self.query = {k: v[-1] for k, v in parse_qs(qs).items()}
        self.headers = headers
        self.body = body
        self._server = server

    async def parse(self, kind=None):
        """The body as ``kind`` (SeldonMessage, Feedback, or None for the
        JSON value), decoded off the event loop: a large body (an image is
        150,528 numbers) takes tens of ms, and bodies that arrive together
        would decode back to back in one pass of the loop, holding the
        batcher's flush timers.  The decoder thread hands a large body's
        parse to a helper process, which holds no GIL of this one
        (``serving/bodies.py``).  Raises :class:`_BadRequest`."""
        return await asyncio.get_running_loop().run_in_executor(
            self._server.decoder, _decode, self.body,
            self.headers.get("content-type", ""), kind,
            self._server.body_parser)


class Response:
    __slots__ = ("code", "body", "ctype", "headers")

    def __init__(self, code: int, body: bytes, ctype: str = _JSON,
                 headers: Optional[dict] = None):
        self.code = code
        self.body = body
        self.ctype = ctype
        self.headers = headers or {}


def _text(text: str, code: int = 200) -> Response:
    return Response(code, text.encode(), _TEXT)


def _bad(e: _BadRequest) -> Response:
    return Response(400, _err_json(400, str(e)))


def _msg_code(msg: SeldonMessage) -> int:
    if msg.status is not None and msg.status.status == "FAILURE":
        return msg.status.code if 400 <= msg.status.code < 600 else 500
    return 200


def _msg_response(msg: SeldonMessage) -> Response:
    code = _msg_code(msg)
    headers = {DEVICE_PLANE_HEADER: plane_identity()}
    if code == 429:
        # shed answers (admission, a full queue) carry a retry hint
        headers["Retry-After"] = "1"
    return Response(code, msg.to_json().encode(), _JSON, headers)


def _openapi(which: str, **kw) -> Callable[[Request], Awaitable[Response]]:
    async def handler(req: Request) -> Response:
        from seldon_core_tpu_torch.serving import openapi

        spec = {"engine": openapi.engine_spec,
                "component": openapi.component_spec}[which](**kw)
        return Response(200, json.dumps(spec).encode())

    return handler


# ---------------------------------------------------------------------------
# server-sent events
# ---------------------------------------------------------------------------

class EventStream:
    """A stream whose first event is in hand (``first``, or ``_EMPTY`` when
    the generator ended before one): the transport sends the headers,
    then ``encode(event)`` of ``first`` and of each later event of
    ``agen``, then calls ``end(code)`` once.  ``on_end`` runs then."""

    def __init__(self, first, agen, metrics, name: str, t0: float):
        self.first = first
        self.agen = agen
        self.metrics = metrics
        self.name = name
        self.on_end: Optional[Callable[[], None]] = None
        self._t0 = t0

    def encode(self, event) -> bytes:
        """One event's bytes; its ``metrics`` merge into the registry."""
        return _event_bytes(event, self.metrics, self.name)

    async def end(self, code: Optional[int]) -> None:
        """Observe the request with ``code`` (200, 499 when the client
        left, 500 when the stream failed; None observes nothing) and close
        the generator, which ends the request (an LLM slot and its pages
        free at once)."""
        try:
            if code is not None and self.metrics is not None:
                self.metrics.observe_request(
                    self.name, time.perf_counter() - self._t0, code)
            await self.agen.aclose()
        finally:
            if self.on_end is not None:
                self.on_end()


def _error_event(e: Exception) -> bytes:
    return b"data: " + json.dumps(
        {"error": f"{type(e).__name__}: {e}"}).encode() + b"\n\n"


async def _open_stream(req: Request, stream_fn, metrics, name: str):
    """The stream of ``stream_fn(msg)`` with its first event awaited, or
    the JSON error ``Response`` when the request or that event failed
    (module docstring)."""
    t0 = time.perf_counter()
    try:
        msg = await req.parse(SeldonMessage)
    except _BadRequest as e:
        return _bad(e)
    try:
        agen = stream_fn(msg)
    except SeldonComponentError as e:
        return _failure(e.status_code, str(e), e.reason)
    try:
        first = await agen.__anext__()
    except StopAsyncIteration:
        first = _EMPTY
    except BaseException as e:
        await agen.aclose()
        if not isinstance(e, Exception):
            raise  # cancelled
        if isinstance(e, SeldonComponentError):
            code, info, reason = e.status_code, str(e), e.reason
        else:
            logger.exception("stream failed before its first event (%s)",
                             name)
            code, info, reason = 500, f"{type(e).__name__}: {e}", ""
        if metrics is not None:
            metrics.observe_request(name, time.perf_counter() - t0, code)
        return _failure(code, info, reason)
    return EventStream(first, agen, metrics, name, t0)


def _failure(code: int, info: str, reason: str = "") -> Response:
    return Response(code if 400 <= code < 600 else 500,
                    _err_json(code, info, reason))


def _event_bytes(event, metrics, name: str) -> bytes:
    if isinstance(event, dict) and event.get("metrics") \
            and metrics is not None:
        try:
            metrics.merge_custom(name, validate_metrics(event["metrics"]))
        except Exception:
            logger.warning("ignoring malformed stream-event metrics from %s",
                           name)
    return b"data: " + json.dumps(event).encode() + b"\n\n"


async def _send_stream(reader, writer, stream: EventStream) -> None:
    """``stream`` as server-sent events on the connection, whose end
    closing (EOF) stops it, cancelling the pending event."""
    code = None
    try:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        code = 200
        if stream.first is not _EMPTY:
            code = await _send_events(reader, writer, stream)
    except (ConnectionError, asyncio.IncompleteReadError):
        logger.debug("stream client disconnected (%s)", stream.name)
        code = 499
    finally:
        await stream.end(code)


async def _send_events(reader, writer, stream: EventStream) -> int:
    """Write the stream's events while watching the client.  Returns the
    request's status for the metrics (200, 499 or 500)."""
    async def client_gone():
        while await reader.read(4096):
            pass  # bytes past the request are ignored

    gone = asyncio.ensure_future(client_gone())
    nxt = None
    try:
        event = stream.first
        while True:
            writer.write(stream.encode(event))
            await writer.drain()
            nxt = asyncio.ensure_future(stream.agen.__anext__())
            await asyncio.wait({nxt, gone},
                               return_when=asyncio.FIRST_COMPLETED)
            if not nxt.done():
                return 499  # the client left: the finally cancels nxt
            try:
                event = nxt.result()
            except StopAsyncIteration:
                return 200
            except Exception as e:
                logger.exception("stream failed (%s)", stream.name)
                writer.write(_error_event(e))
                await writer.drain()
                return 500
    finally:
        # a pending event is cancelled inside the generator, which then
        # runs its own cleanup
        for t in (gone, nxt):
            if t is not None and not t.done():
                t.cancel()
        await asyncio.gather(*(t for t in (gone, nxt) if t is not None),
                             return_exceptions=True)


# ---------------------------------------------------------------------------
# the two surfaces
# ---------------------------------------------------------------------------

class EngineServer:
    """The engine API over one predictor graph.

    ``engine`` is anything with ``async predict(SeldonMessage)`` and
    ``async send_feedback(Feedback)``; ``stream(SeldonMessage)`` returning
    an async generator of event dicts serves the stream (an engine without
    it answers 501 ``STREAM_UNSUPPORTED``)."""

    def __init__(self, engine, metrics: Optional[EngineMetrics] = None,
                 name: str = "predictor"):
        self.engine = engine
        self.name = name
        self.metrics = (metrics or getattr(engine, "metrics", None)
                        or EngineMetrics())
        self.paused = False
        self._inflight = 0

    async def predictions(self, req: Request) -> Response:
        if self.paused:
            return Response(503, _err_json(503, "paused"))
        t0 = time.perf_counter()
        # in flight from acceptance (before the body is decoded), so a
        # /pause drain cannot report empty while a request still parses
        self._inflight += 1
        try:
            try:
                msg = await req.parse(SeldonMessage)
            except _BadRequest as e:
                return _bad(e)
            try:
                # the QoS headers bind the context of the whole walk (the
                # engine, the batcher and the breakers read it); the W3C
                # headers bind the trace context the same way (absent or
                # malformed: None, and the engine makes its own)
                with qos_scope(qos_from_headers(req.headers)), \
                        trace_scope(trace_from_headers(req.headers)):
                    out = await self.engine.predict(msg)
            except Exception as e:
                logger.exception("predict failed")
                out = SeldonMessage(status=Status.failure(
                    500, f"{type(e).__name__}: {e}", "INTERNAL"))
        finally:
            self._inflight -= 1
        code = (out.status.code if out.status is not None
                and out.status.status == "FAILURE" else 200)
        self.metrics.observe_request(self.name, time.perf_counter() - t0,
                                     code)
        return self._stamp_replica(_msg_response(out))

    def _stamp_replica(self, resp: Response) -> Response:
        """``X-Seldon-Replica`` on data-path answers: which replica
        served, without opening the body."""
        rep = getattr(self.engine, "replica", "")
        if rep:
            resp.headers["X-Seldon-Replica"] = str(rep)
        return resp

    async def stream(self, req: Request):
        if self.paused:
            return Response(503, _err_json(503, "paused"))
        fn = getattr(self.engine, "stream", None)
        if fn is None:
            return Response(501, _err_json(
                501, "engine does not support streaming",
                "STREAM_UNSUPPORTED"))
        self._inflight += 1  # until the stream ends
        try:
            out = await _open_stream(req, fn, self.metrics, self.name)
        except BaseException:
            self._stream_done()
            raise
        if isinstance(out, EventStream):
            out.on_end = self._stream_done
        else:
            self._stream_done()
        return out

    def _stream_done(self) -> None:
        self._inflight -= 1

    async def feedback(self, req: Request) -> Response:
        try:
            fb = await req.parse(Feedback)
        except _BadRequest as e:
            return _bad(e)
        try:
            out = await self.engine.send_feedback(fb)
        except Exception as e:
            logger.exception("send_feedback failed")
            out = SeldonMessage(status=Status.failure(
                500, f"{type(e).__name__}: {e}", "INTERNAL"))
        return self._stamp_replica(_msg_response(out))

    async def ready(self, req: Request) -> Response:
        return _text("paused", 503) if self.paused else _text("ready")

    async def live(self, req: Request) -> Response:
        return _text("live")

    async def pause(self, req: Request) -> Response:
        """Stop accepting traffic, then wait (bounded) for the requests in
        flight to drain."""
        self.paused = True
        deadline = time.monotonic() + float(req.query.get("timeout", 10.0))
        while self._inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return _text(f"paused inflight={self._inflight}")

    async def unpause(self, req: Request) -> Response:
        self.paused = False
        return _text("unpaused")

    async def prometheus(self, req: Request) -> Response:
        return _text(self.metrics.render())

    async def artifacts(self, req: Request) -> Response:
        from seldon_core_tpu_torch.artifacts.http import artifacts_body

        status, payload = artifacts_body(
            getattr(self.engine, "artifacts", None), req.query)
        return Response(status, json.dumps(payload).encode())

    async def trace(self, req: Request) -> Response:
        """Recent request trace trees, one by ``?puid=``, the collector's
        stats or its filtered view; 404 without a tracer."""
        tracer = getattr(self.engine, "tracer", None)
        if tracer is None or not tracer.enabled:
            return Response(404, _err_json(404, "tracing disabled"))
        q = req.query
        puid = q.get("puid")
        collector = getattr(tracer, "collector", None)
        if puid:
            sp = tracer.get(puid)
            if sp is None:
                return Response(404, _err_json(404, f"no trace for {puid}"))
            body = {"puid": puid, **sp.to_dict()}
        elif q.get("stats") and collector is not None:
            body = {"collector": collector.stats()}
        elif collector is not None and (
                q.get("status") or q.get("min_ms") or q.get("drill")
                or q.get("trace_id") or q.get("replica")):
            try:
                min_ms = float(q["min_ms"]) if "min_ms" in q else None
                n = int(q.get("n", 20))
            except ValueError:
                return Response(400, _err_json(
                    400, "min_ms/n must be numeric"))
            body = {"traces": collector.query(
                status=q.get("status"), min_duration_ms=min_ms,
                drill=q.get("drill"), trace_id=q.get("trace_id"),
                replica=q.get("replica"), n=n)}
        else:
            try:
                n = int(q.get("n", 20))
            except ValueError:
                return Response(400, _err_json(400, "n must be an integer"))
            body = {"traces": tracer.recent(n) if n > 0 else []}
        return Response(200, json.dumps(body).encode())

    def _admin(self, body_fn, plane_attr: str):
        """An ``/admin/*`` route over the engine's ``plane_attr`` plane
        (``health`` or ``profiler``): 404 with the hint when it is off, 400
        for a malformed number."""
        async def handler(req: Request) -> Response:
            try:
                status, payload = body_fn(
                    getattr(self.engine, plane_attr, None), req.query)
            except ValueError:
                return Response(400, _err_json(
                    400, "numeric query parameter expected"))
            return Response(status, json.dumps(payload).encode())

        return handler

    def register(self, server: "RestServer") -> None:
        from seldon_core_tpu_torch.health.http import (
            flightrecorder_body,
            health_body,
            introspect_body,
        )
        from seldon_core_tpu_torch.profiling.http import (
            capacity_body,
            capture_body,
            compile_body,
            profile_body,
        )

        for path in ("/api/v0.1/predictions", "/api/v1.0/predictions"):
            server.add_route("POST", path, self.predictions)
        server.add_stream("/api/v0.1/stream", self.stream)
        server.add_route("POST", "/api/v0.1/feedback", self.feedback)
        server.add_route("GET", "/ready", self.ready)
        server.add_route("GET", "/live", self.live)
        server.add_route("GET", "/pause", self.pause)
        server.add_route("GET", "/unpause", self.unpause)
        server.add_route("GET", "/metrics", self.prometheus)
        server.add_route("GET", "/admin/artifacts", self.artifacts)
        server.add_route("GET", "/trace", self.trace)
        for path, fn, attr in (
                ("/admin/introspect", introspect_body, "health"),
                ("/admin/flightrecorder", flightrecorder_body, "health"),
                ("/admin/health", health_body, "health"),
                ("/admin/profile", profile_body, "profiler"),
                ("/admin/profile/capture", capture_body, "profiler"),
                ("/admin/profile/compile", compile_body, "profiler"),
                ("/admin/profile/capacity", capacity_body, "profiler")):
            server.add_route("GET", path, self._admin(fn, attr))
        server.add_route("GET", "/seldon.json", _openapi("engine"))


class ComponentServer:
    """One component (a ``ComponentHandle``, a batched model, an LLM
    component) over the component API, wire-compatible with the reference
    engine's southbound calls."""

    def __init__(self, handle, metrics: Optional[EngineMetrics] = None):
        self.handle = handle
        self.metrics = metrics or EngineMetrics()

    @property
    def name(self) -> str:
        return getattr(self.handle, "name", type(self.handle).__name__)

    async def _run(self, fn, *args):
        """``fn(*args)``, observed; any error answers 500 FAILURE (the
        reference's, whatever the error's own code)."""
        t0 = time.perf_counter()
        try:
            res = await _maybe_await(fn(*args))
            if isinstance(res, SeldonMessage) and res.meta.metrics:
                self.metrics.merge_custom(self.name, res.meta.metrics)
            self.metrics.observe_request(self.name, time.perf_counter() - t0)
            return res
        except Exception as e:
            logger.exception("component %s failed", self.name)
            self.metrics.observe_request(self.name,
                                         time.perf_counter() - t0, 500)
            return SeldonMessage(
                status=Status.failure(500, f"{type(e).__name__}: {e}"))

    def _message_route(self, method: str):
        async def handler(req: Request) -> Response:
            try:
                msg = await req.parse(SeldonMessage)
            except _BadRequest as e:
                return _bad(e)
            return _msg_response(
                await self._run(getattr(self.handle, method), msg))

        return handler

    async def route(self, req: Request) -> Response:
        try:
            msg = await req.parse(SeldonMessage)
        except _BadRequest as e:
            return _bad(e)
        branch = await self._run(self.handle.route, msg)
        if isinstance(branch, SeldonMessage):  # the error path
            return _msg_response(branch)
        # a router answers with a 1x1 tensor
        return _msg_response(SeldonMessage(
            data=np.array([[branch]], dtype=np.int32), encoding="ndarray"))

    async def aggregate(self, req: Request) -> Response:
        try:
            payload = await req.parse()
            msgs = [_parse_msg(m) for m in payload.get("seldonMessages", [])]
        except _BadRequest as e:
            return _bad(e)
        return _msg_response(await self._run(self.handle.aggregate, msgs))

    async def send_feedback(self, req: Request) -> Response:
        try:
            fb = await req.parse(Feedback)
        except _BadRequest as e:
            return _bad(e)
        ret = await self._run(self.handle.send_feedback, fb)
        return _msg_response(ret if isinstance(ret, SeldonMessage)
                             else SeldonMessage(status=Status()))

    async def stream(self, req: Request):
        return await _open_stream(req, self.handle.stream, self.metrics,
                                  self.name)

    async def health(self, req: Request) -> Response:
        return _text("ok")

    async def prometheus(self, req: Request) -> Response:
        return _text(self.metrics.render())

    def register(self, server: "RestServer") -> None:
        for path, method in (("/predict", "predict"),
                             ("/transform-input", "transform_input"),
                             ("/transform-output", "transform_output")):
            server.add_route("POST", path, self._message_route(method))
        server.add_route("POST", "/route", self.route)
        server.add_route("POST", "/aggregate", self.aggregate)
        server.add_route("POST", "/send-feedback", self.send_feedback)
        streams = callable(getattr(self.handle, "stream", None))
        if streams:
            server.add_stream("/stream", self.stream)
        server.add_route("GET", "/health/status", self.health)
        # an engine registered first owns /metrics and /seldon.json
        if not server.has_route("GET", "/metrics"):
            server.add_route("GET", "/metrics", self.prometheus)
        if not server.has_route("GET", "/seldon.json"):
            server.add_route("GET", "/seldon.json",
                             _openapi("component", stream=streams))


# ---------------------------------------------------------------------------
# the HTTP/1.1 server
# ---------------------------------------------------------------------------

async def _respond(writer, resp: Response, close: bool = False) -> None:
    head = [f"HTTP/1.1 {resp.code} {_REASONS.get(resp.code, 'Error')}",
            f"Content-Type: {resp.ctype}",
            f"Content-Length: {len(resp.body)}",
            f"Connection: {'close' if close else 'keep-alive'}"]
    head += [f"{k}: {v}" for k, v in resp.headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                 + resp.body)
    await writer.drain()


class RestServer:
    """The engine API over ``engine``, the component API over
    ``component``, or both on one port with one shared ``metrics``
    (the reference's ``build_app``)."""

    def __init__(self, engine=None, host: str = "0.0.0.0", port: int = 8000,
                 component=None, metrics: Optional[EngineMetrics] = None,
                 reuse_port: bool = False):
        self.host = host
        self._port = port
        self.reuse_port = reuse_port
        self._routes: dict[tuple[str, str], Callable] = {}
        self._streams: dict[str, Callable] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()  # open connections, closed by stop()
        self._decoder: Optional[ThreadPoolExecutor] = None  # JSON bodies
        self._body_parser: Optional[BodyParser] = None  # the large ones
        if metrics is None and engine is not None and component is not None:
            metrics = EngineMetrics()  # one registry behind one /metrics
        if engine is not None:
            EngineServer(engine, metrics=metrics).register(self)
        if component is not None:
            ComponentServer(component, metrics=metrics).register(self)

    def add_route(self, method: str, path: str, handler) -> None:
        self._routes[(method, path)] = handler

    def add_stream(self, path: str, handler) -> None:
        """``handler(request)`` answers ``POST path`` with an
        :class:`EventStream` or an error ``Response``; the connection
        closes after either."""
        self._streams[path] = handler

    def has_route(self, method: str, path: str) -> bool:
        return (method, path) in self._routes

    @property
    def port(self) -> int:
        """The bound port (the real one when started with port 0)."""
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    @property
    def decoder(self) -> ThreadPoolExecutor:
        """The thread that decodes request bodies."""
        if self._decoder is None:
            self._decoder = ThreadPoolExecutor(
                1, thread_name_prefix="rest-json")
        return self._decoder

    @property
    def body_parser(self) -> BodyParser:
        """The helper process that parses large bodies."""
        if self._body_parser is None:
            self._body_parser = BodyParser()
        return self._body_parser

    async def start(self) -> "RestServer":
        self._server = await asyncio.start_server(
            self._serve, self.host, self._port,
            reuse_port=self.reuse_port or None)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):  # idle keep-alive connections
                w.close()
            await self._server.wait_closed()
            self._server = None
        if self._decoder is not None:
            self._decoder.shutdown(wait=False)
            self._decoder = None
        if self._body_parser is not None:
            self._body_parser.close()
            self._body_parser = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                method, target, version = (line.decode("latin-1").split()
                                           + [""] * 3)[:3]
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length", "0") or 0)
                if n > _MAX_BODY:
                    await _respond(writer, Response(
                        413, _err_json(413, "body too large")), close=True)
                    break
                body = await reader.readexactly(n) if n else b""
                close = (headers.get("connection", "").lower() == "close"
                         or version == "HTTP/1.0")
                req = Request(method, target, headers, body, self)
                # a stream's response ends with the connection
                close = close or self.is_stream(req)
                out = await self.dispatch(req)
                if isinstance(out, EventStream):
                    await _send_stream(reader, writer, out)
                    break
                await _respond(writer, out, close=close)
                if close:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    def is_stream(self, req: Request) -> bool:
        return req.method == "POST" and req.path in self._streams

    async def dispatch(self, req: Request):
        """The answer to ``req``: a ``Response``, or an
        :class:`EventStream` for a stream route.  Every transport (this
        server, the native tier) answers through here."""
        if self.is_stream(req):
            return await self._streams[req.path](req)
        handler = self._routes.get((req.method, req.path))
        if handler is not None:
            return await handler(req)
        allowed = sorted({m for m, p in self._routes if p == req.path}
                         | ({"POST"} if req.path in self._streams else set()))
        if allowed:
            return Response(405, _err_json(
                405, f"{'/'.join(allowed)} only"))
        # the reference's native tier's body
        where = req.path if req.method == "GET" else \
            f"{req.method} {req.path}"
        return Response(404, _err_json(404, f"no route {where}"))
