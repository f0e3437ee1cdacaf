"""REST engine server on the standard library (port of the engine routes of
``seldon_core_tpu/serving/rest.py``).

A small HTTP/1.1 server on ``asyncio.start_server`` (keep-alive,
``Content-Length`` bodies) answering:

- ``POST /api/v0.1/predictions`` (and ``/api/v1.0/predictions``): a
  SeldonMessage JSON in, the engine's SeldonMessage JSON out, with the
  FAILURE status code as the HTTP status;
- ``POST /api/v0.1/feedback``: a Feedback JSON (``request``,
  ``response``, ``reward``, ``truth``) in, a SeldonMessage with the status
  out;
- ``POST /api/v0.1/stream``: a SeldonMessage JSON in, server-sent events
  out (``data: <json>`` per event, the last one ``{"done": true, ...}``);
- ``GET /ready`` and ``GET /live``.

``engine`` is anything with ``async predict(SeldonMessage) ->
SeldonMessage`` and, for feedback, ``async send_feedback(Feedback) ->
SeldonMessage``; for the stream, ``stream(SeldonMessage)`` returning an
async generator of event dicts (an engine without it answers 501
``STREAM_UNSUPPORTED``).

A stream's first event is awaited before the headers go out, so an error
the generator raises early (a bad request, a prompt over ``max_len``)
answers as JSON with its status.  Once the headers are out, an error sends
an ``{"error": ...}`` event and ends the stream.  The stream's response has
no length: it is sent with ``Connection: close`` and ends when the
connection does.  A client that closes its end stops the stream at once:
the generator is closed, which frees an LLM request's slot and pages.  (An
event's ``metrics`` key reaches no Prometheus registry yet: the port has no
``/metrics`` route.)
"""

from __future__ import annotations

import asyncio
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, Status
from seldon_core_tpu_torch.runtime.component import SeldonComponentError

__all__ = ["RestServer"]

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable", 504: "Gateway Timeout"}
_STREAM_PATH = "/api/v0.1/stream"
_EMPTY = object()  # a stream that ended before its first event
_MAX_BODY = 64 << 20


def _decode(kind, body: bytes):
    return kind.from_dict(json.loads(body))


def _err_json(code: int, info: str, reason: str = "") -> bytes:
    return SeldonMessage(
        status=Status.failure(code, info, reason)).to_json().encode()


class RestServer:
    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8000):
        self.engine = engine
        self.host = host
        self._port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()  # open connections, closed by stop()
        self._decoder: Optional[ThreadPoolExecutor] = None  # JSON bodies

    @property
    def port(self) -> int:
        """The bound port (the real one when started with port 0)."""
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> "RestServer":
        self._decoder = ThreadPoolExecutor(1, thread_name_prefix="rest-json")
        self._server = await asyncio.start_server(self._serve, self.host,
                                                  self._port)
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

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                method, path, version = (line.decode("latin-1").split() + [""]
                                         * 3)[:3]
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length", "0") or 0)
                if n > _MAX_BODY:
                    await self._respond(writer, 413,
                                        _err_json(413, "body too large"),
                                        close=True)
                    break
                body = await reader.readexactly(n) if n else b""
                close = (headers.get("connection", "").lower() == "close"
                         or version == "HTTP/1.0")
                if path.split("?", 1)[0] == _STREAM_PATH:
                    # the stream's response ends with the connection
                    await self._stream(reader, writer, method, body)
                    break
                code, payload, ctype = await self._route(method, path, body)
                await self._respond(writer, code, payload, ctype=ctype,
                                    close=close)
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

    async def _route(self, method: str, path: str, body: bytes):
        path = path.split("?", 1)[0]
        if path in ("/api/v0.1/predictions", "/api/v1.0/predictions"):
            if method != "POST":
                return 405, _err_json(405, "POST only"), "application/json"
            return await self._call(body, SeldonMessage, self.engine.predict)
        if path == "/api/v0.1/feedback":
            if method != "POST":
                return 405, _err_json(405, "POST only"), "application/json"
            return await self._call(body, Feedback, self.engine.send_feedback)
        if path == "/ready" and method == "GET":
            return 200, b"ready", "text/plain"
        if path == "/live" and method == "GET":
            return 200, b"live", "text/plain"
        return 404, _err_json(404, f"no route {method} {path}"), \
            "application/json"

    async def _stream(self, reader, writer, method: str, body: bytes) -> None:
        """``POST /api/v0.1/stream``: server-sent events from
        ``engine.stream`` (module docstring)."""
        async def fail(code, info, reason=""):
            await self._respond(writer, code, _err_json(code, info, reason),
                                close=True)

        if method != "POST":
            return await fail(405, "POST only")
        fn = getattr(self.engine, "stream", None)
        if fn is None:
            return await fail(501, "engine does not support streaming",
                              "STREAM_UNSUPPORTED")
        code, msg = await self._parse(body, SeldonMessage)
        if code:
            return await self._respond(writer, code, msg, close=True)
        try:
            agen = fn(msg)
        except SeldonComponentError as e:
            return await fail(e.status_code, str(e), e.reason)
        try:
            try:
                first = await agen.__anext__()
            except StopAsyncIteration:
                first = _EMPTY
            except SeldonComponentError as e:
                return await fail(e.status_code, str(e), e.reason)
            except Exception as e:
                logger.exception("stream failed before its first event")
                return await fail(500, f"{type(e).__name__}: {e}",
                                  "INTERNAL")
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")
            if first is not _EMPTY:
                await self._send_events(reader, writer, first, agen)
        except (ConnectionError, asyncio.IncompleteReadError):
            logger.debug("stream client disconnected")
        finally:
            # closing the generator ends the request (an LLM slot and its
            # pages free at once), whether it finished, failed or was left
            await agen.aclose()

    @staticmethod
    async def _send_events(reader, writer, first, agen) -> None:
        """Write ``first`` and every later event of ``agen`` while watching
        the client: its end of the connection closing (EOF) stops the
        stream, cancelling the pending event."""
        async def client_gone():
            while await reader.read(4096):
                pass  # bytes past the request are ignored

        gone = asyncio.ensure_future(client_gone())
        nxt = None
        try:
            event = first
            while True:
                writer.write(b"data: " + json.dumps(event).encode() + b"\n\n")
                await writer.drain()
                nxt = asyncio.ensure_future(agen.__anext__())
                await asyncio.wait({nxt, gone},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not nxt.done():
                    return  # the client left: the finally cancels nxt
                try:
                    event = nxt.result()
                except StopAsyncIteration:
                    return
                except Exception as e:
                    logger.exception("stream failed")
                    writer.write(b"data: " + json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n\n")
                    await writer.drain()
                    return
        finally:
            # a pending event is cancelled inside the generator, which then
            # runs its own cleanup
            for t in (gone, nxt):
                if t is not None and not t.done():
                    t.cancel()
            await asyncio.gather(*(t for t in (gone, nxt) if t is not None),
                                 return_exceptions=True)

    async def _parse(self, body: bytes, kind):
        """``(0, message)``, or ``(400, error JSON)`` for an empty or bad
        body."""
        if not body:
            return 400, _err_json(400, "empty request body")
        try:
            # off the event loop: a large body (an image is 150,528 numbers)
            # takes tens of ms to decode, and connections whose bodies
            # arrive together would decode back to back in one pass of the
            # loop, holding the batcher's flush timers until all are done
            return 0, await asyncio.get_running_loop().run_in_executor(
                self._decoder, _decode, kind, body)
        except Exception as e:
            return 400, _err_json(400, f"bad {kind.__name__}: {e}")

    async def _call(self, body: bytes, kind, method):
        """Parse ``body`` as ``kind`` (SeldonMessage or Feedback), await
        ``method`` on it and answer its message."""
        code, msg = await self._parse(body, kind)
        if code:
            return code, msg, "application/json"
        try:
            out = await method(msg)
        except Exception as e:
            logger.exception("%s failed", method.__name__)
            return 500, _err_json(500, f"{type(e).__name__}: {e}",
                                  "INTERNAL"), "application/json"
        code = 200
        if out.status is not None and out.status.status == "FAILURE":
            code = out.status.code if 400 <= out.status.code < 600 else 500
        return code, out.to_json().encode(), "application/json"

    @staticmethod
    async def _respond(writer, code: int, payload: bytes,
                       ctype: str = "application/json",
                       close: bool = False) -> None:
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Error')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: {'close' if close else 'keep-alive'}\r\n\r\n")
        writer.write(head.encode("latin-1") + payload)
        await writer.drain()
