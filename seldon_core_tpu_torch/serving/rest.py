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
- ``GET /ready`` and ``GET /live``.

``engine`` is anything with ``async predict(SeldonMessage) ->
SeldonMessage`` and, for feedback, ``async send_feedback(Feedback) ->
SeldonMessage``.
"""

from __future__ import annotations

import asyncio
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from seldon_core_tpu_torch.messages import Feedback, SeldonMessage, Status

__all__ = ["RestServer"]

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}
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

    async def _call(self, body: bytes, kind, method):
        """Parse ``body`` as ``kind`` (SeldonMessage or Feedback), await
        ``method`` on it and answer its message."""
        if not body:
            return 400, _err_json(400, "empty request body"), \
                "application/json"
        try:
            # off the event loop: a large body (an image is 150,528 numbers)
            # takes tens of ms to decode, and connections whose bodies
            # arrive together would decode back to back in one pass of the
            # loop, holding the batcher's flush timers until all are done
            msg = await asyncio.get_running_loop().run_in_executor(
                self._decoder, _decode, kind, body)
        except Exception as e:
            return 400, _err_json(400, f"bad {kind.__name__}: {e}"), \
                "application/json"
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
