"""Southbound clients: call remote graph components over REST (port of
``seldon_core_tpu/serving/client.py``).

:class:`RemoteComponent` has the method surface of an in-process
``ComponentHandle``, async, so a graph mixes local nodes and remote pods:
``predict``, ``transform_input``, ``transform_output``, ``route``,
``aggregate``, ``send_feedback``, ``has`` and ``stream`` (the remote's
server-sent events as an async generator of event dicts).
:class:`ExternalClient` calls an engine's external API.

Both run on :class:`HttpClient`, an asyncio HTTP/1.1 client of the port's
own with a pool of keep-alive connections (the reference's runs on
aiohttp, which the card's machine does not have).  It reads bodies with a
``Content-Length``, chunked bodies and bodies that end with the
connection, so it talks to the port's servers and the reference's alike.

Errors map as the reference's do, to :class:`SeldonComponentError`: a
remote FAILURE status keeps its code and reason; a connect timeout or a
broken connection is 503 ``TRANSPORT``; a reply slower than the read
timeout is 504 ``DEADLINE_EXCEEDED``; a body that is not a JSON object
takes the HTTP status (502 below 400) with ``TRANSPORT``.

The device plane (``device_plane=``, a ``runtime.device_plane.
DevicePlane``): every answer of a port or reference server names its
process in ``X-Seldon-Device-Plane`` (``<process token>|<host token>``).
Once a peer has named itself, a request's tensor to a peer in this process
rides a registry ref, to a peer on this host a one-shot shm segment
(``deviceRef``), else bytes; the first request always rides bytes, so
negotiation costs no round trip.  A peer that cannot resolve the ref
answers an error naming ``DeviceTensorRef``: the client retries the same
request as bytes and stays on bytes for that peer, counted as a
downgrade.  A meta-only route call (``route_meta_only``) sends no tensor
at all, and so never copies one from the card.

Every call of a :class:`RemoteComponent` carries the ambient trace context
as W3C ``traceparent`` / ``tracestate`` headers (the engine's node span
open for the hop becomes the remote process's parent).
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
from typing import AsyncIterator, Optional, Sequence
from urllib.parse import urlsplit

from seldon_core_tpu_torch.messages import (
    DeviceTensorRef,
    Feedback,
    SeldonMessage,
    dtype_name,
)
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.utils.tracing import current_trace, trace_headers

__all__ = ["HttpClient", "HttpError", "RemoteComponent", "ExternalClient",
           "DEVICE_PLANE_HEADER", "plane_identity"]

#: the answer header naming the server's process for the device plane
DEVICE_PLANE_HEADER = "X-Seldon-Device-Plane"


def plane_identity() -> str:
    """``<process token>|<host token>``: this process, for the header."""
    from seldon_core_tpu_torch.runtime.device_registry import (
        host_token,
        process_token,
    )

    return f"{process_token()}|{host_token()}"

logger = logging.getLogger(__name__)


class HttpError(Exception):
    """A transport failure (connection refused, reset, a malformed
    reply)."""


class ConnectTimeout(HttpError):
    pass


async def _read_head(reader) -> tuple[int, dict]:
    line = await reader.readline()
    if not line:
        raise HttpError("connection closed before the status line")
    parts = line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise HttpError(f"bad status line {line[:80]!r}")
    status = int(parts[1])
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise HttpError("connection closed in the headers")
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def _chunks(reader, headers: dict) -> AsyncIterator[bytes]:
    """The body's bytes as they arrive: chunked, ``Content-Length`` or up
    to the end of the connection."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size_line = await reader.readline()
            if not size_line:
                raise HttpError("connection closed in a chunked body")
            size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)  # CRLF
            yield data
    elif "content-length" in headers:
        n = int(headers["content-length"])
        if n:
            yield await reader.readexactly(n)
    else:
        while True:
            data = await reader.read(65536)
            if not data:
                return
            yield data


def _reusable(headers: dict) -> bool:
    return (headers.get("connection", "").lower() != "close"
            and ("content-length" in headers
                 or "chunked" in headers.get("transfer-encoding", "")))


class HttpClient:
    """HTTP/1.1 client for one host and port, with up to ``limit``
    connections, idle ones kept ``keepalive_s`` seconds for reuse."""

    def __init__(self, host: str, port: int, limit: int = 128,
                 keepalive_s: float = 30.0,
                 connect_timeout_s: Optional[float] = None):
        self.host = host
        self.port = port
        self.keepalive_s = keepalive_s
        self.connect_timeout_s = connect_timeout_s
        self._limit = limit
        self._idle: list = []  # (reader, writer, idle since)
        self._loop = None
        self._sem: Optional[asyncio.Semaphore] = None

    def _bind_loop(self) -> None:
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            # connections of an earlier loop cannot be used from this one
            self._loop = loop
            self._idle = []
            self._sem = asyncio.Semaphore(self._limit)

    async def _connect(self, connect_timeout_s: Optional[float]):
        try:
            return await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                connect_timeout_s)
        except asyncio.TimeoutError:
            raise ConnectTimeout(
                f"connect to {self.host}:{self.port} timed out after "
                f"{connect_timeout_s}s") from None
        except OSError as e:
            raise HttpError(f"cannot connect to {self.host}:{self.port}: "
                            f"{e}") from None

    async def _acquire(self):
        """An idle pooled connection (reused: True) or a new one."""
        now = self._loop.time()
        while self._idle:
            reader, writer, since = self._idle.pop()
            if now - since < self.keepalive_s and not reader.at_eof() \
                    and not writer.is_closing():
                return reader, writer, True
            writer.close()
        reader, writer = await self._connect(self.connect_timeout_s)
        return reader, writer, False

    def _release(self, reader, writer) -> None:
        self._idle.append((reader, writer, self._loop.time()))

    def _head(self, method: str, path: str, body: bytes,
              headers: Optional[dict]) -> bytes:
        lines = [f"{method} {path} HTTP/1.1", f"Host: {self.host}",
                 f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def request(self, method: str, path: str, body: bytes = b"",
                      headers: Optional[dict] = None
                      ) -> tuple[int, dict, bytes]:
        """``(status, headers, body)``.  A reused connection that the server
        closed meanwhile is retried once on a new one."""
        self._bind_loop()
        async with self._sem:
            for attempt in range(2):
                reader, writer, reused = await self._acquire()
                ok = False
                try:
                    writer.write(self._head(method, path, body, headers)
                                 + body)
                    await writer.drain()
                    try:
                        status, rh = await _read_head(reader)
                    except (HttpError, ConnectionError) as e:
                        if reused and attempt == 0:
                            continue  # a stale keep-alive connection
                        raise HttpError(str(e)) from None
                    data = b"".join([c async for c in _chunks(reader, rh)])
                    ok = _reusable(rh)
                    return status, rh, data
                except (ConnectionError, asyncio.IncompleteReadError) as e:
                    if reused and attempt == 0 and not isinstance(
                            e, asyncio.IncompleteReadError):
                        continue
                    raise HttpError(f"{type(e).__name__}: {e}") from None
                finally:
                    if ok:
                        self._release(reader, writer)
                    else:
                        writer.close()
            raise HttpError("unreachable")  # pragma: no cover

    async def stream_lines(self, method: str, path: str, body: bytes,
                           headers: Optional[dict] = None,
                           connect_timeout_s: Optional[float] = 10.0):
        """Open a request on a connection of its own and return ``(status,
        headers, lines)``: ``lines`` is an async generator of the body's
        lines; closing it closes the connection."""
        self._bind_loop()
        reader, writer = await self._connect(connect_timeout_s)
        try:
            writer.write(self._head(method, path, body, headers) + body)
            await writer.drain()
            status, rh = await _read_head(reader)
        except BaseException:
            writer.close()
            raise

        async def lines():
            buf = b""
            try:
                async for data in _chunks(reader, rh):
                    buf += data
                    while b"\n" in buf:
                        line, _, buf = buf.partition(b"\n")
                        yield line + b"\n"
                if buf:
                    yield buf
            finally:
                writer.close()

        return status, rh, lines()

    async def close(self) -> None:
        idle, self._idle = self._idle, []
        for _, writer, _ in idle:
            writer.close()


def _split_url(base_url: str) -> tuple[str, int, str]:
    u = urlsplit(base_url)
    if u.scheme not in ("http", ""):
        raise ValueError(f"only http:// endpoints are served: {base_url}")
    return u.hostname or "127.0.0.1", u.port or 80, u.path.rstrip("/")


class RemoteComponent:
    """REST client of one remote component endpoint."""

    def __init__(self, base_url: str, name: str = "", timeout_s: float = 30.0,
                 connect_timeout_s: Optional[float] = None,
                 methods: Sequence[str] = (), route_meta_only: bool = False,
                 device_plane=None):
        """``timeout_s`` / ``connect_timeout_s`` are the reference's
        ``seldon.io/rest-read-timeout`` / ``rest-connection-timeout``
        annotations in seconds: a reply past the deadline sheds with 504
        ``DEADLINE_EXCEEDED`` instead of stalling the graph walk.  A
        tensor goes out in the encoding its message carries, so a
        ``binTensor`` request stays ``binTensor`` on the hop and an
        ``ndarray`` one goes out as the reference sends it.
        ``route_meta_only`` strips the tensor from ``/route`` calls, for a
        router whose decision reads meta and names only.  ``device_plane``
        turns on the per-peer ``deviceRef`` fast path (module
        docstring)."""
        self.base_url = base_url.rstrip("/")
        self.name = name or self.base_url
        host, port, self._prefix = _split_url(self.base_url)
        self.timeout_s = timeout_s
        self._methods = set(methods)
        self.route_meta_only = route_meta_only
        self._http = HttpClient(host, port,
                                connect_timeout_s=connect_timeout_s)
        self.device_plane = device_plane
        #: the peer's latest identity header
        self._peer_plane: Optional[str] = None
        #: bytes only, for good, after a failed ref resolution
        self._device_disabled = False

    def has(self, method: str) -> bool:
        # without a declared methods list, the remote is taken to support
        # what its graph role requires (methods[] is optional)
        return method in self._methods if self._methods else True

    async def close(self) -> None:
        await self._http.close()

    async def _post(self, path: str, payload: dict) -> dict:
        body = _json.dumps(payload).encode()
        try:
            status, headers, raw = await asyncio.wait_for(
                self._http.request("POST", self._prefix + path, body,
                                   {"Content-Type": "application/json",
                                    **trace_headers(current_trace())}),
                self.timeout_s)
            peer = headers.get(DEVICE_PLANE_HEADER.lower())
            if peer:
                self._peer_plane = peer
        except ConnectTimeout as e:
            # an unreachable backend is "down" (503), not "slow"
            raise SeldonComponentError(
                f"{self.name}{path} connect timeout: {e}", 503, "TRANSPORT")
        except asyncio.TimeoutError:
            raise SeldonComponentError(
                f"{self.name}{path} read timeout after {self.timeout_s}s",
                504, "DEADLINE_EXCEEDED")
        except HttpError as e:
            raise SeldonComponentError(
                f"{self.name}{path} transport error: {e}", 503, "TRANSPORT")
        try:
            out = _json.loads(raw)
            if not isinstance(out, dict):
                raise ValueError("non-object JSON")
        except ValueError:
            # a proxy's error page, a 404 text: classify by the status
            raise SeldonComponentError(
                f"{self.name}{path} -> HTTP {status} (non-JSON body)",
                status if status >= 400 else 502, "TRANSPORT")
        return out

    @staticmethod
    def _decode(d: dict) -> SeldonMessage:
        out = SeldonMessage.from_dict(d)
        if out.status is not None and out.status.status == "FAILURE":
            raise SeldonComponentError(out.status.info or "remote failure",
                                       out.status.code or 500,
                                       out.status.reason)
        return out

    # ---- device-plane fast path ---------------------------------------
    def _device_mode(self) -> str:
        """This peer's tier right now (``loopback`` | ``shm`` | ``off``):
        its latest identity header under the plane's ``remote`` cap."""
        plane = self.device_plane
        if plane is None or not plane.enabled or self._device_disabled:
            return "off"
        cap = plane.config.remote
        if cap == "off" or not self._peer_plane:
            return "off"
        from seldon_core_tpu_torch.runtime.device_registry import (
            host_token,
            process_token,
        )

        token, _, host = self._peer_plane.partition("|")
        if token == process_token() and cap in ("auto", "loopback"):
            return "loopback"
        if host and host == host_token() and cap in ("auto", "shm"):
            return "shm"
        return "off"

    def _encode_maybe_device(self, msg: SeldonMessage) -> tuple:
        """``(payload, used_ref)``: ``msg`` for the wire, its tensor as a
        ``deviceRef`` when this peer's tier allows."""
        mode = self._device_mode()
        if mode == "off" or msg.data is None:
            return msg.to_dict(), False
        from seldon_core_tpu_torch.runtime.device_registry import registry

        plane = self.device_plane
        nbytes = int(msg.nbytes or 0)
        try:
            if mode == "loopback":
                ref = registry.put(msg.data)
                plane.note_avoided(
                    "d2h" if msg.is_device_resident else "copy", nbytes)
            else:
                ref = registry.put_shm(msg.data)  # one D2H
        except ValueError:
            # an object array: shm cannot carry it
            plane.note_downgrade("dtype")
            return msg.to_dict(), False
        plane.note_remote_ref(mode)
        payload = SeldonMessage(names=list(msg.names), meta=msg.meta,
                                status=msg.status).to_dict()
        payload["data"] = {
            "names": list(msg.names),
            "deviceRef": DeviceTensorRef(
                ref=ref, shape=tuple(msg.shape or ()),
                dtype=dtype_name(getattr(msg.data, "dtype", "float32")),
                nbytes=nbytes).to_dict()}
        return payload, True

    async def _msg_call(self, path: str, msg: SeldonMessage
                        ) -> SeldonMessage:
        payload, used_ref = self._encode_maybe_device(msg)
        try:
            return self._decode(await self._post(path, payload))
        except SeldonComponentError as e:
            if not used_ref or "DeviceTensorRef" not in str(e):
                raise
            # the peer could not resolve the ref: bytes for this peer from
            # now on, and the same request again
            self.device_plane.note_downgrade("resolve-failed")
            self._device_disabled = True
            return self._decode(await self._post(path, msg.to_dict()))

    # ---- component surface --------------------------------------------
    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._msg_call("/predict", msg)

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._msg_call("/transform-input", msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._msg_call("/transform-output", msg)

    async def route(self, msg: SeldonMessage) -> int:
        if self.route_meta_only and msg.data is not None:
            # the router's decision reads no values: no tensor goes out,
            # and a tensor on the card is never copied to the host
            if self.device_plane is not None and msg.is_device_resident:
                self.device_plane.note_avoided("d2h", int(msg.nbytes or 0))
            msg = SeldonMessage(names=list(msg.names), meta=msg.meta)
        data = (await self._msg_call("/route", msg)).host_data()
        if data is None:
            return -1
        return int(data.ravel()[0])

    async def aggregate(self, msgs: Sequence[SeldonMessage]
                        ) -> SeldonMessage:
        encoded = [self._encode_maybe_device(m) for m in msgs]
        try:
            return self._decode(await self._post(
                "/aggregate", {"seldonMessages": [p for p, _ in encoded]}))
        except SeldonComponentError as e:
            if not any(u for _, u in encoded) or \
                    "DeviceTensorRef" not in str(e):
                raise
            # refs the peer resolved before failing are consumed; the
            # tensors are still in hand, so everything goes again as bytes
            # (unresolved refs age out by the registry's TTL)
            self.device_plane.note_downgrade("resolve-failed")
            self._device_disabled = True
            return self._decode(await self._post(
                "/aggregate", {"seldonMessages": [m.to_dict()
                                                  for m in msgs]}))

    async def send_feedback(self, fb: Feedback) -> Optional[SeldonMessage]:
        d = await self._post("/send-feedback", fb.to_dict())
        try:
            return SeldonMessage.from_dict(d)
        except Exception:
            return None

    async def stream(self, msg: SeldonMessage):
        """The remote's ``/stream`` server-sent events as an async
        generator of event dicts, so an out-of-process LLM streams through
        the engine like an in-process one.  No read deadline (generation
        length is the request's); the connect times out after 10 s.
        Closing the generator closes the connection, which ends the remote
        request."""
        body = _json.dumps(msg.to_dict()).encode()
        try:
            status, headers, lines = await self._http.stream_lines(
                "POST", self._prefix + "/stream", body,
                {"Content-Type": "application/json",
                 **trace_headers(current_trace())})
        except HttpError as e:
            raise SeldonComponentError(
                f"{self.name}/stream transport error: {e}", 503, "TRANSPORT")
        try:
            ctype = headers.get("content-type", "").split(";")[0].strip()
            if ctype != "text/event-stream":
                raise SeldonComponentError(
                    f"{self.name}/stream -> HTTP {status} "
                    "(remote has no stream route?)",
                    501 if status == 404 else status,
                    "STREAM_UNSUPPORTED" if status == 404 else "TRANSPORT")
            try:
                async for line in lines:
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    event = _json.loads(line[6:])
                    if isinstance(event, dict) and set(event) == {"error"}:
                        # the remote's mid-stream failure event
                        raise SeldonComponentError(event["error"], 500,
                                                   "STREAM")
                    yield event
            except (HttpError, ConnectionError,
                    asyncio.IncompleteReadError) as e:
                raise SeldonComponentError(
                    f"{self.name}/stream transport error: {e}", 503,
                    "TRANSPORT")
        finally:
            await lines.aclose()


class ExternalClient:
    """Client of an engine's external prediction API."""

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 token: str = ""):
        self.base_url = base_url.rstrip("/")
        host, port, self._prefix = _split_url(self.base_url)
        self.timeout_s = timeout_s
        self.token = token
        self._http = HttpClient(host, port)

    async def close(self) -> None:
        await self._http.close()

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    async def _call(self, path: str, body: str) -> SeldonMessage:
        _, _, raw = await asyncio.wait_for(
            self._http.request("POST", self._prefix + path, body.encode(),
                               self._headers()), self.timeout_s)
        return SeldonMessage.from_dict(_json.loads(raw))

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("/api/v0.1/predictions", msg.to_json())

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        return await self._call("/api/v0.1/feedback", fb.to_json())
