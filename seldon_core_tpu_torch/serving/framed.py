"""Framed binary transport: SeldonMessage over SELF frames (port of the host
tier of ``seldon_core_tpu/serving/framed.py``).

The frames are the native codec's (:mod:`seldon_core_tpu_torch.native`),
byte for byte the reference's, so a port client talks to a reference
server and the other way round.  Each frame is sent as a 4-byte
little-endian length and the frame.

Mapping: a SeldonMessage's ``data`` rides as frame tensor 0 at its own
dtype and width (a torch tensor on the card is copied to the host once);
``names``, ``meta``, ``binData`` / ``strData`` / ``jsonData`` and
``status`` ride in the JSON meta blob.  A feedback frame carries request,
response and truth as tensors with their blobs under ``parts``.

- :class:`FramedComponentServer`: the native epoll server runs the handler
  on its IO thread (right for a component that answers in microseconds or
  on the card; an async target runs on the server's own event loop);
- :class:`AsyncFramedComponentServer`: one asyncio task per connection
  awaiting the target on the caller's loop, so N connections put N
  requests into a dynamic batcher at once;
- :class:`AsyncFramedClient` and :class:`FramedClient`: one connection
  each, strict request and response.

Device-tensor references (``deviceRef`` in the meta blob, the device
plane) are refused with an error naming slice 4e of the port; trace
context in the blob waits for slice 5.
"""

from __future__ import annotations

import asyncio
import base64
import inspect
import json
import socket
import struct
import threading
from typing import Optional

import numpy as np

from seldon_core_tpu_torch.messages import Feedback, Meta, SeldonMessage, Status
from seldon_core_tpu_torch.native import (
    MSG_ERROR,
    MSG_FEEDBACK,
    MSG_PREDICT,
    MSG_RESPONSE,
    Frame,
    FrameCodec,
    FramedServer,
)

__all__ = [
    "encode_message",
    "decode_message",
    "encode_feedback",
    "decode_feedback",
    "FramedComponentServer",
    "AsyncFramedComponentServer",
    "FramedClient",
    "AsyncFramedClient",
]


def _meta_blob(msg: SeldonMessage) -> dict:
    blob: dict = {}
    if msg.names:
        blob["names"] = list(msg.names)
    md = msg.meta.to_dict()
    if md:
        blob["meta"] = md
    if msg.status is not None:
        blob["status"] = msg.status.to_dict()
    if msg.bin_data is not None:
        blob["binData"] = base64.b64encode(msg.bin_data).decode("ascii")
    elif msg.str_data is not None:
        blob["strData"] = msg.str_data
    elif msg.json_data is not None:
        blob["jsonData"] = msg.json_data
    return blob


def _apply_blob(msg: SeldonMessage, blob: dict) -> SeldonMessage:
    msg.names = list(blob.get("names", []))
    msg.meta = Meta.from_dict(blob.get("meta"))
    if "status" in blob:
        msg.status = Status.from_dict(blob["status"])
    if "binData" in blob:
        msg.bin_data = base64.b64decode(blob["binData"])
    elif "strData" in blob:
        msg.str_data = blob["strData"]
    elif "jsonData" in blob:
        msg.json_data = blob["jsonData"]
    return msg


def encode_message(codec: FrameCodec, msg: SeldonMessage,
                   msg_type: int = MSG_PREDICT) -> bytes:
    tensors = [] if msg.data is None else [msg.data]
    meta = json.dumps(_meta_blob(msg)).encode()
    return codec.encode(msg_type, meta=meta, tensors=tensors)


def decode_message(frame: Frame) -> SeldonMessage:
    blob = json.loads(frame.meta) if frame.meta else {}
    if "deviceRef" in blob:
        raise ValueError("deviceRef payloads (the device plane) come with "
                         "slice 4e of the port")
    msg = SeldonMessage(encoding="binTensor")
    if frame.tensors:
        msg.data = frame.tensors[0]
    return _apply_blob(msg, blob)


def encode_feedback(codec: FrameCodec, fb: Feedback) -> bytes:
    tensors: list = []
    blob: dict = {"reward": fb.reward, "parts": {}}
    for key, part in (("request", fb.request), ("response", fb.response),
                      ("truth", fb.truth)):
        if part is None:
            continue
        entry: dict = {"blob": _meta_blob(part)}
        if part.data is not None:
            entry["tensor"] = len(tensors)
            tensors.append(part.data)
        blob["parts"][key] = entry
    return codec.encode(MSG_FEEDBACK, meta=json.dumps(blob).encode(),
                        tensors=tensors)


def decode_feedback(frame: Frame) -> Feedback:
    blob = json.loads(frame.meta) if frame.meta else {}
    fb = Feedback(reward=float(blob.get("reward", 0.0)))
    for key in ("request", "response", "truth"):
        entry = blob.get("parts", {}).get(key)
        if entry is None:
            continue
        msg = SeldonMessage(encoding="binTensor")
        if "tensor" in entry:
            msg.data = frame.tensors[entry["tensor"]]
        _apply_blob(msg, entry.get("blob", {}))
        setattr(fb, key, msg)
    return fb


def _writable(msg: SeldonMessage) -> None:
    """A decoded array is a read-only view over the receive buffer; a user
    component may change its input in place, so it gets its own copy."""
    d = msg.data
    if isinstance(d, np.ndarray) and not d.flags.writeable:
        msg.data = np.array(d)


def _error_frame(codec: FrameCodec, e: Exception) -> bytes:
    err = SeldonMessage(status=Status.failure(500, str(e)))
    return encode_message(codec, err, MSG_ERROR)


class FramedComponentServer:
    """Serve a component (or an engine) over the framed protocol on the
    native epoll server.  The handler runs on the server's IO thread; a
    target whose methods are async runs on an event loop of the server's
    own, kept for its lifetime (a dynamic batcher's timers live there)."""

    def __init__(self, target, port: int = 0, bind: str = "127.0.0.1"):
        self._codec = FrameCodec()
        self._target = target
        self._server = FramedServer(self._handle, port=port, bind=bind)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None

    def _result(self, x):
        if not inspect.isawaitable(x):
            return x
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            self._loop_thread = threading.Thread(
                target=self._loop.run_forever, name="framed-loop",
                daemon=True)
            self._loop_thread.start()

        async def wrap():
            return await x

        return asyncio.run_coroutine_threadsafe(wrap(), self._loop).result()

    def _handle(self, req: bytes) -> bytes:
        try:
            frame = self._codec.decode(req)
            if frame.msg_type == MSG_FEEDBACK:
                fb = decode_feedback(frame)
                for part in (fb.request, fb.response, fb.truth):
                    if part is not None:
                        _writable(part)
                out = self._result(self._target.send_feedback(fb))
                out = out if out is not None else SeldonMessage()
            else:
                msg = decode_message(frame)
                _writable(msg)
                out = self._result(self._target.predict(msg))
            return encode_message(self._codec, out, MSG_RESPONSE)
        except Exception as e:  # every error goes on the wire
            return _error_frame(self._codec, e)

    def start(self) -> "FramedComponentServer":
        self._server.start()
        return self

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=5)
            self._loop.close()
            self._loop = None

    def __enter__(self) -> "FramedComponentServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class AsyncFramedComponentServer:
    """The framed protocol on asyncio: every connection is a task awaiting
    the target on the caller's loop; a connection's requests are answered
    in order."""

    def __init__(self, target, port: int = 0, bind: str = "127.0.0.1"):
        self._codec = FrameCodec()
        self._target = target
        self._port_req = port
        self._bind = bind
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> "AsyncFramedComponentServer":
        self._server = await asyncio.start_server(
            self._on_conn, self._bind, self._port_req)
        return self

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "AsyncFramedComponentServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def _on_conn(self, reader, writer) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                # a disconnect mid-header, mid-body or mid-reply is a
                # silent close
                try:
                    hdr = await reader.readexactly(4)
                    (n,) = struct.unpack("<I", hdr)
                    body = await reader.readexactly(n)
                    resp = await self._handle(body)
                    writer.write(struct.pack("<I", len(resp)) + resp)
                    await writer.drain()
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
        finally:
            writer.close()

    async def _handle(self, req: bytes) -> bytes:
        try:
            frame = self._codec.decode(req)
            if frame.msg_type == MSG_FEEDBACK:
                fb = decode_feedback(frame)
                for part in (fb.request, fb.response, fb.truth):
                    if part is not None:
                        _writable(part)
                out = self._target.send_feedback(fb)
                if inspect.isawaitable(out):
                    out = await out
                out = out if out is not None else SeldonMessage()
            else:
                msg = decode_message(frame)
                _writable(msg)
                out = self._target.predict(msg)
                if inspect.isawaitable(out):  # an engine, a batched model
                    out = await out
            return encode_message(self._codec, out, MSG_RESPONSE)
        except Exception as e:  # every error goes on the wire
            return _error_frame(self._codec, e)


def _raise_error(codec: FrameCodec, body: bytes) -> Frame:
    frame = codec.decode(body)
    if frame.msg_type == MSG_ERROR:
        msg = decode_message(frame)
        info = msg.status.info if msg.status else "remote error"
        raise RuntimeError(f"framed RPC failed: {info}")
    return frame


class AsyncFramedClient:
    """Asyncio client of the framed protocol (one connection).
    ``timeout`` bounds every round trip."""

    def __init__(self, timeout: float = 30.0):
        self._codec = FrameCodec()
        self._reader = None
        self._writer = None
        self._lock: Optional[asyncio.Lock] = None  # made on connect
        self._timeout = timeout

    async def connect(self, host: str = "127.0.0.1", port: int = 0
                      ) -> "AsyncFramedClient":
        self._reader, self._writer = await asyncio.open_connection(host, port)
        self._lock = asyncio.Lock()
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self

    async def _roundtrip(self, payload: bytes) -> Frame:
        # one request at a time: interleaved reads would swap replies
        async with self._lock:
            async def io() -> bytes:
                self._writer.write(struct.pack("<I", len(payload)) + payload)
                await self._writer.drain()
                hdr = await self._reader.readexactly(4)
                (n,) = struct.unpack("<I", hdr)
                return await self._reader.readexactly(n)

            body = await asyncio.wait_for(io(), self._timeout)
        return _raise_error(self._codec, body)

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return decode_message(await self._roundtrip(
            encode_message(self._codec, msg, MSG_PREDICT)))

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        return decode_message(await self._roundtrip(
            encode_feedback(self._codec, fb)))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class FramedClient:
    """Blocking client of the framed protocol (one connection).
    ``timeout`` bounds the connect and every round trip (``None`` blocks
    for ever); ``predict(msg, timeout=...)`` overrides it for one call."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = 30.0):
        self._codec = FrameCodec()
        self._timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _roundtrip(self, payload: bytes,
                   timeout: Optional[float] = None) -> Frame:
        eff = self._timeout if timeout is None else timeout
        if eff != self._timeout:
            self._sock.settimeout(eff)
        try:
            raw = self.ping_raw(payload)
        except TimeoutError:
            # the connection is now mid-frame and unusable
            raise TimeoutError(
                f"framed RPC timed out after {eff}s (connection must be "
                "discarded)") from None
        finally:
            if eff != self._timeout:
                self._sock.settimeout(self._timeout)
        return _raise_error(self._codec, raw)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            b = self._sock.recv(n)
            if not b:
                raise ConnectionError("connection closed mid-frame")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def predict(self, msg: SeldonMessage,
                timeout: Optional[float] = None) -> SeldonMessage:
        return decode_message(self._roundtrip(
            encode_message(self._codec, msg, MSG_PREDICT), timeout=timeout))

    def send_feedback(self, fb: Feedback,
                      timeout: Optional[float] = None) -> SeldonMessage:
        return decode_message(self._roundtrip(
            encode_feedback(self._codec, fb), timeout=timeout))

    def ping_raw(self, payload: bytes) -> bytes:
        """A raw frame's round trip (transport benchmarking)."""
        self._sock.sendall(struct.pack("<I", len(payload)) + payload)
        hdr = self._recv_exact(4)
        (n,) = struct.unpack("<I", hdr)
        return self._recv_exact(n)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FramedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
