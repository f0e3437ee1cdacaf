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

The device plane (``runtime/device_plane.py``): a client with a plane
sends one hello per connection (``devicePlaneHello``: its process and
host tokens); a server answers with its own (``devicePlane``), plane or
not, and an old server answers it like any predict, without the key.  The
client then picks the tier (:func:`_pick_device_mode`): the same process
rides a registry ref (``loopback``), the same host a pooled shm lane of
the connection's own (``shm``), anything else bytes.  A request's tensor
then rides ``deviceRef`` in the meta blob instead of frame tensor 0; a
server with its plane on answers in the tier the request arrived on (a
pooled reply lane keyed by the client's lane), a plane-less one in bytes.
A ref the server cannot resolve comes back as an error naming
``DeviceTensorRef``: the client retries the request as bytes once and
stays on bytes for the connection, counted as a downgrade.

Trace context: the framed wire has no headers, so a client stamps the
ambient context's full ``traceparent`` (and ``tracestate``) into a
transport-side copy of the message's ``meta.tags`` (``trace-parent``,
``trace-state``); the server binds it for the target's call and strips
the transport-only tag, so it never echoes back in the answer.
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

from seldon_core_tpu_torch.messages import (
    Feedback,
    Meta,
    SeldonMessage,
    Status,
    dtype_name,
)
from seldon_core_tpu_torch.native import (
    MSG_ERROR,
    MSG_FEEDBACK,
    MSG_PREDICT,
    MSG_RESPONSE,
    Frame,
    FrameCodec,
    FramedServer,
)
from seldon_core_tpu_torch.runtime.device_registry import (
    host_token,
    process_token,
    registry,
)
from seldon_core_tpu_torch.utils.tracing import (
    TRACE_PARENT_TAG,
    TRACE_STATE_TAG,
    TRACEPARENT_HEADER,
    TRACESTATE_HEADER,
    current_trace,
    trace_from_meta,
    trace_headers,
    trace_scope,
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


def _device_ref_entry(msg: SeldonMessage, mode: str, plane,
                      lane=None) -> dict:
    """Register ``msg.data`` for the peer; the ``deviceRef`` blob entry.
    ``loopback`` hands over the tensor itself; ``shm`` stages one D2H onto
    the connection's ``lane`` when it holds one, else into a one-shot
    segment.  Raises ``ValueError`` for a payload shm cannot carry (an
    object array): the caller sends bytes."""
    nbytes = int(msg.nbytes or 0)
    if mode == "loopback":
        ref = registry.put(msg.data)
        if plane is not None:
            # the serialize, socket and parse round trip never happens; a
            # tensor's D2H is skipped too
            plane.note_avoided(
                "d2h" if msg.is_device_resident else "copy", nbytes)
    elif lane is not None:
        ref = lane.put(msg.data)
    else:
        ref = registry.put_shm(msg.data)
    if plane is not None:
        plane.note_remote_ref(mode)
    return {"ref": ref, "shape": list(msg.shape or ()),
            "dtype": dtype_name(getattr(msg.data, "dtype", "float32")),
            "nbytes": nbytes}


def encode_message(codec: FrameCodec, msg: SeldonMessage,
                   msg_type: int = MSG_PREDICT, device_mode: str = "off",
                   device_plane=None, device_lane=None) -> bytes:
    tensors = []
    blob = _meta_blob(msg)
    if msg.data is not None:
        if device_mode in ("loopback", "shm"):
            try:
                blob["deviceRef"] = _device_ref_entry(
                    msg, device_mode, device_plane, lane=device_lane)
            except ValueError:
                if device_plane is not None:
                    device_plane.note_downgrade("dtype")
                tensors.append(msg.data)
        else:
            tensors.append(msg.data)
    meta = json.dumps(blob).encode()
    return codec.encode(msg_type, meta=meta, tensors=tensors)


def decode_message(frame: Frame, device_plane=None) -> SeldonMessage:
    blob = json.loads(frame.meta) if frame.meta else {}
    msg = SeldonMessage(encoding="binTensor")
    wire_mode = "off"
    peer_lane = ""
    dref = blob.pop("deviceRef", None)
    if dref is not None:
        ref = str(dref.get("ref", ""))
        # raises ForeignProcessRef / KeyError when the ref cannot resolve
        # here: the server's error frame carries it back to the sender
        msg.data = registry.resolve(ref)  # graphlint: disable=RL703
        if ref.startswith("shmc:"):
            wire_mode = "shm"
            peer_lane = ref.split(":", 2)[1]
        elif ref.startswith("shm:"):
            wire_mode = "shm"
        else:
            wire_mode = "loopback"
        if device_plane is not None and wire_mode == "loopback":
            device_plane.note_donation()  # the one-shot entry is freed
    elif frame.tensors:
        msg.data = frame.tensors[0]
    _apply_blob(msg, blob)
    # transport-internal: a server answers in the tier the request came
    # on; a named peer lane keys the server's pooled reply lane
    msg.device_wire_mode = wire_mode
    msg.device_peer_lane = peer_lane
    return msg


class _ReplyLanes:
    """A server's reply lanes, keyed by the client's inbound lane name (one
    client connection, one inbound lane, one reply lane).  Bounded LRU: an
    evicted lane is made again at the client's next request."""

    def __init__(self, cap: int = 128):
        self._lanes: dict = {}
        self._order: list = []
        self._cap = cap
        self._lock = threading.Lock()

    def get(self, peer: str):
        with self._lock:
            lane = self._lanes.get(peer)
            if lane is None:
                lane = registry.channel()
                self._lanes[peer] = lane
            else:
                self._order.remove(peer)
            self._order.append(peer)
            evicted = []
            while len(self._order) > self._cap:
                old = self._order.pop(0)
                evicted.append(self._lanes.pop(old))
        for lane_ in evicted:
            lane_.close()
        return lane

    def close_all(self) -> None:
        with self._lock:
            lanes, self._lanes, self._order = \
                list(self._lanes.values()), {}, []
        for lane in lanes:
            lane.close()


def _plane_hello_msg() -> SeldonMessage:
    return SeldonMessage(json_data={"devicePlaneHello": {
        "token": process_token(), "host": host_token()}})


def _is_plane_hello(msg: SeldonMessage) -> bool:
    return isinstance(msg.json_data, dict) and \
        "devicePlaneHello" in msg.json_data


def _plane_hello_reply() -> SeldonMessage:
    return SeldonMessage(json_data={"devicePlane": {
        "token": process_token(), "host": host_token()}})


def _pick_device_mode(reply: SeldonMessage, plane) -> str:
    """The client's side of the negotiation: the server's identity against
    ours, under the plane's ``remote`` cap.  A reply without
    ``devicePlane`` (an old server) negotiates to ``off``."""
    info = None
    if isinstance(reply.json_data, dict):
        info = reply.json_data.get("devicePlane")
    if not isinstance(info, dict):
        if plane is not None:
            plane.note_downgrade("negotiation")
        return "off"
    cap = plane.config.remote if plane is not None else "auto"
    if info.get("token") == process_token() and cap in ("auto", "loopback"):
        return "loopback"
    if info.get("host") == host_token() and cap in ("auto", "shm"):
        return "shm"
    if plane is not None:
        plane.note_downgrade("foreign-process")
    return "off"


def _wants_hello(plane) -> bool:
    return plane is not None and plane.enabled and \
        plane.config.remote != "off"


def _reply_mode(plane, msg: SeldonMessage) -> str:
    """Answer in the tier the request arrived on (an inbound ref that
    resolved proves the way back resolves too); a plane-less server
    always answers in bytes."""
    if plane is None or not plane.enabled:
        return "off"
    return getattr(msg, "device_wire_mode", "off")


def _is_ref_failure(e: Exception, mode: str) -> bool:
    return mode != "off" and "DeviceTensorRef" in str(e)


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


def _traced_copy(msg: SeldonMessage) -> SeldonMessage:
    """A transport-side copy with the ambient trace context stamped into
    ``meta.tags`` (the full traceparent rides the meta blob).  The caller's
    message is never changed: span ids differ between walk and fused runs,
    so they must not reach the payload the engine sees."""
    ctx = current_trace()
    if ctx is None:
        return msg
    h = trace_headers(ctx)
    m = msg.meta
    tags = {**m.tags, TRACE_PARENT_TAG: h[TRACEPARENT_HEADER]}
    if TRACESTATE_HEADER in h:
        tags[TRACE_STATE_TAG] = h[TRACESTATE_HEADER]
    meta2 = Meta(puid=m.puid, tags=tags, routing=dict(m.routing),
                 request_path=dict(m.request_path), metrics=list(m.metrics))
    return SeldonMessage(
        data=msg.data, names=list(msg.names), bin_data=msg.bin_data,
        str_data=msg.str_data, json_data=msg.json_data, meta=meta2,
        status=msg.status, encoding=msg.encoding)


def _bind_trace(msg: SeldonMessage):
    """Server side: the wire's trace context, bound for the call, with the
    transport-only tag stripped (it must not echo back in the answer)."""
    ctx = trace_from_meta(msg.meta)
    msg.meta.tags.pop(TRACE_PARENT_TAG, None)
    return trace_scope(ctx)


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

    def __init__(self, target, port: int = 0, bind: str = "127.0.0.1",
                 device_plane=None):
        self._codec = FrameCodec()
        self._target = target
        self._server = FramedServer(self._handle, port=port, bind=bind)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self.device_plane = device_plane
        self._reply_lanes = _ReplyLanes()
        if device_plane is not None and device_plane.enabled:
            # a dead producer's exports outlive both processes: boot is
            # where they are reaped
            registry.reap_orphan_shm()

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
            lane = None
            if frame.msg_type == MSG_FEEDBACK:
                fb = decode_feedback(frame)
                for part in (fb.request, fb.response, fb.truth):
                    if part is not None:
                        _writable(part)
                out = self._result(self._target.send_feedback(fb))
                out = out if out is not None else SeldonMessage()
                mode = "off"
            else:
                msg = decode_message(frame, self.device_plane)
                if _is_plane_hello(msg):
                    return encode_message(self._codec, _plane_hello_reply(),
                                          MSG_RESPONSE)
                _writable(msg)
                with _bind_trace(msg):
                    out = self._result(self._target.predict(msg))
                mode = _reply_mode(self.device_plane, msg)
                if mode == "shm" and msg.device_peer_lane:
                    # a pooled request gets a pooled reply
                    lane = self._reply_lanes.get(msg.device_peer_lane)
            return encode_message(self._codec, out, MSG_RESPONSE,
                                  device_mode=mode,
                                  device_plane=self.device_plane,
                                  device_lane=lane)
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
        self._reply_lanes.close_all()
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

    def __init__(self, target, port: int = 0, bind: str = "127.0.0.1",
                 device_plane=None):
        self._codec = FrameCodec()
        self._target = target
        self._port_req = port
        self._bind = bind
        self._server: Optional[asyncio.base_events.Server] = None
        self.device_plane = device_plane
        self._reply_lanes = _ReplyLanes()
        if device_plane is not None and device_plane.enabled:
            registry.reap_orphan_shm()

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
        self._reply_lanes.close_all()

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
            lane = None
            if frame.msg_type == MSG_FEEDBACK:
                fb = decode_feedback(frame)
                for part in (fb.request, fb.response, fb.truth):
                    if part is not None:
                        _writable(part)
                out = self._target.send_feedback(fb)
                if inspect.isawaitable(out):
                    out = await out
                out = out if out is not None else SeldonMessage()
                mode = "off"
            else:
                msg = decode_message(frame, self.device_plane)
                if _is_plane_hello(msg):
                    return encode_message(self._codec, _plane_hello_reply(),
                                          MSG_RESPONSE)
                _writable(msg)
                with _bind_trace(msg):
                    out = self._target.predict(msg)
                    if inspect.isawaitable(out):  # an engine, a batch
                        out = await out
                mode = _reply_mode(self.device_plane, msg)
                if mode == "shm" and msg.device_peer_lane:
                    lane = self._reply_lanes.get(msg.device_peer_lane)
            return encode_message(self._codec, out, MSG_RESPONSE,
                                  device_mode=mode,
                                  device_plane=self.device_plane,
                                  device_lane=lane)
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
    ``timeout`` bounds every round trip; ``device_plane`` negotiates the
    connection's ref tier at connect (module docstring)."""

    def __init__(self, timeout: float = 30.0, device_plane=None):
        self._codec = FrameCodec()
        self._reader = None
        self._writer = None
        self._lock: Optional[asyncio.Lock] = None  # made on connect
        self._timeout = timeout
        self._device_plane = device_plane
        self._device_mode = "off"
        self._lane = None
        self._lane_lock: Optional[asyncio.Lock] = None

    async def connect(self, host: str = "127.0.0.1", port: int = 0
                      ) -> "AsyncFramedClient":
        self._reader, self._writer = await asyncio.open_connection(host, port)
        self._lock = asyncio.Lock()
        self._lane_lock = asyncio.Lock()
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        plane = self._device_plane
        if _wants_hello(plane):
            # one hello decides the tier for the connection; any failure
            # negotiates to bytes
            try:
                reply = decode_message(await self._roundtrip(encode_message(
                    self._codec, _plane_hello_msg(), MSG_PREDICT)))
                self._device_mode = _pick_device_mode(reply, plane)
            except Exception:
                plane.note_downgrade("negotiation")
                self._device_mode = "off"
        if self._device_mode == "shm":
            self._lane = registry.channel()
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
        # staging onto the lane is serialized with the round trip that
        # licenses its reuse (the reply proves the server copied it off)
        msg = _traced_copy(msg)
        async with self._lane_lock:
            payload = encode_message(
                self._codec, msg, MSG_PREDICT, device_mode=self._device_mode,
                device_plane=self._device_plane, device_lane=self._lane)
            try:
                return decode_message(await self._roundtrip(payload),
                                      self._device_plane)
            except RuntimeError as e:
                if not _is_ref_failure(e, self._device_mode):
                    raise
                # the peer could not resolve our ref: bytes from now on,
                # and the same request again
                self._device_plane.note_downgrade("resolve-failed")
                self._device_mode = "off"
                self._close_lane()
                return decode_message(await self._roundtrip(encode_message(
                    self._codec, msg, MSG_PREDICT)), self._device_plane)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        return decode_message(await self._roundtrip(
            encode_feedback(self._codec, fb)))

    def _close_lane(self) -> None:
        if self._lane is not None:
            self._lane.close()
            self._lane = None

    def close(self) -> None:
        self._close_lane()
        if self._writer is not None:
            self._writer.close()


class FramedClient:
    """Blocking client of the framed protocol (one connection).
    ``timeout`` bounds the connect and every round trip (``None`` blocks
    for ever); ``predict(msg, timeout=...)`` overrides it for one call."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = 30.0, device_plane=None):
        self._codec = FrameCodec()
        self._timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._device_plane = device_plane
        self._device_mode = "off"
        self._lane = None
        self._lane_lock = threading.Lock()
        if _wants_hello(device_plane):
            try:
                reply = decode_message(self._roundtrip(encode_message(
                    self._codec, _plane_hello_msg(), MSG_PREDICT)))
                self._device_mode = _pick_device_mode(reply, device_plane)
            except Exception:
                device_plane.note_downgrade("negotiation")
                self._device_mode = "off"
        if self._device_mode == "shm":
            # the connection's lane: one segment rewritten per message
            self._lane = registry.channel()

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
        # the lane is rewritten in place: message N+1 is staged only after
        # N's reply proved the server copied N off
        msg = _traced_copy(msg)
        with self._lane_lock:
            payload = encode_message(
                self._codec, msg, MSG_PREDICT, device_mode=self._device_mode,
                device_plane=self._device_plane, device_lane=self._lane)
            try:
                return decode_message(
                    self._roundtrip(payload, timeout=timeout),
                    self._device_plane)
            except RuntimeError as e:
                if not _is_ref_failure(e, self._device_mode):
                    raise
                self._device_plane.note_downgrade("resolve-failed")
                self._device_mode = "off"
                self._close_lane()
                return decode_message(
                    self._roundtrip(encode_message(self._codec, msg,
                                                   MSG_PREDICT),
                                    timeout=timeout),
                    self._device_plane)

    def _close_lane(self) -> None:
        if self._lane is not None:
            self._lane.close()
            self._lane = None

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
        self._close_lane()
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FramedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
