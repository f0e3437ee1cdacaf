"""The native runtime core (the repository's ``native/*.cc``) through
``ctypes`` (port of ``seldon_core_tpu/native/__init__.py``).

- :class:`FrameCodec`: the binary tensor framing ("SELF" frames), byte for
  byte the reference's;
- :class:`FramedServer`: the epoll TCP server of the framed protocol;
- :class:`NativeHttpServer`: the epoll HTTP/1.1 server (REST) behind
  ``serving/native_http.py``;
- :class:`NativeBatchQueue`: the deadline and bucket batching queue;
- :func:`run_native_load`: the closed-loop REST or h2c gRPC load generator.

The library is built at first use, never at import: ``g++`` compiles each
source of ``native/`` with the flags of ``native/Makefile`` (one process
per source, all started together) into ``build/torch_native/`` at the root
of the repository, as ``libseldon_native_<hash>.so``; the hash covers the
sources and the flags, so an edited source rebuilds.  Nothing is written
into ``native/``, whose objects belong to the reference's own build.  A
build or load failure raises: there is no pure-Python stand-in.

Numpy has no bfloat16: a bfloat16 frame tensor decodes to a torch tensor
(``messages.array_from_buffer``), and a torch tensor of any dtype encodes
(``messages.wire_array``).
"""

from __future__ import annotations

import ctypes as C
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch.messages import array_from_buffer, wire_array

__all__ = [
    "load",
    "build",
    "build_stats",
    "FrameCodec",
    "Frame",
    "NativeBatchQueue",
    "FramedServer",
    "NativeHttpServer",
    "run_native_load",
    "MSG_PREDICT",
    "MSG_RESPONSE",
    "MSG_FEEDBACK",
    "MSG_ERROR",
    "MSG_PING",
]

ROOT = Path(__file__).resolve().parents[1]
SOURCE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "torch_native"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ["-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-pthread"]
LDFLAGS = ["-shared", "-pthread"]

MSG_PREDICT, MSG_RESPONSE, MSG_FEEDBACK, MSG_ERROR, MSG_PING = 1, 2, 3, 4, 5

MAX_TENSORS = 16
MAX_NDIM = 8

# dtype code <-> wire name (mirrors seldon_native.h SN_DT_*)
_DTYPES: list[tuple[int, str]] = [
    (0, "float32"),
    (1, "float64"),
    (2, "bfloat16"),
    (3, "float16"),
    (4, "int8"),
    (5, "int16"),
    (6, "int32"),
    (7, "int64"),
    (8, "uint8"),
    (9, "bool"),
]
_CODE_TO_DTYPE = {code: name for code, name in _DTYPES}
_DTYPE_TO_CODE = {name: code for code, name in _DTYPES}
_ITEMSIZE = {"bfloat16": 2}


class _TensorDesc(C.Structure):
    _fields_ = [
        ("dtype", C.c_uint8),
        ("ndim", C.c_uint8),
        ("shape", C.c_int64 * MAX_NDIM),
        ("nbytes", C.c_uint64),
        ("payload_offset", C.c_uint64),
    ]


class _FrameView(C.Structure):
    _fields_ = [
        ("msg_type", C.c_uint8),
        ("flags", C.c_uint16),
        ("meta_len", C.c_uint32),
        ("meta_offset", C.c_uint64),
        ("n_tensors", C.c_uint16),
        ("tensors", _TensorDesc * MAX_TENSORS),
        ("frame_len", C.c_uint64),
    ]


class _BatcherConfig(C.Structure):
    _fields_ = [
        ("max_batch_rows", C.c_uint32),
        ("max_delay_ns", C.c_uint64),
        ("n_buckets", C.c_uint32),
        ("buckets", C.c_uint32 * 16),
    ]


_HANDLER = C.CFUNCTYPE(
    C.c_int,
    C.POINTER(C.c_uint8),
    C.c_uint64,
    C.POINTER(C.POINTER(C.c_uint8)),
    C.POINTER(C.c_uint64),
    C.c_void_p,
)

# sn_http_submit_fn(token, method, path, body, body_len, ud)
_HTTP_SUBMIT = C.CFUNCTYPE(
    C.c_int,
    C.c_uint64,
    C.c_char_p,
    C.c_char_p,
    C.POINTER(C.c_uint8),
    C.c_uint64,
    C.c_void_p,
)


class _LoadResult(C.Structure):
    """``sn_load_result`` of ``native/seldon_native.h``, field for field."""

    _fields_ = [
        ("requests", C.c_uint64),
        ("errors", C.c_uint64),
        ("seconds", C.c_double),
        ("req_per_s", C.c_double),
        ("p50_ms", C.c_double),
        ("p90_ms", C.c_double),
        ("p99_ms", C.c_double),
        ("mean_ms", C.c_double),
    ]


_lib: Optional[C.CDLL] = None
_lib_lock = threading.Lock()
#: what the last build did: seconds, whether it compiled, the library
build_stats: dict = {}


def _sources() -> list[Path]:
    return sorted(p for p in SOURCE_DIR.iterdir()
                  if p.suffix in (".cc", ".h"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``native/*.cc`` (one ``g++`` per source, in parallel) and
    link the hashed library; return its path.  Concurrent builders (test
    workers, server processes) serialize on a lock file."""
    t0 = time.perf_counter()
    so = BUILD_DIR / f"libseldon_native_{source_hash()}.so"
    if so.exists():
        build_stats.update(seconds=time.perf_counter() - t0, compiled=False,
                           library=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                _compile(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_stats.update(seconds=time.perf_counter() - t0, compiled=True,
                       library=str(so))
    return so


def _compile(so: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    tag = f"{os.getpid()}"
    procs = []
    for src in sorted(SOURCE_DIR.glob("*.cc")):
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        procs.append((obj, subprocess.Popen(
            [cxx, *CXXFLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(out)
        objs.append(obj)
    try:
        if errors:
            raise RuntimeError("native build failed:\n" + "\n".join(errors))
        tmp = so.with_suffix(f".{tag}.tmp")
        link = subprocess.run(
            [cxx, *LDFLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"native link failed:\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load() -> C.CDLL:
    """The native library, built at first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = C.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: C.CDLL) -> None:
    u8p = C.POINTER(C.c_uint8)
    lib.sn_frame_size.restype = C.c_uint64
    lib.sn_frame_size.argtypes = [C.c_uint32, C.c_uint16, u8p, C.POINTER(C.c_uint64)]
    lib.sn_frame_encode.restype = C.c_uint64
    lib.sn_frame_encode.argtypes = [
        u8p, C.c_uint64, C.c_uint8, C.c_uint16, C.c_char_p, C.c_uint32,
        C.c_uint16, u8p, u8p, C.POINTER(C.c_int64), C.POINTER(u8p),
        C.POINTER(C.c_uint64),
    ]
    lib.sn_frame_parse.restype = C.c_int
    lib.sn_frame_parse.argtypes = [u8p, C.c_uint64, C.POINTER(_FrameView)]
    lib.sn_dtype_itemsize.restype = C.c_int
    lib.sn_dtype_itemsize.argtypes = [C.c_uint8]

    lib.sn_batcher_create.restype = C.c_void_p
    lib.sn_batcher_create.argtypes = [C.POINTER(_BatcherConfig)]
    lib.sn_batcher_destroy.argtypes = [C.c_void_p]
    lib.sn_batcher_submit.restype = C.c_int
    lib.sn_batcher_submit.argtypes = [
        C.c_void_p, C.c_uint64, C.c_uint32, C.c_uint32, C.c_uint64,
    ]
    for name in ("sn_batcher_next", "sn_batcher_wait_next"):
        fn = getattr(lib, name)
        fn.restype = C.c_int
        fn.argtypes = [
            C.c_void_p, C.c_uint64, C.POINTER(C.c_uint64),
            C.POINTER(C.c_uint32), C.c_uint32, C.POINTER(C.c_uint32),
            C.POINTER(C.c_uint32),
        ]
    lib.sn_batcher_pending.restype = C.c_uint32
    lib.sn_batcher_pending.argtypes = [C.c_void_p]
    lib.sn_batcher_next_deadline.restype = C.c_uint64
    lib.sn_batcher_next_deadline.argtypes = [C.c_void_p]
    lib.sn_now_ns.restype = C.c_uint64

    lib.sn_buf_alloc.restype = C.POINTER(C.c_uint8)
    lib.sn_buf_alloc.argtypes = [C.c_uint64]
    lib.sn_buf_free.argtypes = [C.POINTER(C.c_uint8)]
    lib.sn_server_create.restype = C.c_void_p
    lib.sn_server_create.argtypes = [C.c_char_p, C.c_uint16, _HANDLER, C.c_void_p]
    lib.sn_server_start.restype = C.c_int
    lib.sn_server_start.argtypes = [C.c_void_p]
    lib.sn_server_port.restype = C.c_uint16
    lib.sn_server_port.argtypes = [C.c_void_p]
    lib.sn_server_stop.argtypes = [C.c_void_p]
    lib.sn_server_destroy.argtypes = [C.c_void_p]
    lib.sn_server_requests.restype = C.c_uint64
    lib.sn_server_requests.argtypes = [C.c_void_p]
    lib.sn_echo_handler.restype = C.c_int

    lib.sn_http_server_create.restype = C.c_void_p
    lib.sn_http_server_create.argtypes = [
        C.c_char_p, C.c_uint16, C.c_int, _HTTP_SUBMIT, C.c_void_p, C.c_int,
    ]
    lib.sn_http_server_start.restype = C.c_int
    lib.sn_http_server_start.argtypes = [C.c_void_p]
    lib.sn_http_server_port.restype = C.c_uint16
    lib.sn_http_server_port.argtypes = [C.c_void_p]
    lib.sn_http_server_requests.restype = C.c_uint64
    lib.sn_http_server_requests.argtypes = [C.c_void_p]
    lib.sn_http_server_stop.argtypes = [C.c_void_p]
    lib.sn_http_server_destroy.argtypes = [C.c_void_p]
    # body params are declared c_char_p (ABI-identical to const uint8_t*)
    # so Python `bytes` pass ZERO-COPY — the C side copies synchronously
    # into its completion struct before returning (httpserver.cc
    # sn_http_complete/stream_chunk/set_static_response), so borrowing the
    # bytes' internal buffer is safe, and the hot completion path skips a
    # ctypes array construction + copy per response
    lib.sn_http_complete.argtypes = [
        C.c_void_p, C.c_uint64, C.c_int, C.c_char_p, C.c_char_p, C.c_uint64,
    ]
    lib.sn_http_stream_chunk.argtypes = [
        C.c_void_p, C.c_uint64, C.c_char_p, C.c_uint64,
    ]
    lib.sn_http_stream_end.argtypes = [
        C.c_void_p, C.c_uint64, C.c_int, C.c_char_p,
    ]
    lib.sn_http_set_static_response.argtypes = [
        C.c_void_p, C.c_int, C.c_char_p, C.c_uint64,
    ]
    lib.sn_loadgen_run.restype = C.c_int
    lib.sn_loadgen_run.argtypes = [
        C.c_int, C.c_char_p, C.c_uint16, C.c_char_p, u8p, C.c_uint64,
        C.c_uint32, C.c_uint32, C.c_double, C.c_double,
        C.POINTER(_LoadResult),
    ]


class Frame:
    """Parsed view of a SELF frame.  Tensor arrays are zero-copy views over
    the receive buffer (kept alive by holding a reference to it)."""

    def __init__(self, msg_type: int, meta: bytes, tensors: list[np.ndarray]):
        self.msg_type = msg_type
        self.meta = meta
        self.tensors = tensors


class FrameCodec:
    """Encode/decode SELF frames via the native codec.  ``encode`` takes
    numpy arrays and torch tensors (moved to the host)."""

    def __init__(self):
        self._lib = load()

    def encode(
        self,
        msg_type: int,
        meta: bytes = b"",
        tensors: Sequence[np.ndarray] = (),
        flags: int = 0,
    ) -> bytes:
        n = len(tensors)
        if n > MAX_TENSORS:
            raise ValueError(f"too many tensors ({n} > {MAX_TENSORS})")
        arrs = [wire_array(t) for t in tensors]
        dtypes = (C.c_uint8 * n)()
        ndims = (C.c_uint8 * n)()
        nbytes = (C.c_uint64 * n)()
        shape_flat: list[int] = []
        payloads = (C.POINTER(C.c_uint8) * n)()
        for i, (a, name) in enumerate(arrs):
            if name not in _DTYPE_TO_CODE:
                raise ValueError(f"unsupported dtype {name}")
            dtypes[i] = _DTYPE_TO_CODE[name]
            ndims[i] = a.ndim
            nbytes[i] = a.nbytes
            shape_flat.extend(a.shape)
            payloads[i] = a.ctypes.data_as(C.POINTER(C.c_uint8))
        shapes = (C.c_int64 * max(len(shape_flat), 1))(*shape_flat)
        size = self._lib.sn_frame_size(len(meta), n, ndims, nbytes)
        if size == 0:
            raise ValueError("invalid frame spec")
        buf = C.create_string_buffer(size)
        written = self._lib.sn_frame_encode(
            C.cast(buf, C.POINTER(C.c_uint8)), size, msg_type, flags, meta,
            len(meta), n, dtypes, ndims, shapes, payloads, nbytes,
        )
        if written == 0:
            raise ValueError("frame encode failed")
        return buf.raw[:written]

    def decode(self, data: bytes) -> Frame:
        view = _FrameView()
        buf = np.frombuffer(data, dtype=np.uint8)  # zero-copy
        rc = self._lib.sn_frame_parse(
            buf.ctypes.data_as(C.POINTER(C.c_uint8)), len(data), C.byref(view)
        )
        if rc != 0:
            raise ValueError(f"frame parse failed (code {rc})")
        meta = bytes(
            buf[view.meta_offset : view.meta_offset + view.meta_len]
        )
        tensors = []
        for i in range(view.n_tensors):
            t = view.tensors[i]
            name = _CODE_TO_DTYPE[t.dtype]
            shape = tuple(t.shape[d] for d in range(t.ndim))
            off = t.payload_offset
            if name in _ITEMSIZE:  # a torch tensor over its own copy
                arr = array_from_buffer(
                    bytearray(data[off:off + t.nbytes]), name, shape)
            else:  # zero-copy over the receive buffer
                dt = np.dtype(name)
                arr = np.frombuffer(data, dtype=dt,
                                    count=t.nbytes // dt.itemsize,
                                    offset=off).reshape(shape)
            tensors.append(arr)
        return Frame(view.msg_type, meta, tensors)


class NativeBatchQueue:
    """Thread-safe deadline/bucket batching queue backed by the C core."""

    def __init__(
        self,
        max_batch_rows: int,
        max_delay_s: float,
        buckets: Sequence[int] = (),
    ):
        self._lib = load()
        cfg = _BatcherConfig()
        cfg.max_batch_rows = max_batch_rows
        cfg.max_delay_ns = int(max_delay_s * 1e9)
        bs = sorted(buckets)
        if len(bs) > 16:
            raise ValueError("at most 16 buckets")
        cfg.n_buckets = len(bs)
        for i, b in enumerate(bs):
            cfg.buckets[i] = b
        self._h = self._lib.sn_batcher_create(C.byref(cfg))
        if not self._h:
            raise ValueError("invalid batcher config")
        self._cap = 4096

    def submit(self, req_id: int, nrows: int, lane: int = 0) -> None:
        rc = self._lib.sn_batcher_submit(
            self._h, req_id, nrows, lane, self._lib.sn_now_ns()
        )
        if rc != 0:
            raise ValueError("submit rejected (nrows > max_batch_rows?)")

    def next_batch(self) -> Optional[tuple[list[tuple[int, int]], int, int]]:
        """Non-blocking: ([(req_id, nrows), ...], lane, bucket) or None."""
        return self._pop(self._lib.sn_batcher_next, self._lib.sn_now_ns())

    def wait_batch(
        self, timeout_s: float
    ) -> Optional[tuple[list[tuple[int, int]], int, int]]:
        """Blocking (releases the GIL in C): waits up to timeout_s."""
        return self._pop(self._lib.sn_batcher_wait_next, int(timeout_s * 1e9))

    def _pop(self, fn, arg):
        ids = (C.c_uint64 * self._cap)()
        rows = (C.c_uint32 * self._cap)()
        lane = C.c_uint32()
        bucket = C.c_uint32()
        n = fn(self._h, arg, ids, rows, self._cap, C.byref(lane), C.byref(bucket))
        if n <= 0:
            return None
        return (
            [(ids[i], rows[i]) for i in range(n)],
            lane.value,
            bucket.value,
        )

    @property
    def pending(self) -> int:
        return self._lib.sn_batcher_pending(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.sn_batcher_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class FramedServer:
    """Epoll TCP server for the framed protocol.

    ``handler(frame_bytes) -> response_bytes`` runs on the IO thread (ctypes
    releases/reacquires the GIL around the C boundary).  With ``handler=None``
    the built-in C echo handler serves — the pure-native transport path used
    by the benchmarks.
    """

    def __init__(
        self,
        handler: Optional[Callable[[bytes], bytes]] = None,
        port: int = 0,
        bind: str = "127.0.0.1",
    ):
        self._lib = load()
        self._py_handler = handler
        if handler is None:
            cfn = C.cast(self._lib.sn_echo_handler, _HANDLER)
            self._cb = cfn  # keep alive
        else:

            def trampoline(req_p, req_len, resp_pp, resp_len_p, _ud):
                try:
                    req = C.string_at(req_p, req_len)
                    out = handler(req)
                except Exception:
                    return 1  # close connection on handler error
                if out:
                    buf = self._lib.sn_buf_alloc(len(out))
                    C.memmove(buf, out, len(out))
                    resp_pp[0] = buf
                    resp_len_p[0] = len(out)
                return 0

            self._cb = _HANDLER(trampoline)
        self._h = self._lib.sn_server_create(
            bind.encode(), port, self._cb, None
        )
        if not self._h:
            raise OSError(f"failed to bind {bind}:{port}")

    def start(self) -> "FramedServer":
        if self._lib.sn_server_start(self._h) != 0:
            raise OSError("failed to start server thread")
        return self

    @property
    def port(self) -> int:
        return self._lib.sn_server_port(self._h)

    @property
    def requests(self) -> int:
        return self._lib.sn_server_requests(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.sn_server_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        # The IO thread holds a pointer to self._cb; letting GC free the
        # callback while the thread lives would be a use-after-free.
        try:
            self.stop()
        except Exception:
            pass

    def __enter__(self) -> "FramedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class NativeHttpServer:
    """Native HTTP/1.1 (REST) or HTTP/2 h2c (gRPC unary) server.

    ``submit(token, method, path, body)`` is called on the IO thread with
    COPIED bytes; the handler must eventually call
    ``server.complete(token, status, body, message)`` from any thread.
    With ``submit=None`` the server runs in static-response mode (set via
    ``set_static_response``) — the pure-native transport ceiling.

    The higher-level asyncio bridge lives in ``serving/native_http.py``.
    """

    def __init__(
        self,
        submit: Optional[Callable[[int, str, str, bytes], None]] = None,
        http2: bool = False,
        port: int = 0,
        bind: str = "127.0.0.1",
        reuseport: bool = False,
    ):
        self._lib = load()
        self.http2 = http2
        if submit is None:
            self._cb = C.cast(None, _HTTP_SUBMIT)
        else:

            def trampoline(token, method, path, body_p, body_len, _ud):
                try:
                    body = C.string_at(body_p, body_len) if body_len else b""
                    submit(
                        token,
                        method.decode(),
                        path.decode(errors="replace"),
                        body,
                    )
                    return 0
                except Exception:
                    return 1  # native side answers 500 / grpc INTERNAL

            self._cb = _HTTP_SUBMIT(trampoline)
        self._h = self._lib.sn_http_server_create(
            bind.encode(), port, 1 if http2 else 0, self._cb, None,
            1 if reuseport else 0,
        )
        if not self._h:
            raise OSError(f"failed to bind {bind}:{port}")

    def set_static_response(self, status: int, body: bytes) -> None:
        self._lib.sn_http_set_static_response(
            self._h, status, body or b"\0", len(body)
        )

    def complete(
        self,
        token: int,
        status: int,
        body: bytes = b"",
        message: Optional[str] = None,
    ) -> None:
        # bytes pass zero-copy through the c_char_p argtype; the C side
        # copies before returning (see the argtype declaration note)
        self._lib.sn_http_complete(
            self._h, token, status,
            message.encode() if message else None, body or None, len(body),
        )

    def stream_chunk(self, token: int, data: bytes) -> None:
        """One server-streaming chunk: a gRPC message (h2) or raw SSE
        bytes (h1).  Call stream_end exactly once when done."""
        self._lib.sn_http_stream_chunk(
            self._h, token, data or None, len(data)
        )

    def stream_end(
        self, token: int, status: int = 0, message: Optional[str] = None
    ) -> None:
        self._lib.sn_http_stream_end(
            self._h, token, status, message.encode() if message else None
        )

    def start(self) -> "NativeHttpServer":
        if self._lib.sn_http_server_start(self._h) != 0:
            raise OSError("failed to start server thread")
        return self

    @property
    def port(self) -> int:
        return self._lib.sn_http_server_port(self._h)

    @property
    def requests(self) -> int:
        return self._lib.sn_http_server_requests(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.sn_http_server_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass

    def __enter__(self) -> "NativeHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def run_native_load(
    mode: str,
    host: str,
    port: int,
    path: str,
    body: bytes,
    connections: int = 16,
    streams_per_conn: int = 8,
    seconds: float = 3.0,
    warmup_s: float = 0.3,
) -> dict:
    """A closed-loop load run over real sockets, requests built and answers
    parsed in C; blocks for ``warmup_s + seconds`` with the GIL released
    (a ``ctypes.CDLL`` call), so an asyncio server in this process keeps
    serving meanwhile.

    ``mode``: ``"rest"`` (HTTP/1.1 POST of ``body``) or ``"grpc"`` (h2c
    unary; ``body`` is the serialized request protobuf, framed on the
    wire).  ``streams_per_conn`` concurrent streams per connection (h2
    only).  Returns the measured window's ``requests``, ``errors`` (non-2xx,
    grpc-status != 0 or a transport error), ``seconds``, ``req_per_s`` and
    ``latency_ms`` {p50, p90, p99, mean}.  Raises if the library cannot be
    built or the run fails."""
    m = {"rest": 0, "grpc": 1}[mode]
    lib = load()
    res = _LoadResult()
    buf = (C.c_uint8 * max(len(body), 1)).from_buffer_copy(body or b"\0")
    rc = lib.sn_loadgen_run(
        m, host.encode(), port, path.encode(), buf, len(body),
        connections, streams_per_conn, seconds, warmup_s, C.byref(res),
    )
    if rc != 0:
        raise RuntimeError(f"loadgen failed (code {rc})")
    return {
        "requests": res.requests,
        "errors": res.errors,
        "seconds": round(res.seconds, 3),
        "req_per_s": round(res.req_per_s, 1),
        "latency_ms": {
            "p50": round(res.p50_ms, 3),
            "p90": round(res.p90_ms, 3),
            "p99": round(res.p99_ms, 3),
            "mean": round(res.mean_ms, 3),
        },
    }
