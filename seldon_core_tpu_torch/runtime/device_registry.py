"""Device-buffer registry behind ``DeviceTensorRef`` (port of
``seldon_core_tpu/runtime/device_registry.py``).

Graph edges in one process pass tensors by reference already; this
registry extends that to edges that ride a codec (the framed wire, the
proto's ``DeviceTensor`` arm, a REST hop) between peers that can reach the
same memory:

- ``put(tensor)`` registers a tensor and returns ``<process-token>/<uuid>``;
  ``resolve(ref)`` hands the same tensor back.  Refs are process scoped:
  a ref that arrives in another process raises :class:`ForeignProcessRef`,
  whose message names ``DeviceTensorRef`` (the marker the senders
  downgrade to bytes on).  Entries are one-shot by default, with a
  capacity and a TTL, so a producer whose consumer died cannot leak card
  memory.
- ``put_shm(tensor)`` stages the tensor into POSIX shared memory (one D2H)
  and returns ``shm:<name>:<dtype>:<shape>``; any process on the host
  resolves it with one H2D straight off the mapping and unlinks it.
- :class:`ShmChannel` is a pooled lane for a long-lived connection: one
  segment per direction, rewritten in place, ``shmc:<lane>:<dtype>:
  <shape>:<gen>``.  In-place reuse is safe under strict request and
  response: the consumer has copied message N off the lane before the
  producer sees the reply that licenses N+1.

The ref strings and the segment layout (the tensor's C-contiguous bytes at
offset 0) are the reference's, so a port producer and a reference consumer
read the same bytes.  bfloat16 and float8 (numpy has no such dtypes here)
travel as their raw bytes under their own names and come back as torch
tensors.

Stream order on the card: a CUDA tensor carries no readiness of its own.
``put`` records an event on the producing stream and ``resolve`` makes the
consumer's current stream wait on it (and marks the tensor as used there,
for the caching allocator), so a consumer on another thread or stream
never reads before the producing kernels have finished.

The device a shm ref resolves onto is the registry's ``device``; unset, it
is what the reference's ``jax.default_backend()`` would be: the card when
one is visible, else the CPU.  On the CPU the mapping is copied into a
detached host array; on the card the copy goes to the device with the
dtype jax would give it (float64 becomes float32, int64 int32), on a copy
stream of the registry's own that is waited for before the mapping can be
unlinked or rewritten (the mapping is pageable, so the copy is
synchronous anyway: one D2H at the producer, one H2D here).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["DeviceBufferRegistry", "ShmChannel", "registry",
           "process_token", "host_token", "ForeignProcessRef", "SHM_PREFIX",
           "OWNERSHIP_SHARED", "OWNERSHIP_ONE_SHOT", "ref_ownership"]

#: namespace prefix of every shm export; the orphan reaper scans it
SHM_PREFIX = "seldon_dtr_"

#: many observers: resolution copies off without invalidating
OWNERSHIP_SHARED = "shared"
#: the first resolve consumes (deletes the entry, unlinks the segment)
OWNERSHIP_ONE_SHOT = "one-shot"


def ref_ownership(ref: str) -> str:
    """Ownership class of a ref string, from its format alone: ``shmc:``
    lane refs are producer-owned and copied off; ``shm:`` exports and
    loopback entries are consumed by their first resolve."""
    if ref.startswith("shmc:"):
        return OWNERSHIP_SHARED
    return OWNERSHIP_ONE_SHOT


_HOST_TOKEN: Optional[str] = None

_BASE = uuid.uuid4().hex


def process_token() -> str:
    """Identity baked into every ref.  The pid is read at call time: a
    forked worker inherits ``_BASE`` but not the parent's tensors, so a
    ref minted before the fork is rejected in the child."""
    return f"{_BASE}-{os.getpid()}"


def host_token() -> str:
    """Machine identity for the same-host shm tier: the boot id (processes
    that share it share a POSIX shm namespace), else the hostname."""
    global _HOST_TOKEN
    if _HOST_TOKEN is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _HOST_TOKEN = f.read().strip()
        except OSError:
            import socket

            _HOST_TOKEN = socket.gethostname()
    return _HOST_TOKEN


class ForeignProcessRef(ValueError):
    """A DeviceTensorRef crossed a real process or transport boundary."""


# dtypes numpy lacks here: their raw bytes under their own names
_TORCH_ONLY = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_TORCH_ONLY_NAMES = {v: k for k, v in _TORCH_ONLY.items()}
# what jax (64-bit types off) makes of a host array it is given
_DEVICE_DTYPES = {torch.float64: torch.float32, torch.int64: torch.int32,
                  torch.uint64: torch.uint32}


def _ref_layout(dtype_name: str, shape_csv: str):
    """(shape, numpy dtype or torch dtype) from an shm or lane ref."""
    shape = tuple(int(s) for s in shape_csv.split(",")) if shape_csv else ()
    if dtype_name in _TORCH_ONLY:
        return shape, _TORCH_ONLY[dtype_name]
    return shape, np.dtype(dtype_name)


def _host_bytes(x: Any) -> tuple:
    """``(uint8 host array of x's C-contiguous bytes, shape, dtype name)``:
    one D2H for a tensor on the card."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _TORCH_ONLY_NAMES.get(t.dtype)
        if name is None:
            name = np.dtype(t.numpy().dtype).name
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
        return raw, tuple(t.shape), name
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype == object:
        raise ValueError(
            "shm DeviceTensorRef requires a numeric tensor (got object "
            "dtype; ragged/str payloads must use the byte codecs)")
    return arr.reshape(-1).view(np.uint8), arr.shape, arr.dtype.name


class DeviceBufferRegistry:
    def __init__(self, capacity: int = 256, ttl_s: float = 300.0,
                 metrics=None, device=None):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.device = None if device is None else torch.device(device)
        #: entry -> (tensor, registered_at, nbytes, ready event or None)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self._shm_exports: "OrderedDict[str, float]" = OrderedDict()
        #: consumer-side lane attachments (lane name -> (shm, layout,
        #: view)); bounded LRU: an evicted mapping re-attaches on next use
        self._shmc_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._shmc_cache_cap = 64
        self.metrics = metrics
        self._copy_streams: dict = {}
        self._bytes = 0
        self._reaped = 0
        #: direction -> bytes moved (d2h / h2d) or not moved (avoided)
        self._transfer_bytes: dict = {}

    # -- the consumer's device -------------------------------------------
    def resolve_device(self) -> torch.device:
        """Where shm refs resolve: ``device`` when set, else the card when
        one is visible (the reference's default backend), else the CPU."""
        if self.device is not None:
            return self.device
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def _off_mapping(self, shape, dtype, buf) -> Any:
        """One copy off a host shm mapping onto the consumer's device (a
        detached host array on the CPU).  Every caller needs the copy: a
        one-shot resolve unlinks the segment, a lane resolve hands the
        buffer back to the producer."""
        dev = self.resolve_device()
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if isinstance(dtype, torch.dtype):
            if n == 0:
                host = torch.empty(shape, dtype=dtype)
            else:
                host = torch.frombuffer(buf, dtype=dtype, count=n).reshape(
                    shape)
            if dev.type == "cpu":
                return host.clone()
        else:
            view = np.ndarray(shape, dtype, buffer=buf)
            if dev.type == "cpu":
                return np.array(view)
            host = torch.from_numpy(view)
        want = _DEVICE_DTYPES.get(host.dtype)
        if want is not None:  # the conversion jax makes, on the host
            host = host.to(want)
        # the H2D runs on a stream of its own and is waited for there, so
        # it neither waits for the consumer's queued kernels nor lets the
        # mapping go before the bytes are read
        stream = self._copy_stream(dev)
        with torch.cuda.stream(stream):
            out = host.to(dev)
        stream.synchronize()
        out.record_stream(torch.cuda.current_stream(dev))
        return out

    def _copy_stream(self, dev: torch.device):
        with self._lock:
            s = self._copy_streams.get(dev)
            if s is None:
                s = self._copy_streams[dev] = torch.cuda.Stream(device=dev)
            return s

    # -- observability ---------------------------------------------------
    def attach_metrics(self, metrics) -> None:
        """Late-bind a MetricsRegistry and push the current state."""
        self.metrics = metrics
        with self._lock:
            self._export_locked()

    @property
    def nbytes(self) -> int:
        """Bytes held by registered (non-shm) entries."""
        with self._lock:
            return self._bytes

    @property
    def reaped(self) -> int:
        """Entries and exports reaped by TTL or capacity, never consumed."""
        with self._lock:
            return self._reaped

    def _export_locked(self) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.gauge_set(
                "seldon_device_registry_entries", len(self._entries))
            self.metrics.gauge_set("seldon_device_registry_bytes",
                                   self._bytes)
        except Exception:
            pass

    def _note_reaped_locked(self, kind: str, n: int = 1) -> None:
        self._reaped += n
        if self.metrics is not None and n:
            try:
                self.metrics.counter_inc(
                    "seldon_device_registry_reaped_total", {"kind": kind}, n)
            except Exception:
                pass

    def _note_transfer(self, direction: str, nbytes: int) -> None:
        """Bill a transfer the registry made (``d2h`` staging, ``h2d``
        resolution) or skipped (``avoided``: a loopback resolve hands the
        tensor itself back)."""
        nbytes = int(nbytes)
        with self._lock:
            self._transfer_bytes[direction] = \
                self._transfer_bytes.get(direction, 0) + nbytes
        if self.metrics is not None and nbytes:
            try:
                self.metrics.counter_inc(
                    "seldon_device_registry_transfer_bytes_total",
                    {"direction": direction}, nbytes)
            except Exception:
                pass

    @property
    def transfer_bytes(self) -> dict:
        """direction -> cumulative bytes (``d2h`` / ``h2d`` / ``avoided``)."""
        with self._lock:
            return dict(self._transfer_bytes)

    # -- cross-process (same host): POSIX shared memory ------------------
    def put_shm(self, array: Any) -> str:
        """Export ``array`` for another process on this host: one D2H into
        a fresh segment; the consumer's :meth:`resolve` unlinks it."""
        from multiprocessing import shared_memory

        raw, shape, dtype_name = _host_bytes(array)
        name = f"{SHM_PREFIX}{uuid.uuid4().hex[:16]}"
        shm = shared_memory.SharedMemory(create=True,
                                         size=max(raw.nbytes, 1), name=name)
        try:
            np.ndarray(raw.shape, np.uint8, buffer=shm.buf)[...] = raw
        except BaseException:
            shm.close()
            shm.unlink()
            raise
        else:
            shm.close()
        now = time.monotonic()
        with self._lock:
            self._shm_exports[name] = now
            self._reap_shm(now)
        self._note_transfer("d2h", raw.nbytes)
        shape_csv = ",".join(str(s) for s in shape)
        return f"shm:{name}:{dtype_name}:{shape_csv}"

    def _reap_shm(self, now: float) -> None:
        """Unlink exports whose consumer never came (holding _lock)."""
        from multiprocessing import shared_memory

        while self._shm_exports:
            name, t = next(iter(self._shm_exports.items()))
            if now - t <= self.ttl_s and \
                    len(self._shm_exports) <= self.capacity:
                break
            self._shm_exports.popitem(last=False)
            try:
                seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()
                self._note_reaped_locked("shm")
            except FileNotFoundError:
                pass  # consumed
        self._export_locked()

    def reap_orphan_shm(self, max_age_s: Optional[float] = None) -> int:
        """Unlink :data:`SHM_PREFIX` segments of dead producers older than
        ``max_age_s`` (default: the TTL) that this process does not track.
        Called at boot; returns the number reaped (``kind="orphan"``)."""
        age_limit = self.ttl_s if max_age_s is None else float(max_age_s)
        shm_dir = "/dev/shm"
        try:
            names = os.listdir(shm_dir)
        except OSError:
            return 0
        now = time.time()
        reaped = 0
        with self._lock:
            own = set(self._shm_exports)
        for name in names:
            if not name.startswith(SHM_PREFIX) or name in own:
                continue
            path = os.path.join(shm_dir, name)
            try:
                age = now - os.stat(path).st_mtime
            except OSError:
                continue  # raced with a consumer's unlink
            if age <= age_limit:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            reaped += 1
        if reaped:
            with self._lock:
                self._note_reaped_locked("orphan", reaped)
        return reaped

    def _resolve_shm(self, ref: str) -> Any:
        """Attach a same-host export, copy it onto the device, unlink."""
        from multiprocessing import shared_memory

        try:
            _, name, dtype_name, shape_csv = ref.split(":", 3)
        except ValueError:
            raise ValueError(f"malformed shm ref {ref!r}")
        shape, dtype = _ref_layout(dtype_name, shape_csv)
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            raise KeyError(
                f"shm DeviceTensorRef {name!r} not found (already consumed, "
                "reaped, or producer on a different host)")
        try:
            out = self._off_mapping(shape, dtype, shm.buf)
        finally:
            shm.close()
            try:
                shm.unlink()  # one-shot consume
            except FileNotFoundError:
                pass
        self._note_transfer("h2d", getattr(out, "nbytes", 0) or 0)
        return out

    # -- pooled same-host lanes (shmc:) ----------------------------------
    def channel(self) -> "ShmChannel":
        """A fresh producer-side lane; the holder must ``close()`` it."""
        return ShmChannel(self)

    def _resolve_shmc(self, ref: str) -> Any:
        """Copy a message off a peer's lane.  The mapping is cached by lane
        name and never unlinked here: the producer owns it."""
        from multiprocessing import shared_memory

        try:
            _, name, dtype_name, shape_csv, _gen = ref.split(":", 4)
        except ValueError:
            raise ValueError(f"malformed channel ref {ref!r}")
        layout = f"{dtype_name}:{shape_csv}"
        with self._lock:
            entry = self._shmc_cache.get(name)
            if entry is not None:
                self._shmc_cache.move_to_end(name)
        if entry is None or entry[1] != layout:
            shape, dtype = _ref_layout(dtype_name, shape_csv)
            if entry is not None:
                shm = entry[0]  # same segment, new message layout
            else:
                try:
                    shm = shared_memory.SharedMemory(name=name)
                except FileNotFoundError:
                    raise KeyError(
                        f"shm DeviceTensorRef lane {name!r} not found "
                        "(producer gone, lane closed, or reaped as an "
                        "orphan); the sender must downgrade to bytes")
            entry = (shm, layout, (shape, dtype))
            with self._lock:
                self._shmc_cache[name] = entry
                self._shmc_cache.move_to_end(name)
                # evicted entries are dropped, not closed: a concurrent
                # resolver may still be copying off the mapping
                while len(self._shmc_cache) > self._shmc_cache_cap:
                    self._shmc_cache.popitem(last=False)
        shape, dtype = entry[2]
        out = self._off_mapping(shape, dtype, entry[0].buf)
        self._note_transfer("h2d", getattr(out, "nbytes", 0) or 0)
        return out

    # -- in-process loopback refs ----------------------------------------
    def put(self, array: Any) -> str:
        """Register ``array``; returns the ref string for the wire.  For a
        CUDA tensor an event recorded on the current stream marks when
        its producing kernels are done."""
        key = uuid.uuid4().hex
        now = time.monotonic()
        nbytes = int(getattr(array, "nbytes", 0) or 0)
        ready = None
        if isinstance(array, torch.Tensor):
            nbytes = array.numel() * array.element_size()
            if array.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(array.device))
        with self._lock:
            self._entries[key] = (array, now, nbytes, ready)
            self._bytes += nbytes
            # expired first, then oldest over capacity
            while self._entries:
                k, (_, t, nb, _e) = next(iter(self._entries.items()))
                if now - t > self.ttl_s or \
                        len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self._bytes -= nb
                    self._note_reaped_locked("entry")
                else:
                    break
            self._export_locked()
        return f"{process_token()}/{key}"

    def resolve(self, ref: str, consume: bool = True) -> Any:
        if ref.startswith("shmc:"):
            # lane messages are copied off, never consumed
            return self._resolve_shmc(ref)
        if ref.startswith("shm:"):
            if not consume:
                raise ValueError(
                    "shm DeviceTensorRefs are one-shot (resolution unlinks "
                    "the segment); consume=False cannot be honored")
            return self._resolve_shm(ref)
        token, _, key = ref.partition("/")
        if token != process_token():
            raise ForeignProcessRef(
                "DeviceTensorRef crossed a transport boundary (minted by "
                "another process); the sender must downgrade device-resident "
                "payloads to binTensor (proto/convert.py message_to_proto "
                "default)")
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise KeyError(
                    f"DeviceTensorRef {key!r} not registered (already "
                    "consumed, expired, or evicted)")
            if consume:
                del self._entries[key]
                self._bytes -= entry[2]
                self._export_locked()
        array, ready = entry[0], entry[3]
        if ready is not None:
            cur = torch.cuda.current_stream(array.device)
            cur.wait_event(ready)
            array.record_stream(cur)
        # the serialize, copy and parse these bytes would have paid
        self._note_transfer("avoided", entry[2])
        return array

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ShmChannel:
    """Producer side of a pooled same-host lane: one segment per
    connection direction, rewritten in place.

    ``put(array)`` stages the tensor (one D2H) and returns
    ``shmc:<lane>:<dtype>:<shape>:<gen>``; the lane grows (a new name, the
    old one unlinked) when a payload outsizes it.  The consumer copies the
    message off and caches the attachment; ``close()`` unlinks the lane.
    Safe only under strict request and response per connection; a
    producer shared by concurrent callers must serialize ``put`` and the
    round trip (the framed clients do).  Lane names carry
    :data:`SHM_PREFIX`, so a crashed producer's lane is reaped at the next
    boot on the host; a fresh attach to a reaped lane fails with the
    ``DeviceTensorRef`` marker that makes the sender downgrade.
    """

    def __init__(self, owner: DeviceBufferRegistry):
        self._owner = owner
        self._shm = None
        self._gen = 0
        self._layout = None  # (shape, dtype name) the prefix serves
        self._prefix = ""

    def put(self, array: Any) -> str:
        """Stage ``array`` for the peer (one D2H into the lane)."""
        from multiprocessing import shared_memory

        raw, shape, dtype_name = _host_bytes(array)
        if self._shm is None or self._shm.size < raw.nbytes:
            self.close()
            self._shm = shared_memory.SharedMemory(
                create=True, size=max(raw.nbytes, 1),
                name=f"{SHM_PREFIX}ch_{uuid.uuid4().hex[:16]}")
        layout = (shape, dtype_name)
        if layout != self._layout:
            shape_csv = ",".join(str(s) for s in shape)
            self._prefix = (f"shmc:{self._shm.name}:{dtype_name}:"
                            f"{shape_csv}:")
            self._layout = layout
        if raw.nbytes:
            np.ndarray(raw.shape, np.uint8, buffer=self._shm.buf)[...] = raw
        self._gen += 1
        self._owner._note_transfer("d2h", raw.nbytes)
        return f"{self._prefix}{self._gen}"

    def close(self) -> None:
        """Unlink the lane (a consumer's cached mapping stays valid until
        evicted: POSIX keeps unlinked segments alive while mapped)."""
        if self._shm is None:
            return
        self._layout = None
        self._prefix = ""
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass  # orphan-reaped by another process's boot
        self._shm = None

    def __del__(self):  # best effort: close() is the contract
        try:
            self.close()
        except Exception:
            pass


registry = DeviceBufferRegistry()
