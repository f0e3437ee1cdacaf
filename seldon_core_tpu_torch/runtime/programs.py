"""Device programs: a function of static inputs, replayed as one CUDA graph
per shape key on the card (the counterpart of the reference's ``jax.jit``
programs, compiled per shape at first sight).

The LLM engines (``runtime/llm.py``) run every piece of their device work
through a :class:`Program`: the decode tick, the prefill of one (rows,
bucket), the extend of one (prefix rows, suffix bucket), the speculative
round.  A call names its shape key and hands over the host values of the
program's inputs:

- **Staging.**  The values are copied into the key's static input tensors,
  on the calling thread's current stream: host arrays through a pinned
  staging buffer of the key's own (an event guards its reuse), device
  tensors by a device copy.  The staging runs on the CPU too, so the CPU
  tests cover it.
- **Eager.**  On the CPU, and on the card under :func:`eager`, the function
  then runs as it is, one Python call per kernel.
- **Capture.**  Otherwise the key's first call captures the function as a
  ``torch.cuda.CUDAGraph`` (:func:`capture`: an eager warm-up run on the
  pool's stream, the capture with ``capture_error_mode="thread_local"``,
  one replay that must be bitwise equal to the warm-up run on the rows an
  answer reads, or ``RuntimeError`` naming the program and the key); every
  later call replays it on the current stream.  A failed capture or a
  differing replay raises: nothing falls back to the eager path.

The kernels launch through ctypes with raw pointers (``ops/_build.py``), so
a graph keeps no tensor alive: a program holds a reference to every buffer
outside its pool that its graphs read or write (``keep``).  All programs of
one engine share one :class:`GraphPool` and replay one at a time on the
engine's single device worker; an output is consumed, or cloned
(``owned_outputs``), before the next replay of its key.

A key's graph holds its static inputs and outputs for as long as it lives.
A program of many keys (prefill per (rows, bucket), extend) is given a
byte budget (``retain_bytes``): after a capture it drops its least
recently used keys, graph and buffers, until what its keys hold fits the
budget or only the new key is left.  Their blocks go back to the shared
pool, where later captures reuse them; a dropped key captures again at its
next call.

:func:`capture` is also the capture of a fused graph plan's segment
(``graph/plan.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.ops import launches

__all__ = ["eager", "graphs_on", "GraphPool", "Captured", "capture",
           "bitwise_equal", "Program"]

_lock = threading.Lock()
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every program eagerly on the card while open (the counterpart of
    ``jax.disable_jit()``); nests.  Process-wide, since the engines' device
    work runs on their own worker threads.  For tests and A/B measurement:
    serving never enters it."""
    global _eager_depth
    with _lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _lock:
            _eager_depth -= 1


def graphs_on(device) -> bool:
    """Whether programs on ``device`` capture and replay CUDA graphs: on a
    CUDA device, outside :func:`eager`."""
    return torch.device(device).type == "cuda" and _eager_depth == 0


class GraphPool:
    """The memory pool and capture stream of a family of graphs that replay
    one at a time (an engine's programs, a segment's buckets)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=self.device)

    def bytes(self) -> int:
        """Device bytes the pool's segments hold."""
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(
                       self.handle))


class Captured:
    """One captured graph: its static inputs and outputs and the kernel
    launches one replay makes (``ops/launches.py``)."""

    __slots__ = ("graph", "inputs", "outputs", "recording")

    def __init__(self, graph, inputs, outputs, recording):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.recording = recording

    def replay(self):
        """Replay on the current stream; the static outputs."""
        self.graph.replay()
        self.recording.replayed()
        return self.outputs


def bitwise_equal(a: Any, b: Any) -> bool:
    """Tensors (or tuples and lists of them, or None) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(bitwise_equal(x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is b
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return False
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def capture(fn: Callable, inputs: tuple, pool: GraphPool, what: str,
            key_desc: str, select: Optional[Callable] = None) -> Captured:
    """Capture ``fn(*inputs)`` as a CUDA graph in ``pool``: one eager run on
    the pool's stream (kernels warmed up, the reference answer), the
    capture (``thread_local``: CUDA work of other threads cannot void it;
    its launch notes are taken back, a capture launches nothing), then one
    replay on the current stream that must be bitwise equal to the eager
    run, on ``select(outputs)`` when given.  Raises ``RuntimeError`` naming
    ``what`` and ``key_desc`` if the capture fails or the replay differs.
    ``fn`` must read no device value on the host, and its effects on
    buffers outside the pool must be the same when it runs twice on the
    same inputs (the eager run and the replay both run it)."""
    cur = torch.cuda.current_stream(pool.device)
    pool.stream.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    rec = launches.Recording()
    try:
        with torch.cuda.stream(pool.stream):
            ref = fn(*inputs)
        with rec:
            with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream,
                                  capture_error_mode="thread_local"):
                out = fn(*inputs)
    except Exception as e:
        raise RuntimeError(f"{what}: capture of {key_desc} failed: "
                           f"{type(e).__name__}: {e}") from e
    finally:
        rec.undo()
    cur.wait_stream(pool.stream)
    graph.replay()
    rec.replayed()
    torch.cuda.synchronize(pool.device)
    if select is not None:
        ref, out_sel = select(ref), select(out)
    else:
        out_sel = out
    if not bitwise_equal(ref, out_sel):
        raise RuntimeError(
            f"{what}: {key_desc}: the first replay of its CUDA graph is not "
            "bitwise equal to its eager run on the same input")
    return Captured(graph, inputs, out, rec)


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros((), np.asarray(x).dtype)).dtype


class Program:
    """One device program of an engine: ``fn(key, *inputs)`` over static
    inputs, one CUDA graph per shape ``key`` on the card (module
    docstring).

    - ``pool_of()``: the engine's :class:`GraphPool`, made at the first
      capture;
    - ``keep``: the buffers outside the pool that ``fn`` reads or writes
      (weights, caches, K2's arrival counters), held as long as the graphs;
    - ``answered(key, host, outputs)``: the part of ``outputs`` an answer
      reads (the bitwise check of the first replay; default all of it);
    - ``owned_outputs``: the caller keeps the outputs past the next call of
      the key, so a replay's are cloned;
    - ``retain_bytes``: the budget of the static inputs and outputs its
      captured keys hold (module docstring); None: no budget.

    Counters: ``capture_s`` (seconds of each key's latest capture),
    ``captures``, ``replays`` (every replay, the first included),
    ``eager_runs``,
    ``evicted`` (keys dropped for the budget) and :meth:`retained_bytes`.
    """

    def __init__(self, name: str, fn: Callable, device, pool_of: Callable,
                 *, keep: tuple = (), answered: Optional[Callable] = None,
                 owned_outputs: bool = False,
                 retain_bytes: Optional[int] = None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.keep = keep
        self.retain_bytes = retain_bytes
        self._pool_of = pool_of
        self._answered = answered
        self._owned = owned_outputs
        self._static: dict = {}
        self._staging: dict = {}
        self._graphs: dict = {}  # least recently used first
        self._held: dict = {}    # bytes of each captured key's buffers
        self.capture_s: dict = {}
        self.captures = 0
        self.replays = 0
        self.eager_runs = 0
        self.evicted = 0

    def retained_bytes(self) -> int:
        """Bytes of the static inputs and outputs of the captured keys."""
        return sum(self._held.values())

    def __call__(self, key, *host):
        """Stage ``host`` (numpy arrays, CPU tensors or tensors on the
        program's device) into ``key``'s static inputs and run."""
        static = self._stage(key, host)
        if not graphs_on(self.device):
            self.eager_runs += 1
            return self.fn(key, *static)
        g = self._graphs.pop(key, None)
        if g is None:
            g = self._capture(key, static, host)
            out = g.outputs
        else:
            self._graphs[key] = g  # now the most recently used
            out = g.replay()
        self.replays += 1
        if self._owned:
            out = tuple(t.clone() for t in out)
        return out

    def _stage(self, key, host) -> tuple:
        static = self._static.get(key)
        if static is None:
            static = tuple(torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                                       device=self.device) for x in host)
            self._static[key] = static
        pinned = self.device.type == "cuda"
        staging = self._staging.get(key)
        if pinned:
            if staging is None:
                staging = self._staging[key] = (
                    [None if isinstance(x, torch.Tensor) and x.is_cuda
                     else torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                                      pin_memory=True) for x in host],
                    torch.cuda.Event())
            else:
                # the previous call's copies out of the pinned buffers
                staging[1].synchronize()
        for i, (dst, src) in enumerate(zip(static, host)):
            if isinstance(src, torch.Tensor) and src.device == self.device:
                dst.copy_(src)
                continue
            src = src if isinstance(src, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(src))
            if pinned:
                buf = staging[0][i]
                buf.copy_(src)
                dst.copy_(buf, non_blocking=True)
            else:
                dst.copy_(src)
        if pinned:
            staging[1].record()
        return static

    def _capture(self, key, static: tuple, host: tuple) -> Captured:
        t0 = time.perf_counter()
        select = None
        if self._answered is not None:
            def select(out):
                return self._answered(key, host, out)

        fn = self.fn

        def run(*inputs):
            return fn(key, *inputs)

        g = capture(run, static, self._pool_of(), f"program {self.name!r}",
                    f"key {key}", select=select)
        self._graphs[key] = g
        self._held[key] = _nbytes((*static, *_tensors(g.outputs)))
        self.capture_s[key] = time.perf_counter() - t0
        self.captures += 1
        self._evict()
        return g

    def _evict(self) -> None:
        """Drop the least recently used keys until the budget holds or only
        the newest is left."""
        if self.retain_bytes is None:
            return
        while len(self._graphs) > 1 and (self.retained_bytes()
                                         > self.retain_bytes):
            old = next(iter(self._graphs))
            for d in (self._graphs, self._held, self._static, self._staging):
                d.pop(old, None)
            self.evicted += 1


def _tensors(x) -> list:
    """The tensors of an output: a tensor, or a tuple or list of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


def _nbytes(tensors) -> int:
    """Bytes of the storages under ``tensors``, each counted once."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())
