"""Cost counting of a captured bucket: FLOPs and bytes from the shapes of
the ops a run dispatches (the counterpart of XLA's ``cost_analysis()``,
which the reference reads from a compiled executable).

``with CostCount() as c: fn(x)`` counts, on the calling thread:

- FLOPs of the aten products and convolutions, by
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
  attention; elementwise work counts no FLOPs there);
- bytes accessed: each aten op's tensor inputs read once and its outputs
  written once (views and factory functions move nothing), so the count
  is the unfused traffic of the run;
- each hand-written kernel's own cost, by :func:`kernel`: a kernel's
  wrapper states the reference's ``pl.CostEstimate`` formula for its call
  and runs its kernel, or on the CPU its plain version, inside
  ``kernel(...)``, which adds the formula once and hides whatever the call
  dispatches from the two counters above (a ctypes launch dispatches no
  aten op; a plain version's own matmuls must not count a second time).

Counting runs the ops it sees through Python dispatch modes and changes no
numerics; it is done once per bucket, at capture.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils._pytree import tree_flatten

__all__ = ["CostCount", "kernel"]

_local = threading.local()


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums each op's tensor input bytes and output bytes; a view (its
    result aliases an input) and an op without tensor inputs (a factory)
    move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        is_view = any(a.alias_info is not None and not a.alias_info.is_write
                      for a in schema.returns)
        inputs = _tensor_bytes((args, kwargs))
        if not is_view and inputs:
            self.bytes += inputs + _tensor_bytes(out)
        return out


class CostCount:
    """FLOPs and bytes accessed of the ops run inside the block on this
    thread (module docstring); ``flops`` and ``bytes_accessed`` once the
    block has closed."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self._kernel_flops = 0.0
        self._kernel_bytes = 0.0
        self._stack = None
        self._flop_mode = None
        self._bytes_mode = None

    def __enter__(self) -> "CostCount":
        if getattr(_local, "count", None) is not None:
            raise RuntimeError("a cost count is already open on this thread")
        from torch.utils.flop_counter import FlopCounterMode

        self._flop_mode = FlopCounterMode(display=False)
        self._bytes_mode = _BytesMode()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._flop_mode)
        self._stack.enter_context(self._bytes_mode)
        _local.count = self
        return self

    def __exit__(self, *exc) -> None:
        _local.count = None
        self._stack.close()
        self.flops = float(self._flop_mode.get_total_flops()) \
            + self._kernel_flops
        self.bytes_accessed = float(self._bytes_mode.bytes) \
            + self._kernel_bytes

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed}


_NULL = contextlib.nullcontext()


def kernel(flops: float, bytes_accessed: float):
    """Around one hand-written kernel's call (or its plain version's):
    with a count open on this thread, add the kernel's stated cost once and
    count nothing the call dispatches; otherwise a shared no-op context
    (the serving path pays one attribute read)."""
    count = getattr(_local, "count", None)
    if count is None:
        return _NULL
    return _hidden(count, flops, bytes_accessed)


@contextlib.contextmanager
def _hidden(count: CostCount, flops: float,
            bytes_accessed: float) -> Iterator[None]:
    count._kernel_flops += float(flops)
    count._kernel_bytes += float(bytes_accessed)
    with _disable_current_modes():
        yield
