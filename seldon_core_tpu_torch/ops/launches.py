"""Launch counters of the port's kernels, kept right across CUDA graphs.

Each kernel wrapper (``ops.quant.int8_matmul_cuda``,
``runtime.paged.paged_attention_cuda``, ``ops.attention.
flash_attention_cuda``) carries a ``launches`` attribute and calls
:func:`note` exactly where it launches its kernel.  A replayed CUDA graph
runs no Python, so a segment that captures a forward (``graph/plan.py``)
counts for itself:

- :class:`Recording` collects, per kernel, the launches noted on the
  capturing thread while it is open (launches of other threads, an LLM
  engine's worker say, are not part of the capture and are not counted
  in it);
- a capture launches nothing on the card, so :meth:`Recording.undo`
  takes its notes back off the counters;
- every replay of the graph adds them again (:meth:`Recording.replayed`).

So ``fn.launches`` counts kernels that ran, eager or replayed.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = ["register", "note", "Recording"]

_local = threading.local()
_kernels: dict[str, Callable] = {}


def register(name: str, fn: Callable) -> Callable:
    """Give ``fn`` a ``launches`` counter under ``name``; returns ``fn``."""
    fn.launches = 0
    fn.kernel_name = name
    _kernels[name] = fn
    return fn


def note(fn: Callable) -> None:
    """Count one launch of ``fn``'s kernel (and in the open recording of
    this thread, if any)."""
    fn.launches += 1
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec.counts[fn.kernel_name] = rec.counts.get(fn.kernel_name, 0) + 1


class Recording:
    """``with Recording() as rec:`` collects the launches this thread notes
    inside the block, per kernel (``rec.counts``).  Recordings do not
    nest."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def __enter__(self) -> "Recording":
        if getattr(_local, "recording", None) is not None:
            raise RuntimeError("a launch recording is already open on this "
                               "thread")
        _local.recording = self
        return self

    def __exit__(self, *exc) -> None:
        _local.recording = None

    def _add(self, times: int) -> None:
        for name, n in self.counts.items():
            _kernels[name].launches += n * times

    def undo(self) -> None:
        """The recorded calls launched nothing (a graph capture)."""
        self._add(-1)

    def replayed(self, times: int = 1) -> None:
        """The recorded launches ran ``times`` more times (replays)."""
        self._add(times)
