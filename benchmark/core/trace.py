"""The traced slice: ``torch.profiler`` over a few seconds inside the window,
reduced to what the per-layer metrics read.

- Device busy time is the length of the union of the device events'
  intervals (kernels, copies, sets), ``profile_decode.py``'s arithmetic,
  reported with the slice's seconds on the host clock (``busy_s``,
  ``window_s``).  Their idle share carries the tracer's own cost: under
  the profiler each CUDA-graph launch takes milliseconds longer on the
  host, so it is no per-layer metric.
- Device time by kernel name; a kernel family's time is the sum over the
  names that hold one of its patterns (``costs/k1.py`` ``KERNELS``).
- The breakdown: the device operations that took most time, and the
  longest idle gaps, each named by the innermost host operation that was
  running at the gap's middle ("host: between ops" where none was).

Events are read from the profiler's raw results, not ``prof.events()``,
whose tree a busy slice takes long to build.  No trace file is written.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["Slice", "prime", "merged", "reduce_events"]


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint ``[start, end]``
    pairs, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(device: list, host: list, slice_s: float,
                  top: int = 10) -> dict:
    """``device`` and ``host``: ``(start_ns, end_ns, name)``.  Returns the
    busy and slice seconds, seconds per device name and the breakdown."""
    busy = merged((s, e) for s, e, _ in device)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 > e0:
            gaps.append((e0, s1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    hosts = sorted(host)
    for g0, g1 in gaps[:top]:
        mid = (g0 + g1) / 2
        inner = None
        for s, e, name in hosts:
            if s > mid:
                break
            if e >= mid and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        named.append([inner[2][:120] if inner else "host: between ops",
                      (g1 - g0) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns / 1e9, "window_s": slice_s,
            "by_name": by_name,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in ops],
                          "idle_gaps": named}}


def _events(prof) -> tuple:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name())
        (device if e.device_type() == cuda else host).append(row)
    return device, host


def prime() -> None:
    """Start and stop the profiler once, so that a traced slice's start
    does not pay the tracer's first set-up inside the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)


class Slice:
    """``start()`` then ``stop()`` around the traced seconds; ``result``
    holds :func:`reduce_events`' dict once :meth:`reduce` has run (after
    the run's load, so that reducing costs the load nothing)."""

    def __init__(self):
        self._prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.result: Optional[dict] = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        device, host = _events(self._prof)
        self._prof = None
        self.result = reduce_events(device, host, self.t1 - self.t0)
        return self.result

    def kernel_s(self, patterns) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of
        ``patterns``; None when none ran in the slice."""
        hits = [s for n, s in self.result["by_name"].items()
                if any(p in n for p in patterns)]
        return sum(hits) if hits else None
