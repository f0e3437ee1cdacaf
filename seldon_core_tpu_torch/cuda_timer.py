"""CUDA-event timing of single launches over a cold L2, for the scripts that
measure the port on a card (``chip_smoke.py``, ``sweep_int8_gemm``).

Each rep writes a 256 MB buffer (more than the H100's 50 MB of L2), then
records an event, runs the call and records another.  All reps are queued
behind a spin of the card before any is waited for, so the card never waits
on the host inside an interval: a host thread that is descheduled between
launches would otherwise add its delay to the time.
"""

from __future__ import annotations

import statistics

import torch

#: card cycles of spin before the reps: a few milliseconds, more than the
#: host needs to queue them
SPIN_CYCLES = 10_000_000


class ColdTimer:
    def __init__(self):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device="cuda")

    def __call__(self, fn, reps: int = 20, warmup: int = 2) -> float:
        """Median ms of ``fn`` over ``reps`` launches, each after a flush."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(SPIN_CYCLES)
        for a, b in events:
            self.flush_buf.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)
