"""What one run knows, handed to every metric reader (``e2e/<name>.py``,
``metrics/<name>.py``: ``read(run) -> float | None``), and the end of a
run: the metrics read, the last line emitted.

A reader that finds nothing to read returns None, and its metric is left
out of the line.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Any, Optional

from benchmark.core import registry, result, stats

__all__ = ["Run", "finish"]


@dataclass
class Run:
    workload: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    kind: str = ""
    count: int = 1
    peaks: Optional[dict] = None
    t_start: float = 0.0          # the process's start, host clock
    setup_s: Optional[float] = None
    dims: Any = None              # the family's sizes, for cost functions
    requests: list = field(default_factory=list)
    w0: float = 0.0               # the window, host clock
    w1: float = 0.0
    given_up: float = 0.0         # when the harness stopped waiting
    # program counters at the window's and the traced slice's edges
    counters: dict = field(default_factory=dict)
    slice: Any = None             # core.trace.Slice of a traced run
    s0: float = 0.0
    s1: float = 0.0
    info: dict = field(default_factory=dict)

    def window(self) -> list:
        """The requests sent in the window."""
        return stats.sent_in(self.requests, self.w0, self.w1)

    def delta(self, edge: str, fn) -> Optional[float]:
        """``fn(counters at the end) - fn(counters at the start)`` of
        ``edge``: "window", "slice", or "pre" (the window before the
        slice); None if either is missing."""
        a, b = {"pre": ("window_start", "slice_start")}.get(
            edge, (edge + "_start", edge + "_end"))
        a, b = self.counters.get(a), self.counters.get(b)
        if a is None or b is None:
            return None
        return fn(b) - fn(a)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def finish(run: Run, checks: dict, memory_peak_bytes: int,
           out=None) -> dict:
    """Read the run's metrics (``--trace 0``: its end-to-end ones; ``1``:
    its per-layer ones), decide ``correct`` and print the last line."""
    bench = registry.benchmark()
    kind = "metrics" if run.trace else "e2e"
    metrics = {}
    for m in registry.cell_metrics(bench, run.workload, run.trace):
        value = registry.module(kind, m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    sent = run.window()
    failed = sum(1 for r in sent if not r.ok)
    correct = bool(checks) and all(
        _finite(c["value"]) is not None and c["value"] <= c["limit"]
        for c in checks.values())
    checks = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
              for k, c in checks.items()}
    loaded = result.forbidden_modules()
    if loaded:
        print(f"loaded in the process that would print the result: "
              f"{', '.join(loaded)}: no result", file=sys.stderr, flush=True)
        raise SystemExit(3)
    tr = run.slice.result if run.slice is not None else None
    device = result.device_block(run.kind, run.count, memory_peak_bytes, tr)
    return result.emit(correct, len(sent), failed, metrics, device, checks,
                       breakdown=tr["breakdown"] if tr else None, out=out)
