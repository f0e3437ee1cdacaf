"""What the readers of the LLM engine's own records share: a record per
device job and per request, which the port keeps in process-wide rings on
the harness's clock (``seldon_core_tpu_torch/utils/tracing.py``
``job_records``, ``request_records``).  They read the window before the
traced slice, ``[w0, s0)``, which the profiler does not slow.

Every function returns None where the program keeps no such records, where
its ring no longer holds the whole span, or where the span holds nothing
to read: then the metric is left out of the line.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["jobs", "requests", "mean"]


def _reader(name: str):
    try:
        from seldon_core_tpu_torch.utils import tracing
    except ImportError:
        return None
    return getattr(tracing, name, None)


def jobs(run, kinds: Optional[tuple] = None,
         captured: bool = False) -> Optional[list]:
    """The finished job records (of ``kinds``, else every kind) that started
    in ``[w0, s0)``, in order of start; those that captured a CUDA graph
    are left out unless ``captured``."""
    read = _reader("job_records")
    got = None if read is None else read(run.w0, run.s0)
    if got is None:
        return None
    out = [j for j in got if j.t_end is not None
           and (kinds is None or j.kind in kinds)
           and (captured or not j.captured)]
    return sorted(out, key=lambda j: j.t_start) or None


def requests(run) -> Optional[list]:
    """The request records that arrived in ``[w0, s0)``."""
    read = _reader("request_records")
    got = None if read is None else read(run.w0, run.s0)
    return got or None


def mean(values) -> Optional[float]:
    """The mean of ``values``; None when there are none or one is None
    (a device time off the card)."""
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)
