"""Arithmetic on a run's timeline: requests with their send, first-token,
token and answer times on the host clock (``time.perf_counter``), and the
window ``[w0, w1)``.

A request that failed or had not answered when the harness stopped
waiting counts as missing every limit: its latency is the time from its
send to the moment the harness gave up (``given_up``), a lower bound of
what its user waited.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Request", "percentile", "sent_in", "ttft_ms",
           "tpot_ms", "tokens_in", "rows_in"]


@dataclass
class Request:
    """One request as its client saw it."""

    t_send: float                      # sent (open loop: when it was due)
    prompt_len: int = 0
    n_out: int = 0
    rows: int = 0                      # rows (images) it carries
    t_first: Optional[float] = None    # first token
    t_last: Optional[float] = None     # last token, or the answer
    token_times: list = field(default_factory=list)
    ok: bool = False
    error: Optional[str] = None
    out: object = None                 # what it answered (kept for checks)
    key: tuple = ()                    # (client, index) or (arrival,)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100), linear between closest ranks (the
    usual definition, numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sent_in(requests, w0: float, w1: float) -> list:
    return [r for r in requests if w0 <= r.t_send < w1]


def ttft_ms(r: Request, given_up: float) -> float:
    if r.ok and r.t_first is not None:
        return (r.t_first - r.t_send) * 1e3
    return (given_up - r.t_send) * 1e3


def tpot_ms(r: Request, given_up: float) -> Optional[float]:
    """Mean gap between a request's tokens after the first; None for a
    sound one-token answer (it has no gap)."""
    if not r.ok:
        return (given_up - r.t_send) * 1e3
    n = len(r.token_times)
    if n < 2:
        return None
    return (r.t_last - r.t_first) / (n - 1) * 1e3


def tokens_in(requests, a: float, b: float, skip_first: bool = False) -> int:
    """Tokens delivered in ``[a, b)``; ``skip_first`` leaves out each
    request's first token (made by its prefill, not by a decode tick)."""
    n = 0
    for r in requests:
        times = r.token_times[1:] if skip_first else r.token_times
        n += sum(1 for t in times if a <= t < b)
    return n


def rows_in(requests, a: float, b: float) -> int:
    """Rows answered in ``[a, b)``."""
    return sum(r.rows for r in requests
               if r.ok and r.t_last is not None and a <= r.t_last < b)
