"""``tokens_per_s``: output tokens delivered inside the window, over the
window's seconds."""

from benchmark.core import stats


def read(run):
    n = stats.tokens_in(run.requests, run.w0, run.w1)
    return n / (run.w1 - run.w0) if n else None
