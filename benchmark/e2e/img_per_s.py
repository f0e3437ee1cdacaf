"""``img_per_s``: images answered inside the window, over the window's
seconds."""

from benchmark.core import stats


def read(run):
    n = stats.rows_in(run.requests, run.w0, run.w1)
    return n / (run.w1 - run.w0) if n else None
