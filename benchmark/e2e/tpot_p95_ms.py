"""``tpot_p95_ms``: the 95th percentile, over the requests sent in the
window, of (last token - first token) / (tokens - 1); a request that
failed counts with the time it was waited for."""

from benchmark.core import stats


def read(run):
    xs = [x for x in (stats.tpot_ms(r, run.given_up) for r in run.window())
          if x is not None]
    return stats.percentile(xs, 95) if xs else None
