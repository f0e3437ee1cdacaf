"""``ttft_p95_ms``: the 95th percentile, over every request sent in the
window, of the time from its send (the open loop: when it was due) to its
first token; a request that failed or never answered counts with the
time it was waited for."""

from benchmark.core import stats


def read(run):
    sent = run.window()
    if not sent:
        return None
    return stats.percentile([stats.ttft_ms(r, run.given_up) for r in sent],
                            95)
