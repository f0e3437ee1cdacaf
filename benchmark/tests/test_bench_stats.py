"""TTFT, TPOT and rate arithmetic on hand-made timelines."""

import pytest

from benchmark.core import stats
from benchmark.core.context import Run


def _req(t_send, times, ok=True, prompt_len=10):
    r = stats.Request(t_send=t_send, prompt_len=prompt_len,
                      n_out=len(times), token_times=list(times), ok=ok)
    if times:
        r.t_first, r.t_last = times[0], times[-1]
    return r


def _run(requests, w0=10.0, w1=20.0, given_up=40.0):
    return Run(workload="x", cell={}, config={}, seed=0, seconds=w1 - w0,
               trace=False, requests=requests, w0=w0, w1=w1,
               given_up=given_up)


def test_percentile():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)
    assert stats.percentile([7], 95) == 7


def test_ttft_tpot_and_tokens_with_a_stall():
    # a steady stream of tokens every 0.1 s, then a 2 s stall, then more
    times = [11.0 + 0.1 * i for i in range(10)] + [13.0, 13.1]
    r = _req(10.5, times)
    assert stats.ttft_ms(r, 40.0) == pytest.approx(500.0)
    # (13.1 - 11.0) / 11 gaps: the stall is in the mean gap
    assert stats.tpot_ms(r, 40.0) == pytest.approx(2100.0 / 11)
    assert stats.tokens_in([r], 11.0, 12.0) == 10
    assert stats.tokens_in([r], 11.0, 12.0, skip_first=True) == 9
    assert stats.tokens_in([r], 12.0, 14.0) == 2


def test_failed_and_late_requests_count_as_missing():
    ok = _req(11.0, [11.2, 11.3])
    failed = _req(12.0, [], ok=False)
    r = _run([ok, failed, _req(5.0, [5.1, 5.2]), _req(25.0, [25.1])])
    assert r.window() == [ok, failed]
    assert stats.ttft_ms(failed, r.given_up) == pytest.approx(28000.0)
    assert stats.tpot_ms(failed, r.given_up) == pytest.approx(28000.0)
    assert stats.tpot_ms(_req(1.0, [1.5]), 40.0) is None


def test_end_to_end_readers():
    from benchmark.core import registry

    reqs = [_req(10.0 + i, [10.1 + i, 10.2 + i, 10.3 + i]) for i in range(10)]
    r = _run(reqs)
    assert registry.module("e2e", "ttft_p95_ms").read(r) == pytest.approx(
        100.0)
    assert registry.module("e2e", "tpot_p95_ms").read(r) == pytest.approx(
        100.0)
    assert registry.module("e2e", "tokens_per_s").read(r) == pytest.approx(
        30 / 10.0)
    imgs = [stats.Request(t_send=10.0 + i, rows=8, ok=True,
                          t_last=10.5 + i) for i in range(10)]
    imgs.append(stats.Request(t_send=19.9, rows=8, ok=True, t_last=20.1))
    assert registry.module("e2e", "img_per_s").read(_run(imgs)) == \
        pytest.approx(80 / 10.0)
