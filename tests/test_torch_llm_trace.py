"""The LLM engine's job and request records (``utils/tracing.py``), the
spans made from them, the profiler ranges of its jobs, and the benchmark's
readers of them, on the CPU.

A tiny paged engine (2 slots) serves 4 requests at once, in a closed loop
(each client waits for its answer) and in an open one (sent on a schedule),
so that two of them wait for a slot.  Checked:

- one ``tick`` record per run of the tick program, its rows the active
  slots and its context their positions + 1, summed over the run equal to
  the tokens the ticks made and the contexts they attended;
- each prefill record's true and padded tokens are its prompt and bucket;
- each request's phases are ordered ``t_arrive <= t_slot <= t_reserved <=
  t_start <= t_end <= t_first``, and the two waiters hold their slot only
  after another request's first token;
- the device fields are None on the CPU;
- a reader asking past a ring's bound gets None;
- spans are made under an enabled tracer, on the records' clock, and no
  span is made without one;
- a job's ``llm.*`` range is in a ``device_profile`` window's trace within
  1 ms of its record mapped through the clock offset, and
  ``profile_annotation`` opens in such a window only, not under another
  ``torch.profiler`` session;
- the eight readers of ``benchmark/metrics/`` give the values worked out
  by hand on synthetic records, and None where the program keeps none.
"""

import asyncio
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.core import registry
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime.paged import PagedConfig
from seldon_core_tpu_torch.utils import tracing as tt

CFG = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=64, max_seq=64,
                            dtype=torch.float32)
N_NEW = 6
LENS = (3, 6, 9, 13)  # buckets 8, 8, 16, 16


def _engine():
    params = ttf.init_params(torch.Generator().manual_seed(0), CFG)
    return tllm.PagedLLMEngine(params, CFG, PagedConfig(n_pages=32,
                                                        page_size=8),
                               max_slots=2, max_len=64)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 64, size=n).astype(
        np.int32)


async def _closed(eng):
    async def client(i):
        await eng.generate(_prompt(LENS[i], i), N_NEW)
    await asyncio.gather(*(client(i) for i in range(len(LENS))))


async def _open(eng):
    async def send(i):
        await asyncio.sleep(0.002 * i)  # due times, whatever has answered
        await eng.generate(_prompt(LENS[i], i), N_NEW)
    await asyncio.gather(*(send(i) for i in range(len(LENS))))


def _serve(loop_kind):
    eng = _engine()
    t0 = time.perf_counter()
    try:
        asyncio.run(_closed(eng) if loop_kind == "closed" else _open(eng))
    finally:
        eng.close()
    jobs = [j for j in tt.job_records(t0) if j.engine == eng.engine_id]
    reqs = [r for r in tt.request_records(t0) if r.engine == eng.engine_id]
    return eng, jobs, reqs


@pytest.mark.parametrize("loop_kind", ["closed", "open"])
def test_records_of_a_served_run(loop_kind):
    eng, jobs, reqs = _serve(loop_kind)
    ticks = [j for j in jobs if j.kind == "tick"]
    stats = eng.program_stats()["programs"]["tick"]
    assert len(ticks) == stats["replays"] + stats["eager_runs"] > 0
    # every tick token: rows summed; every tick's context, position + 1
    assert sum(j.rows for j in ticks) == len(LENS) * (N_NEW - 1)
    assert sum(j.context for j in ticks) == sum(
        L + j for L in LENS for j in range(1, N_NEW))
    assert all(1 <= j.rows <= 2 for j in ticks)

    assert len(reqs) == len(LENS)
    assert sorted(r.prompt for r in reqs) == sorted(LENS)
    for r in reqs:
        assert r.outcome == "ok" and r.tokens == N_NEW
        assert r.variant == "solo" and len(r.jobs) == 1
        job = r.jobs[0]
        bucket = tllm._bucket(r.prompt)
        assert (job.kind, job.key) == ("prefill", (1, bucket))
        assert (job.tokens, job.padded, r.bucket) == (r.prompt, bucket,
                                                      bucket)
        assert (r.t_arrive <= r.t_slot <= r.t_reserved <= job.t_submit
                <= job.t_start <= job.t_end <= r.t_first <= r.t_done)
    # two of the four waited for a slot: each got it after another
    # request had been answered its first token
    by_slot = sorted(reqs, key=lambda r: r.t_slot)
    for w in by_slot[2:]:
        assert any(o.t_first <= w.t_slot for o in by_slot[:2])
    kinds = {j.kind for j in jobs}
    assert kinds == {"prefill", "insert", "tick"}
    assert all(j.t_submit <= j.t_start <= j.t_end for j in jobs)
    assert not any(j.captured for j in jobs)
    # off the card no device field is read
    assert all(j.device_ms is None and j.gap_ms is None for j in jobs)


def test_ring_reader_gets_none_past_its_bound():
    ring = tt.RecordRing(4)
    recs = [tt.RequestRecord(engine=0, t_arrive=float(i), prompt=1)
            for i in range(6)]
    for r in recs:
        ring.add(r)
    assert ring.between(0.0) is None
    assert ring.between(1.0) is None  # record 1 was dropped too
    assert ring.between(2.0) == recs[2:]
    assert ring.between(2.0, 4.0) == recs[2:4]
    jobs = tt.RecordRing(2)
    a, b, c = (tt.JobRecord("tick", 0, t_submit=t) for t in (1.0, 2.0, 3.0))
    a.t_start = 5.0  # a job is ordered by its start once it has one
    for j in (a, b, c):
        jobs.add(j)
    assert jobs.between(3.0) is None and jobs.between(5.5) == []


def test_rings_hold_a_decode_window():
    assert tt.JOBS.size >= 16384 and tt.REQUESTS.size >= 4096


def test_spans_under_an_enabled_tracer_and_none_otherwise(monkeypatch):
    eng = _engine()
    made = []
    real = tllm.add_request_spans
    monkeypatch.setattr(tllm, "add_request_spans",
                        lambda sp, req: (made.append(req), real(sp, req)))

    async def run(tracer):
        with tracer.trace("ab" * 16) as root:
            await eng.generate(_prompt(5, 1), 4)
        return root

    try:
        root = asyncio.run(run(tt.Tracer()))
        off = asyncio.run(run(tt.NULL_TRACER))
    finally:
        eng.close()
    (req,) = made
    names = [c.name for c in root.children]
    assert names == ["llm.slot_wait", "llm.page_wait", "llm.prefill_queued",
                     "llm.prefill", "llm.decode"]
    sp = {c.name: c for c in root.children}
    job = req.jobs[0]
    assert sp["llm.slot_wait"].start_ns == tt.epoch_ns(req.t_arrive)
    assert sp["llm.prefill_queued"].start_ns == tt.epoch_ns(job.t_submit)
    assert sp["llm.prefill"].start_ns == tt.epoch_ns(job.t_start)
    assert sp["llm.prefill"].end_ns == tt.epoch_ns(job.t_end)
    assert sp["llm.decode"].end_ns == tt.epoch_ns(req.t_done)
    assert sp["llm.prefill"].attributes == {"variant": "solo", "bucket": 8,
                                            "tokens": 5}
    assert sp["llm.decode"].attributes == {"tokens": 4}
    assert all(c.trace_id == root.trace_id and c.parent_span_id ==
               root.span_id for c in root.children)
    assert root.start_ns <= sp["llm.slot_wait"].start_ns
    assert sp["llm.decode"].end_ns <= root.end_ns
    # the disabled tracer: no span made, nothing added
    assert off is tt._DUMMY and not off.children and len(made) == 1


def test_one_clock_for_spans_and_records():
    t = time.perf_counter()
    assert abs(tt.epoch_ns(t) - time.time_ns()) < 50_000_000
    tracer = tt.Tracer()
    with tracer.trace("cd" * 16) as root:
        root.add_event("e")
    assert root.start_ns <= root.events[0]["time_ns"] <= root.end_ns
    assert abs(root.start_ns - tt.epoch_ns(t)) < 50_000_000


def _ranges(session, prefix):
    """The ranges named ``prefix...`` in a ``device_profile`` window's
    Chrome trace, with their starts in Unix-epoch ns."""
    trace = json.load(open(session.path))
    base = trace.get("baseTimeNanoseconds", 0)
    return [(e["name"], round(e["ts"] * 1e3) + base)
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(prefix)]


def test_annotation_opens_in_a_device_profile_window_only(tmp_path):
    assert not tt.profiler_active()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tt.profile_annotation("llm.bare"):
            torch.ones(4).add_(1)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("llm.")]
    with tt.device_profile(str(tmp_path)) as session:
        with tt.profile_annotation("llm.window"):
            torch.ones(4).add_(1)
    assert [n for n, _ in _ranges(session, "llm.")] == ["llm.window"]


def test_job_ranges_in_the_profile_at_their_records(tmp_path):
    eng = _engine()

    async def run():
        await eng.generate(_prompt(5, 2), 2)  # the worker thread warmed
        with tt.device_profile(str(tmp_path)) as session:
            # the session's first range on the worker pays its set-up
            await eng._on_device(lambda: None, rec=eng._job("warm"))
            t0 = time.perf_counter()
            await eng.generate(_prompt(11, 3), 4)
        return session, t0

    try:
        session, t0 = asyncio.run(run())
    finally:
        eng.close()
    jobs = {j.label: j for j in tt.job_records(t0)
            if j.engine == eng.engine_id}
    got = [(n, s) for n, s in _ranges(session, "llm.") if n != "llm.warm"]
    names = [n for n, _ in got]
    assert "llm.prefill(1, 16)" in names and "llm.tick" in names
    assert "llm.insert(11)" in names
    for name, start in got:
        if name == "llm.tick":
            continue  # several ticks share the name: matched below
        lag = start - tt.epoch_ns(jobs[name].t_start)
        assert -100_000 <= lag <= 1_000_000, (name, lag)
    ticks = sorted(j.t_start for j in tt.job_records(t0)
                   if j.engine == eng.engine_id and j.kind == "tick")
    starts = sorted(s for n, s in got if n == "llm.tick")
    assert len(starts) == len(ticks)
    for t, s in zip(ticks, starts):
        assert -100_000 <= s - tt.epoch_ns(t) <= 1_000_000


# ---- the benchmark's readers over synthetic records -----------------------

def _job(kind, t_submit, t_start, t_end, device_ms=None, gap_ms=None,
         captured=False, **fields):
    j = tt.JobRecord(kind, 7, t_submit, **fields)
    j.t_start, j.t_end, j.captured = t_start, t_end, captured
    j.device_ms, j.gap_ms = device_ms, gap_ms
    return j


def _synthetic(monkeypatch, device=True):
    """A window [10, 20): three ticks, two prefills, an extend, an insert
    and a tick that captured; one job before it and one after; two
    requests in it."""
    d = (lambda x: x) if device else (lambda x: None)
    jobs = tt.RecordRing(64)
    for j in (
            _job("tick", 9.0, 9.5, 9.52, d(15.0), d(1.0),       # before
                 rows=9, context=900),
            _job("tick", 10.0, 10.0, 10.02, d(16.0), d(2.0),
                 rows=2, context=100),
            _job("prefill", 10.021, 10.023, 10.1, d(70.0), d(0.5),
                 tokens=100, padded=128),
            _job("tick", 10.101, 10.102, 10.12, d(17.0), d(3.0),
                 rows=3, context=200),
            _job("insert", 10.121, 10.121, 10.122, d(0.2), d(0.1)),
            _job("tick", 10.125, 10.125, 10.145, d(18.0), d(4.0),
                 rows=3, context=210),
            _job("tick", 10.15, 10.15, 10.3, d(99.0), d(9.0), True,
                 rows=4, context=290),
            _job("prefill", 19.0, 19.0, 19.1, d(130.0), d(0.0),
                 tokens=200, padded=256),
            _job("extend", 19.2, 19.2, 19.3, d(30.0), d(0.0),
                 tokens=20, padded=32),
            _job("prefill", 20.0, 20.0, 20.2, d(500.0), d(0.0),  # after
                 tokens=1, padded=1024)):
        jobs.add(j)
    reqs = tt.RecordRing(64)
    waits = (0.1, 0.3, 0.2)
    for i, (t, w) in enumerate(zip((9.0, 11.0, 12.0), waits)):
        r = tt.RequestRecord(engine=7, t_arrive=t, prompt=100)
        r.jobs.append(_job("prefill", t + w / 2, t + w, t + w + 0.1))
        reqs.add(r)
    reqs.add(tt.RequestRecord(engine=7, t_arrive=13.0, prompt=9))  # shed
    monkeypatch.setattr(tt, "job_records", jobs.between)
    monkeypatch.setattr(tt, "request_records", reqs.between)
    return SimpleNamespace(w0=10.0, s0=20.0)


def _read(name, run):
    return registry.module("metrics", name).read(run)


def test_readers_on_a_synthetic_run(monkeypatch):
    run = _synthetic(monkeypatch)
    assert _read("tick_device_ms.decode", run) == pytest.approx(17.0)
    # gaps of the seven jobs that did not capture, over three ticks
    assert _read("tick_gap_ms.decode", run) == pytest.approx(
        (2.0 + 0.5 + 3.0 + 0.1 + 4.0 + 0.0 + 0.0) / 3)
    # tick ends to the next tick's submission: 81 ms, 5 ms (not into the
    # tick that captured)
    assert _read("tick_loop_ms.decode", run) == pytest.approx(43.0)
    # waits 300 and 200 ms: the 90th percentile between them
    assert _read("prefill_wait_p90_ms.complete", run) == pytest.approx(
        290.0)
    assert _read("prefill_ms.complete", run) == pytest.approx(100.0)
    # the four ticks in the window, the one that captured among them
    assert _read("tick_rows.decode", run) == pytest.approx(3.0)
    assert _read("tick_context.decode", run) == pytest.approx(200.0)
    # two prefills and an extend: 320 true tokens of 416
    assert _read("prefill_pad_share.complete", run) == pytest.approx(
        100.0 * 96 / 416)


def test_readers_without_device_times_or_records(monkeypatch):
    run = _synthetic(monkeypatch, device=False)
    for name in ("tick_device_ms.decode", "tick_gap_ms.decode",
                 "prefill_ms.complete"):
        assert _read(name, run) is None
    assert _read("tick_loop_ms.decode", run) == pytest.approx(43.0)
    assert _read("tick_rows.decode", run) == pytest.approx(3.0)
    # a program that keeps no records (the parent's): every reader None
    monkeypatch.delattr(tt, "job_records")
    monkeypatch.delattr(tt, "request_records")
    for name in ("tick_device_ms.decode", "tick_gap_ms.decode",
                 "tick_loop_ms.decode", "prefill_wait_p90_ms.complete",
                 "prefill_ms.complete", "tick_rows.decode",
                 "tick_context.decode", "prefill_pad_share.complete"):
        assert _read(name, run) is None
