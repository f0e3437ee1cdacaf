"""Cells that serve a language model: requests through the port's
``LLMComponent.stream`` (the call behind ``POST /api/v0.1/stream``) in
process, on the event loop the engine serves on.

A run: the weights made from the seed and the engine built (the
configuration's family); the cell's shapes warmed (one greedy request of
two new tokens per length of a geometric grid over the cell's prompt
range, then the automatic prefix cache cleared); then the load: a
warm-up period, the window, and a drain in which requests sent in the
window finish and no new one is sent.  Closed loop: each client sends its
next request when the last has answered.  Open loop: requests are sent
on the seed's schedule whatever has answered, each timed from when it was
due; how late the generator ran is printed before the last line.

Once the load has ended: the peak of device memory is read, the engine
is freed, and a sample of the window's finished requests, drawn from the
seed with the one that served most tokens in it, is compared with the
plain reference (``checks/logit_gap.py``).  Where ``run.info["control"]``
is set (``tools/control.py``), the control's answers are then judged in
the program's place and their line printed too
(``run.info["control_line"]``).
"""

from __future__ import annotations

import asyncio
import gc
import json
import sys
import time

import torch

from benchmark.core import registry, stats, traffic
from benchmark.core.context import Run, finish
from benchmark.core.trace import Slice, prime

__all__ = ["run", "warm_lengths", "sample_requests", "TRAFFIC_KEYS"]

#: the loops this driver runs and the ``traffic`` keys it reads in each
#: (``core/traffic.py``); every request is greedy
TRAFFIC_KEYS = {"closed": ("clients", "stagger_s", "rounds", "order",
                           "prompt", "output"),
                "open": ("rate", "order", "prompt", "output")}


def warm_lengths(warm: dict) -> list:
    """A geometric grid of prompt lengths from ``warm["from"]`` to
    ``warm["to"]``, ``per_octave`` a doubling, both ends in."""
    a, b, k = int(warm["from"]), int(warm["to"]), int(warm["per_octave"])
    out, x = [], float(a)
    while x < b:
        out.append(int(round(x)))
        x *= 2 ** (1.0 / k)
    out.append(b)
    return sorted(set(out))


def sample_requests(requests: list, seed: int, n: int) -> list:
    """``n`` of the finished ``requests``: the one that served most tokens,
    and the rest drawn from the seed."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.token_times), r.prompt_len))
    rest = [r for r in done if r is not longest]
    rng = traffic.rng_of(seed, 4)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


async def _sleep_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0:
        await asyncio.sleep(dt)


async def _one(comp, r: stats.Request, ids: list) -> None:
    """One request through ``comp.stream``; fills ``r``."""
    from seldon_core_tpu_torch.messages import SeldonMessage

    msg = SeldonMessage(json_data={"prompt_ids": ids, "n_new": r.n_out})
    served = []
    try:
        async for ev in comp.stream(msg):
            if "token" in ev:
                r.token_times.append(time.perf_counter())
                served.append(int(ev["token"]))
        r.ok = len(served) == r.n_out
        if not r.ok:
            r.error = f"served {len(served)} of {r.n_out} tokens"
    except asyncio.CancelledError:
        r.error = "not answered when the harness stopped waiting"
        raise
    except Exception as e:  # a failed request is counted, not raised
        r.error = repr(e)
    finally:
        if r.token_times:
            r.t_first, r.t_last = r.token_times[0], r.token_times[-1]
        r.out = {"prompt": ids, "served": served}


async def _load(run: Run, comp, engine, fam) -> list:
    cell, tr = run.cell, run.cell["traffic"]
    rng = traffic.rng_of(run.seed, 3)
    vocab = run.dims.vocab
    t0 = time.perf_counter()
    run.w0 = t0 + float(cell["warmup_s"])
    run.w1 = run.w0 + run.seconds
    tasks: set = set()
    late: list = []

    async def edges():
        await _sleep_until(run.w0)
        run.counters["window_start"] = fam.counters(engine)
        if run.trace:
            await _sleep_until(run.w1 - float(cell["slice_s"]))
            run.slice = Slice()
            run.slice.start()
            run.counters["slice_start"] = fam.counters(engine)
            run.s0 = run.slice.t0
        await _sleep_until(run.w1)
        run.counters["window_end"] = fam.counters(engine)
        if run.trace:
            run.counters["slice_end"] = fam.counters(engine)
            run.slice.stop()
            run.s1 = run.slice.t1

    if tr["loop"] == "closed":
        plans = traffic.closed_loop(tr, run.seed)
        prompts = [[traffic.token_ids(rng, q["prompt_len"], vocab)
                    for q in p["requests"]] for p in plans]

        async def client(c):
            await _sleep_until(t0 + plans[c]["start_s"])
            for k, q in enumerate(plans[c]["requests"]):
                now = time.perf_counter()
                if now >= run.w1:
                    return
                r = stats.Request(t_send=now, prompt_len=q["prompt_len"],
                                  n_out=q["n_out"], key=(c, k))
                run.requests.append(r)
                await _one(comp, r, prompts[c][k])

        for c in range(len(plans)):
            tasks.add(asyncio.ensure_future(client(c)))
    else:
        arrivals = traffic.open_loop(tr, run.seed,
                                     float(cell["warmup_s"]) + run.seconds,
                                     rate=run.info.get("rate"))
        prompts = [traffic.token_ids(rng, a["prompt_len"], vocab)
                   for a in arrivals]

        async def schedule():
            for i, a in enumerate(arrivals):
                due = t0 + a["at_s"]
                await _sleep_until(due)
                late.append(time.perf_counter() - due)
                r = stats.Request(t_send=due, prompt_len=a["prompt_len"],
                                  n_out=a["n_out"], key=(i,))
                run.requests.append(r)
                tasks.add(asyncio.ensure_future(_one(comp, r, prompts[i])))

        await asyncio.gather(edges(), schedule())
    if tr["loop"] == "closed":
        await edges()
    deadline = run.w1 + float(cell["drain_s"])
    pending = {t for t in tasks if not t.done()}
    if pending:
        _, pending = await asyncio.wait(
            pending, timeout=max(deadline - time.perf_counter(), 0.0))
    for t in pending:
        t.cancel()
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    run.given_up = time.perf_counter()
    for t in tasks:
        if t.done() and not t.cancelled() and t.exception() is not None:
            raise t.exception()
    return late


async def _warm(comp, cell: dict, run: Run) -> None:
    rng = traffic.rng_of(run.seed, 5)
    for n in warm_lengths(cell["warm"]):
        r = stats.Request(t_send=time.perf_counter(), prompt_len=n, n_out=2)
        await _one(comp, r, traffic.token_ids(rng, n, run.dims.vocab))
        if not r.ok:
            raise RuntimeError(f"warm-up request of {n} tokens failed: "
                               f"{r.error}")


async def _serve(run: Run, comp, engine, fam) -> list:
    await _warm(comp, run.cell, run)
    engine.clear_prefixes()
    if run.trace:
        prime()
    run.setup_s = time.perf_counter() - run.t_start
    return await _load(run, comp, engine, fam)


def run(run: Run) -> dict:
    fam = registry.module("families", run.config["family"])
    run.dims = fam.dims(run.config)
    w = fam.make_weights(run.config, run.seed, run.device)
    comp, engine = fam.build_system(run.config, w, run.device)
    try:
        late = asyncio.run(_serve(run, comp, engine, fam))
        cuda = run.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    finally:
        engine.close()
    del comp, engine
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if run.slice is not None:
        run.slice.reduce()
    sent = run.window()
    summary = {"requests_sent_in_window": len(sent),
               "answered": sum(r.ok for r in sent),
               "requests_in_run": len(run.requests),
               "setup_s": run.setup_s}
    if late:
        summary["generator_late_ms"] = {
            "p50": stats.percentile(late, 50) * 1e3,
            "p99": stats.percentile(late, 99) * 1e3,
            "max": max(late) * 1e3}
    ck = run.cell["check"]
    sample = [r.out for r in sample_requests(sent, run.seed,
                                             int(ck["requests"]))]
    check = registry.module("checks", ck["name"])
    ref = registry.module("references", run.config["reference"])
    t = time.perf_counter()
    limit = float(ck["limit"])
    checks, n = check.compare(ref, w, run.dims, sample, limit)
    summary.update(check_requests=len(sample), tokens_checked=n,
                   check_s=time.perf_counter() - t)
    print(json.dumps(summary), flush=True)
    print(json.dumps(summary), file=sys.stderr, flush=True)
    line = finish(run, checks, peak)
    if run.info.get("control"):
        ctl = check.control_answers(ref, w, run.dims, sample)
        run.info["control_line"] = finish(
            run, check.compare(ref, w, run.dims, ctl, limit)[0], peak)
    return line
