"""Find an open-loop cell's knee once, on the card: the highest of a few
fixed arrival rates at which the window's backlog does not grow and at
least 90% of the requests sent in it meet both latency limits.

    python3 benchmark/tools/sweep.py --workload <cell> --seed <n>
        --seconds <s> --rates <r> [<r> ...]

The limits, in DistServe's manner, come from the unloaded system in the
same process: TTFT at most 5 x the median unloaded TTFT of a prompt of
the cell's median prompt length, TPOT at most 3 x the median unloaded
TPOT (one request at a time, the cell's median output).  Each rate runs
the cell's own traffic (warm-up, window, drain) on one engine built once.
The backlog grows when the median TTFT of the window's last third is
more than twice that of its first third.  One JSON line per rate.
``--order seeded`` lets the seed order the arrivals of a cell whose
traffic keeps one order for every seed, so that seeds sample schedules.
"""

import argparse
import asyncio
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run as bench_run  # noqa: E402
from benchmark.core import registry, stats, traffic  # noqa: E402


async def _unloaded(drv, comp, run, n: int = 5) -> tuple:
    tr = run.cell["traffic"]
    L, out = int(tr["prompt"]["median"]), int(tr["output"]["median"])
    rng = traffic.rng_of(run.seed, 7)
    ttft, tpot = [], []
    for _ in range(n):
        r = stats.Request(t_send=time.perf_counter(), prompt_len=L,
                          n_out=out)
        await drv._one(comp, r, traffic.token_ids(rng, L, run.dims.vocab))
        ttft.append(stats.ttft_ms(r, 0.0))
        tpot.append(stats.tpot_ms(r, 0.0))
    return statistics.median(ttft), statistics.median(tpot)


async def _sweep(drv, fam, comp, engine, run, rates) -> None:
    await drv._warm(comp, run.cell, run)
    engine.clear_prefixes()
    ttft0, tpot0 = await _unloaded(drv, comp, run)
    lim_ttft, lim_tpot = 5 * ttft0, 3 * tpot0
    print(json.dumps({"unloaded_ttft_ms": ttft0, "unloaded_tpot_ms": tpot0,
                      "limit_ttft_ms": lim_ttft, "limit_tpot_ms": lim_tpot}),
          flush=True)
    for rate in rates:
        r = dataclasses.replace(run, requests=[], counters={},
                                info={"rate": rate})
        late = await drv._load(r, comp, engine, fam)
        engine.clear_prefixes()
        sent = r.window()
        ttfts = [stats.ttft_ms(q, r.given_up) for q in sent]
        met = sum(1 for q, t in zip(sent, ttfts)
                  if q.ok and t <= lim_ttft
                  and (stats.tpot_ms(q, r.given_up) or 0.0) <= lim_tpot)
        third = max(len(sent) // 3, 1)
        first = statistics.median(ttfts[:third]) if sent else None
        last = statistics.median(ttfts[-third:]) if sent else None
        print(json.dumps({
            "rate": rate, "sent": len(sent),
            "failed": sum(1 for q in sent if not q.ok),
            "attained": met / len(sent) if sent else 0.0,
            "ttft_p50_ms": stats.percentile(ttfts, 50) if sent else None,
            "ttft_p95_ms": stats.percentile(ttfts, 95) if sent else None,
            "tpot_p95_ms": stats.percentile(
                [x for x in (stats.tpot_ms(q, r.given_up) for q in sent)
                 if x is not None], 95) if sent else None,
            "ttft_first_third_ms": first, "ttft_last_third_ms": last,
            "backlog_grows": bool(sent) and last > 2 * first,
            "tokens_per_s": stats.tokens_in(r.requests, r.w0, r.w1)
            / (r.w1 - r.w0),
            "late_ms_p99": stats.percentile(late, 99) * 1e3 if late else None,
        }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--order", choices=traffic.ORDERS)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench_run._environment()
    cell = registry.cell(args.workload)
    if args.order:
        cell["traffic"]["order"] = args.order
    run = bench_run.make_run(args.workload, args.seed, args.seconds, False,
                             args.device, cell=cell,
                             t_start=time.perf_counter())
    drv = registry.module("drivers", run.cell["driver"])
    fam = registry.module("families", run.config["family"])
    run.dims = fam.dims(run.config)
    w = fam.make_weights(run.config, run.seed, run.device)
    comp, engine = fam.build_system(run.config, w, run.device)
    try:
        asyncio.run(_sweep(drv, fam, comp, engine, run, args.rates))
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
