"""The two readings a cell's correctness limit lies between, at the cell's
own size and load, on the card.

    python3 benchmark/tools/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

For each seed, in one process, one run of the cell as ``run.py`` makes it
(its line printed as usual); then the control's answers over the same
sample, put in the program's place and judged by the cell's own check and
limit, with their line printed as a run's is: the plain reference computed
in the precision just below the configuration's (int4 weights where it
states int8), which has to come out ``correct`` false.  Last for each
seed, one JSON line ``{"control_of", "seed", "program",
"program_correct", "control", "control_correct", "limit"}``.  The
benchmark's own runs never compute the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench_run._environment()
    for seed in args.seeds:
        run = bench_run.make_run(args.workload, seed, args.seconds, False,
                                 args.device, t_start=time.perf_counter())
        run.info["control"] = True
        line = bench_run.execute(run)
        ctl = run.info["control_line"]
        (name, got), = line["checks"].items()
        print(json.dumps({"control_of": args.workload, "seed": seed,
                          "program": got["value"],
                          "program_correct": line["correct"],
                          "control": ctl["checks"][name]["value"],
                          "control_correct": ctl["correct"],
                          "limit": got["limit"]}), flush=True)
        del run
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
