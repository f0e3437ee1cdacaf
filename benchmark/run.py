"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``benchmark/configs/<name>.json``) and its traffic
and run parameters are in ``benchmark/cells/<cell>.json``; the cell's
driver (``benchmark/drivers/<driver>.py``) builds the port's system from
the configuration, warms the cell's shapes, offers the load, times the
window on the host clock and compares a sample of the answers with the
plain reference.  ``--trace 1`` also profiles the window's last seconds and
reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is the result (``core/result.py``).
Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits with 2; if JAX or the JAX package was loaded,
with 3; if it is still going after ``WATCHDOG_S`` seconds, it prints every
thread's stack and exits with 1.  Every cache the port writes goes under
``build/`` in the checkout, at fixed paths.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a run still going after this many seconds prints every thread's stack
#: to standard error and exits (1): a hung run fails inside the limit of
#: 360 s rather than holding the card
WATCHDOG_S = 330

#: fixed cache directories inside the checkout (the port builds its kernel
#: library under build/torch_kernels by itself)
CACHES = {"TRITON_CACHE_DIR": "build/bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "CUDA_CACHE_PATH": "build/bench_cache/cuda"}


def _environment() -> None:
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_run(workload: str, seed: int, seconds: float, trace: bool,
             device, cell: dict = None, config: dict = None,
             t_start: float = None):
    """The :class:`~benchmark.core.context.Run` of a cell (its files, or
    the ``cell`` and ``config`` given) on ``device``; a traffic key or
    value its driver does not read is refused (ValueError)."""
    import torch

    from benchmark.core import registry, traffic
    from benchmark.core.context import Run
    from benchmark.core.peaks import peaks_for

    cell = registry.cell(workload) if cell is None else cell
    config = registry.config(cell["config"]) if config is None else config
    drv = registry.module("drivers", cell["driver"])
    traffic.validate(cell["traffic"], drv.TRAFFIC_KEYS)
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return Run(workload=workload, cell=cell, config=config, seed=seed,
               seconds=float(seconds), trace=bool(trace), device=device,
               kind=kind, peaks=peaks_for(kind),
               t_start=_T_START if t_start is None else t_start)


def execute(run) -> dict:
    """Drive ``run`` with its cell's driver; the result line's object."""
    from benchmark.core import registry

    return registry.module("drivers", run.cell["driver"]).run(run)


def main(argv=None) -> int:
    args = parse(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    _environment()
    from benchmark.core import registry

    bench = registry.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{seen} visible: no result", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    if cell["config"] != entry["config"]:
        raise ValueError(f"{args.workload}: cell file names "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    run = make_run(args.workload, args.seed, args.seconds, args.trace,
                   "cuda:0", cell=cell)
    run.count = int(entry["chips"])
    execute(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
