"""Find the benchmark's pieces by name: ``BENCHMARK.json`` at the checkout's
root, a configuration in ``configs/<name>.json``, a cell (its traffic) in
``cells/<name>.json``, a driver in ``drivers/<name>.py``, a model family in
``families/<name>.py``, an end-to-end metric in ``e2e/<name>.py``, a
per-layer metric in ``metrics/<name>.py``, a correctness check in
``checks/<name>.py`` and a cost function in ``costs/<name>.py``.

A later change adds a file and an entry; no file here names another
cell, configuration or metric.  Python files are loaded by path, so a
name may hold dots (``metrics/k1_roofline.decode.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH_DIR", "ROOT", "benchmark", "config", "cell", "module",
           "cell_metrics"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

_modules: dict = {}


def benchmark() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def cell(name: str) -> dict:
    return _json("cells", name)


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` loaded once, by path."""
    key = (kind, name)
    if key not in _modules:
        path = BENCH_DIR / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"_bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (``trace`` False) or its per-layer ones, each listed with the cells
    it covers or with none (then every cell)."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]
