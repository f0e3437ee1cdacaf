"""Tests of the benchmark harness.  They run on the CPU with the port's
plain versions at tiny sizes; a test that needs the card takes the
``card`` marker and the ``cuda`` fixture, which skips without one (the
card is looked for inside the fixture, never while a module is
imported)."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


def tiny_llm(workload: str) -> tuple:
    """The cell's files at a tiny size: (cell, config)."""
    from benchmark.core import registry

    cell = copy.deepcopy(registry.cell(workload))
    cfg = copy.deepcopy(registry.config(cell["config"]))
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
    cfg["engine"].update(max_slots=4, pages=129, max_len=256)
    cell.update(warmup_s=0.3, drain_s=30, slice_s=0.6,
                warm={"from": 8, "to": 64, "per_octave": 1})
    tr = cell["traffic"]
    if tr["loop"] == "closed":
        tr.update(clients=4, stagger_s=0.2,
                  prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
                  output={"median": 32, "sigma": 0.4, "min": 16, "max": 64})
    else:
        tr.update(rate=8.0,
                  prompt={"median": 40, "sigma": 0.5, "min": 16, "max": 120},
                  output={"median": 16, "sigma": 0.5, "min": 8, "max": 32})
    return cell, cfg


def tiny_resnet() -> tuple:
    from benchmark.core import registry

    cell = copy.deepcopy(registry.cell("resnet50-int8.batch"))
    cfg = copy.deepcopy(registry.config(cell["config"]))
    cfg.update(stage_sizes=[1, 1, 1, 1], image_size=32, num_classes=10)
    cell["traffic"].update(clients=4, rows_per_request=2, pool_images=32)
    cell["check"]["keep_every"] = 1
    cell.update(warmup_s=0.3, drain_s=30, slice_s=0.8)
    cell["deployment"]["spec"]["annotations"][
        "seldon.io/batch-max-size"] = "8"
    return cell, cfg


def run_tiny(workload: str, cell: dict, cfg: dict, seed: int = 2**31 + 7,
             seconds: float = 4.0, trace: bool = False, device="cpu"):
    """One run of ``workload`` on ``device`` at the given files: the
    result line's object."""
    from benchmark import run as bench_run

    run = bench_run.make_run(workload, seed, seconds, trace, device,
                             cell=cell, config=cfg,
                             t_start=time.perf_counter())
    return bench_run.execute(run)
