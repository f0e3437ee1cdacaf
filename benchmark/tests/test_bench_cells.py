"""Each cell's path end to end on the CPU at a tiny size (the port's plain
versions in place of its kernels), and the same runs with the timed path
broken underneath: ``correct`` must come out false."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, run_tiny, tiny_llm, tiny_resnet

LLM_CELLS = ["sc2-7b.decode", "sc2-7b.complete"]


def _end_to_end(workload: str) -> set:
    """The end-to-end metrics BENCHMARK.json gives the cell."""
    from benchmark.core import registry

    return {m["name"] for m in registry.cell_metrics(
        registry.benchmark(), workload, False)}


@pytest.mark.parametrize("workload", LLM_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_llm_cell_runs_and_is_correct(workload, trace):
    cell, cfg = tiny_llm(workload)
    line = run_tiny(workload, cell, cfg, trace=trace)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        assert "busy_s" in line["device"] and "breakdown" in line
        if workload == "sc2-7b.decode":
            assert {"decode_rows.decode", "tick_ms.decode"} <= names
    else:
        assert names == _end_to_end(workload)
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("trace", [False, True])
def test_resnet_cell_runs_and_is_correct(trace):
    cell, cfg = tiny_resnet()
    line = run_tiny("resnet50-int8.batch", cell, cfg, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    if trace:
        assert line["metrics"]["batch_rows.batch"]["value"] > 1
    else:
        assert set(line["metrics"]) == _end_to_end("resnet50-int8.batch")


def _alter_token(monkeypatch):
    """A token altered where it is produced: every sampled id moved by
    one."""
    from seldon_core_tpu_torch.runtime import llm

    real = llm.sample_tokens

    def wrong(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(llm, "sample_tokens", wrong)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the tick's K/V rows
    are never kept in the cache."""
    from seldon_core_tpu_torch.runtime import llm

    real = llm.paged_decode_step

    def step(params, cache, *a, **k):
        kept = {n: cache[n].clone() for n in ("k", "v")}
        out = real(params, cache, *a, **k)
        for n in ("k", "v"):
            cache[n].copy_(kept[n])
        return out

    monkeypatch.setattr(llm, "paged_decode_step", step)


def _half_batch_llm(monkeypatch):
    """Half of the tick's rows left out: their logits the mean of the
    rest's."""
    from seldon_core_tpu_torch.runtime import llm

    real = llm.paged_decode_step

    def step(*a, **k):
        logits, cache = real(*a, **k)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, cache

    monkeypatch.setattr(llm, "paged_decode_step", step)


@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged,
                                   _half_batch_llm])
@pytest.mark.parametrize("workload", LLM_CELLS)
def test_llm_faults_are_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    cell, cfg = tiny_llm(workload)
    line = run_tiny(workload, cell, cfg, seed=2**31 + 99)
    assert line["correct"] is False


def _half_batch_resnet(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from seldon_core_tpu_torch.models import resnet_int8

    real = resnet_int8.forward

    def forward(weights, x, **k):
        h = max(x.shape[0] // 2, 1)
        y = real(weights, x[:h], **k)
        rest = y.mean(dim=0, keepdim=True).expand(x.shape[0] - h, -1)
        return torch.cat([y, rest])

    monkeypatch.setattr(resnet_int8, "forward", forward)


def _alter_answer(monkeypatch):
    """An answer altered where it is produced: the classes shifted."""
    from seldon_core_tpu_torch.models import resnet_int8

    real = resnet_int8.forward
    monkeypatch.setattr(resnet_int8, "forward", lambda w, x, **k: torch.roll(
        real(w, x, **k), 1, dims=1))


@pytest.mark.parametrize("fault", [_half_batch_resnet, _alter_answer])
def test_resnet_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    cell, cfg = tiny_resnet()
    line = run_tiny("resnet50-int8.batch", cell, cfg, seed=2**31 + 98)
    assert line["correct"] is False


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sc2-7b.decode", "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "resnet50-int8.batch", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); "
            "from conftest import run_tiny, tiny_llm; "
            "from benchmark.core import result; "
            "cell, cfg = tiny_llm('sc2-7b.decode'); "
            "line = run_tiny('sc2-7b.decode', cell, cfg, seconds=0.8); "
            "print(json.dumps(result.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", "import json; " + code],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "seldon_core_tpu")
                   for n in _imports_of_harness())


def _imports_of_harness() -> list:
    """Top-level names the harness's sources import (a static look beside
    the run's own check)."""
    import ast

    names = []
    for p in (ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
    return names


def test_references_import_nothing_of_the_port():
    for name in ("transformer", "resnet50"):
        src = (ROOT / "benchmark" / "references" / f"{name}.py").read_text()
        assert "seldon_core_tpu" not in src
