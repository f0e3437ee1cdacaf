"""The last line's contract, the checks printed beside their limits, and
the gate that withholds a result when JAX or the JAX package is loaded."""

import io
import json

import pytest

from benchmark.core import result
from benchmark.core.context import Run, finish


def test_forbidden_compares_whole_top_level_names():
    mods = {"seldon_core_tpu_torch": 1, "seldon_core_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1, "torch": 1}
    assert result.forbidden_modules(mods) == []
    mods.update({"seldon_core_tpu.runtime": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax.linen": 1})
    assert result.forbidden_modules(mods) == [
        "flax.linen", "jax", "jaxlib.xla", "seldon_core_tpu.runtime"]


def test_emit_line_and_checks_last(capsys):
    out = io.StringIO()
    line = result.emit(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "k", "count": 1,
                        "memory_peak_bytes": 5},
                       {"logit_gap": {"value": 0.1, "limit": 0.5}},
                       breakdown={"device_ops": [], "idle_gaps": []},
                       out=out)
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert printed == line
    assert list(printed)[:5] == ["correct", "attempted", "failed",
                                 "metrics", "device"]
    assert list(printed)[-1] == "checks"
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == "check logit_gap: 0.1 limit 0.5"


def _run():
    return Run(workload="sc2-7b.decode", cell={}, config={}, seed=1,
               seconds=1.0, trace=False, kind="cpu", setup_s=2.0,
               w0=0.0, w1=1.0)


def test_finish_decides_correct_from_limits():
    out = io.StringIO()
    line = finish(_run(), {"logit_gap": {"value": 0.2, "limit": 0.5}}, 0,
                  out=out)
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 2.0, "unit": "s"}
    line = finish(_run(), {"logit_gap": {"value": 0.7, "limit": 0.5}}, 0,
                  out=out)
    assert line["correct"] is False
    line = finish(_run(), {"logit_gap": {"value": float("inf"),
                                         "limit": 0.5}}, 0, out=out)
    assert line["correct"] is False and \
        line["checks"]["logit_gap"]["value"] is None


def test_finish_withholds_the_line_when_jax_is_loaded(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    out = io.StringIO()
    with pytest.raises(SystemExit) as e:
        finish(_run(), {"logit_gap": {"value": 0.2, "limit": 0.5}}, 0,
               out=out)
    assert e.value.code == 3 and out.getvalue() == ""
