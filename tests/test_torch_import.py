"""The port imports neither jax nor anything of the JAX package.

This runs in a subprocess: the test process itself has jax imported (the
conftest pins its platform), so only a fresh interpreter with
``sys.modules["jax"] = None`` can show that every port module imports
without it.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import seldon_core_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# careful: seldon_core_tpu_torch shares the prefix seldon_core_tpu
ref = sorted(m for m in sys.modules
             if m == "seldon_core_tpu" or m.startswith("seldon_core_tpu."))
jaxish = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "jaxlib")))
                and sys.modules[m] is not None)
print(json.dumps({"modules": names, "ref": ref, "jax": jaxish}))
"""


def test_port_imports_without_jax_or_the_jax_package():
    import json

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ref"] == [], res["ref"]
    assert res["jax"] == [], res["jax"]
    expected = {
        "seldon_core_tpu_torch.device", "seldon_core_tpu_torch.convert",
        "seldon_core_tpu_torch.messages", "seldon_core_tpu_torch.ops._build",
        "seldon_core_tpu_torch.ops.quant", "seldon_core_tpu_torch.ops.attention",
        "seldon_core_tpu_torch.parallel.ring_attention",
        "seldon_core_tpu_torch.models.transformer",
        "seldon_core_tpu_torch.models.llm_demo",
        "seldon_core_tpu_torch.runtime.paged",
        "seldon_core_tpu_torch.runtime.llm",
        "seldon_core_tpu_torch.runtime.component",
        "seldon_core_tpu_torch.graph.spec",
        "seldon_core_tpu_torch.serving.rest",
        "seldon_core_tpu_torch.operator.local",
    }
    assert expected <= set(res["modules"])


def test_entry_points_refuse_cuda_without_a_card():
    """Entry points default to the card; with none visible they raise
    instead of serving from the CPU, unless the CPU is asked for."""
    import pytest
    import torch

    from seldon_core_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
