"""The port's GL16xx trace-lint (``seldon_core_tpu_torch/analysis/``
``tracelint.py``): the signature registry traced on fake tensors
(``FakeTensorMode``) against the reference's jaxpr trace.

- The registry trace of the five providers (iris, MLP, MLP classifier,
  ResNet50, int8 ResNet50) gives EQUAL findings (none), EQUAL output
  (shape, dtype) at the probe binding, and the same parameter tree
  (ResNet50's conv kernels are OIHW in the port, HWIO in the reference's
  flax tree, and its leaves are named by module path, not flax's scope).
- Planted defects in the port's idiom raise their code.  Where a defect
  means the same in both frameworks (declared output drift, GL1604,
  GL1207) the findings are EQUAL; the allowed differences are:

  * the quoted trace-error text of GL1601's "does not trace" (torch's
    exception is not jax's); the message up to it is EQUAL;
  * GL1602's weak-type half has no counterpart (torch has no weak
    types): the port's GL1602 is float64 op outputs only, and the
    reference's registry raises no GL1602 at all, so the registry
    findings stay EQUAL (size of the difference there: 0 findings);
  * GL1603 names host syncs (``aten._local_scalar_dense``,
    ``Tensor.cpu``...) where the reference names jaxpr callback
    primitives.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.analysis import tracelint as jtracelint
from seldon_core_tpu.models import SIGNATURES as JSIGNATURES
from seldon_core_tpu.models import TRACE_PROVIDERS as JPROVIDERS
from seldon_core_tpu.models import TraceTarget as JTraceTarget
from seldon_core_tpu.placement.config import PlacementConfig as JPlacement
from seldon_core_tpu_torch.analysis import graphlint, tracelint
from seldon_core_tpu_torch.analysis.findings import (
    PLACEMENT_TP_INDIVISIBLE,
    TRACE_CALLBACK_IN_PURE_FN,
    TRACE_IMPLICIT_PROMOTION,
    TRACE_MESH_INDIVISIBLE,
    TRACE_SIGNATURE_DRIFT,
)
from seldon_core_tpu_torch.models import (
    SIGNATURES,
    TRACE_PROVIDERS,
    ModelSignature,
    TraceTarget,
    trace_target_for,
)
from seldon_core_tpu_torch.placement.config import PlacementConfig

REF, PORT = "seldon_core_tpu.models", "seldon_core_tpu_torch.models"
ZOO = ["iris:IrisClassifier", "mlp:MNISTMLP", "mlp:MNISTMLPClassifier",
       "resnet:ResNet50Model", "resnet_int8:Int8ResNet50Model"]


def _port_text(s):
    return s.replace(REF + ".", PORT + ".")


def _rows(findings, ref=False):
    fix = _port_text if ref else (lambda s: s)
    return [(f.code, f.severity, f.path, fix(f.message)) for f in findings]


def _ref_trace(cls):
    mc = f"{REF}.{cls}"
    return jtracelint._trace_model(mc, JSIGNATURES[mc])


def _port_trace(cls):
    mc = f"{PORT}.{cls}"
    return tracelint._trace_model(mc, SIGNATURES[mc])


# ---- the registry ----------------------------------------------------------

def test_registry_findings_equal_the_references():
    port = tracelint.lint_registry([f"{PORT}.{c}" for c in ZOO])
    ref = jtracelint.lint_registry([f"{REF}.{c}" for c in ZOO])
    assert _rows(port) == _rows(ref, ref=True) == []
    assert tracelint.lint_registry() == []  # every entry, no provider too


@pytest.mark.parametrize("cls", ZOO)
def test_traced_outputs_equal_the_references(cls):
    port, ref = _port_trace(cls), _ref_trace(cls)
    assert port.error is None and ref.error is None
    assert port.out_shapes == ref.out_shapes
    assert port.callback_prims == [] and port.f64_eqns == []


@pytest.mark.parametrize("cls", ["iris:IrisClassifier", "mlp:MNISTMLP",
                                 "mlp:MNISTMLPClassifier"])
def test_param_trees_equal_the_references(cls):
    assert _port_trace(cls).param_dims == _ref_trace(cls).param_dims


def test_int8_param_tree_is_the_references_with_oihw_kernels():
    port = _port_trace("resnet_int8:Int8ResNet50Model").param_dims
    ref = _ref_trace("resnet_int8:Int8ResNet50Model").param_dims
    assert set(port) == set(ref)
    for key, shape in port.items():
        if key.endswith("/kernel"):
            o, i, kh, kw = shape
            shape = (kh, kw, i, o)
        assert shape == ref[key], key


def test_resnet_param_tree_holds_the_references_leaves():
    port = _port_trace("resnet:ResNet50Model").param_dims
    ref = _ref_trace("resnet:ResNet50Model").param_dims
    assert len(port) == len(ref) == 267
    assert sum(int(np.prod(s)) for s in port.values()) == sum(
        int(np.prod(s)) for s in ref.values())


@pytest.mark.parametrize("cls", ZOO)
def test_providers_build_fake_parameters(cls):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with FakeTensorMode():
        target = trace_target_for(f"{PORT}.{cls}")
        leaves = [t for _, t in tracelint._tensors(target.params)]
    assert leaves and all(isinstance(t, FakeTensor) for t in leaves)


@pytest.mark.parametrize("mc", sorted(SIGNATURES))
def test_each_shipped_signature_lints_clean(mc):
    assert tracelint.lint_signature(mc) == []


# ---- planted defects ------------------------------------------------------

def _register(monkeypatch, mc, sig, fn, params=None):
    monkeypatch.setitem(SIGNATURES, mc, sig)
    monkeypatch.setitem(TRACE_PROVIDERS, mc, lambda: TraceTarget(
        fn, params() if callable(params) else (params or {})))


def _jregister(monkeypatch, mc, sig, fn, params):
    monkeypatch.setitem(JSIGNATURES, mc, sig)
    monkeypatch.setitem(JPROVIDERS, mc, lambda: JTraceTarget(fn, params))


def _jsig(sig):
    from seldon_core_tpu.models import ModelSignature as JSig

    return JSig(**sig.__dict__)


def _dense(out_features=3):
    return (lambda p, x: x @ p["w"],
            lambda: {"w": torch.empty((4, out_features))})


def _jdense(out_features=3):
    return (lambda p, x: jnp.dot(x, p["w"]),
            {"w": jax.ShapeDtypeStruct((4, out_features), jnp.float32)})


@pytest.mark.parametrize("out_features,declared,dtype,fires", [
    (3, (None, 4), "float32", True),
    (3, (None, 3), "float32", False),
    (3, (None, 3), "int32", True),
], ids=["shape-drift", "fixed", "dtype-drift"])
def test_gl1601_declared_output_equals_the_references(
        monkeypatch, out_features, declared, dtype, fires):
    mc = f"tests.synthetic:Drift_{declared[1]}_{dtype}"
    sig = ModelSignature(input_shape=(None, 4), input_dtype="float32",
                         output_shape=declared, output_dtype=dtype)
    _register(monkeypatch, mc, sig, *_dense(out_features))
    _jregister(monkeypatch, mc, _jsig(sig), *_jdense(out_features))
    port = tracelint.lint_signature(mc)
    assert [f.code for f in port] == ([TRACE_SIGNATURE_DRIFT] if fires
                                      else [])
    assert _rows(port) == _rows(jtracelint.lint_signature(mc), ref=True)


def test_gl1601_untraceable_input_quotes_its_own_error(monkeypatch):
    mc = "tests.synthetic:BadInput"
    sig = ModelSignature(input_shape=(None, 5), input_dtype="float32",
                         output_shape=(None, 3), output_dtype="float32")
    _register(monkeypatch, mc, sig, *_dense())
    _jregister(monkeypatch, mc, _jsig(sig), *_jdense())
    (f,) = tracelint.lint_signature(mc)
    (jf,) = jtracelint.lint_signature(mc)
    assert f.code == jf.code == TRACE_SIGNATURE_DRIFT
    head = "tests.synthetic:BadInput: declared input float32[?, 5] does not " \
           "trace: "
    assert f.message.startswith(head) and jf.message.startswith(head)
    assert "RuntimeError" in f.message  # torch's text, not jax's


def test_provider_that_raises_is_a_finding_not_a_crash(monkeypatch):
    mc = "tests.synthetic:Boom"
    sig = ModelSignature(input_shape=(None, 4), input_dtype="float32")

    def boom(p, x):
        raise ValueError("boom")

    _register(monkeypatch, mc, sig, boom)
    (f,) = tracelint.lint_signature(mc)
    assert f.code == TRACE_SIGNATURE_DRIFT and "ValueError: boom" in f.message


def test_no_provider_is_not_a_defect(monkeypatch):
    mc = "tests.synthetic:NoProvider"
    monkeypatch.setitem(SIGNATURES, mc, ModelSignature(
        input_shape=(None, 4), input_dtype="float32"))
    assert tracelint.lint_signature(mc) == []


@pytest.mark.parametrize("fn,fires", [
    (lambda p, x: (x.double() * 2).float(), True),
    (lambda p, x: x * torch.tensor(2.0, dtype=torch.float64), True),
    (lambda p, x: x * 2.0, False),
], ids=["double-cast", "float64-constant", "python-scalar"])
def test_gl1602_float64_op_outputs(monkeypatch, fn, fires):
    mc = f"tests.synthetic:F64_{fires}_{id(fn)}"
    _register(monkeypatch, mc, ModelSignature(
        input_shape=(None, 4), input_dtype="float32"), fn)
    got = tracelint.lint_signature(mc)
    assert [f.code for f in got] == ([TRACE_IMPLICIT_PROMOTION] if fires
                                     else [])


def test_gl1602_skips_a_kernels_plain_version(monkeypatch):
    """K1's plain version accumulates in float64 on the CPU path; the card
    runs the kernel (int32), so the trace sees one call, not its ops."""
    from seldon_core_tpu_torch.ops.quant import int8_matmul, quantize_int8

    mc = "tests.synthetic:Int8Head"
    _register(monkeypatch, mc, ModelSignature(
        input_shape=(None, 16), input_dtype="float32", pure_fn=True),
        lambda p, x: int8_matmul(x, p["q"]),
        lambda: {"q": quantize_int8(torch.empty((16, 8)))})
    assert tracelint.lint_signature(mc) == []


def _item(p, x):
    return x * x.sum().item()


def _tolist(p, x):
    return x * len(x.tolist())


def _float(p, x):
    return x * float(x.max())


def _cpu(p, x):
    return x.cpu() + 1


def _to_cpu(p, x):
    return x.to("cpu") + 1


def _numpy(p, x):
    return x + float(x.numpy().sum())


def _print(p, x):
    print(x)
    return x + 1


def _format(p, x):
    return x + len(f"{x}")


SYNCS = {"item": (_item, "aten._local_scalar_dense"),
         "tolist": (_tolist, "aten._local_scalar_dense"),
         "float": (_float, "aten._local_scalar_dense"),
         "cpu": (_cpu, "Tensor.cpu"),
         "to-cpu": (_to_cpu, "Tensor.to"),
         "numpy": (_numpy, "Tensor.numpy"),
         "print": (_print, "Tensor.__"),
         "format": (_format, "Tensor.__format__")}


@pytest.mark.parametrize("case", sorted(SYNCS))
def test_gl1603_host_sync_in_pure_fn(monkeypatch, case):
    """Every host sync is GL1603, never the GL1601 "does not trace" that
    FakeTensor's own exception would give."""
    fn, name = SYNCS[case]
    mc = f"tests.synthetic:Sync_{case}"
    _register(monkeypatch, mc, ModelSignature(
        input_shape=(None, 4), input_dtype="float32",
        output_shape=(None, 4), output_dtype="float32", pure_fn=True), fn)
    (f,) = tracelint.lint_signature(mc)
    assert f.code == TRACE_CALLBACK_IN_PURE_FN
    assert f"'{name}" in f.message


@pytest.mark.parametrize("case", ["item", "cpu"])
def test_gl1603_host_sync_without_pure_fn_is_quiet(monkeypatch, case):
    mc = f"tests.synthetic:SyncImpure_{case}"
    _register(monkeypatch, mc, ModelSignature(
        input_shape=(None, 4), input_dtype="float32", pure_fn=False),
        SYNCS[case][0])
    assert tracelint.lint_signature(mc) == []


@pytest.mark.parametrize("batch,dp,fires", [(6, 4, True), (8, 4, False)],
                         ids=["indivisible", "divisible"])
def test_gl1604_dp_equals_the_references(batch, dp, fires):
    sig = ModelSignature(input_shape=(batch, 4), input_dtype="float32",
                         batch_shardable=True)
    mc = "tests.synthetic:FixedBatch"
    port = tracelint._mesh_findings(mc, sig, PlacementConfig(
        enabled=True, dp=dp), "m")
    ref = jtracelint._mesh_findings(mc, _jsig(sig), JPlacement(
        enabled=True, dp=dp), "m")
    assert [f.code for f in port] == ([TRACE_MESH_INDIVISIBLE] if fires
                                      else [])
    assert _rows(port) == _rows(ref, ref=True)


@pytest.mark.parametrize("tp,fires", [(3, True), (2, False)],
                         ids=["indivisible", "divisible"])
def test_gl1604_tp_equals_the_references(tp, fires):
    mc = "mlp:MNISTMLP"
    port = tracelint._mesh_findings(
        f"{PORT}.{mc}", SIGNATURES[f"{PORT}.{mc}"],
        PlacementConfig(enabled=True, tp=tp), "m")
    ref = jtracelint._mesh_findings(
        f"{REF}.{mc}", JSIGNATURES[f"{REF}.{mc}"],
        JPlacement(enabled=True, tp=tp), "m")
    assert bool(port) == fires
    assert {f.code for f in port} <= {TRACE_MESH_INDIVISIBLE}
    assert _rows(port) == _rows(ref, ref=True)


def test_gl1207_effective_layout_equals_the_references(monkeypatch):
    """A ``wq`` leaf the rule table shards on dim 1 (= 6) over tp=4."""
    mc = "tests.synthetic:Attn"
    sig = ModelSignature(input_shape=(None, 4), input_dtype="float32")
    _register(monkeypatch, mc, sig, lambda p, x: x,
              lambda: {"attn": {"wq": torch.empty((4, 6, 8))}})
    _jregister(monkeypatch, mc, _jsig(sig), lambda p, x: x, {
        "attn": {"wq": jax.ShapeDtypeStruct((4, 6, 8), jnp.float32)}})
    port = tracelint._mesh_findings(mc, sig, PlacementConfig(
        enabled=True, tp=4), "m")
    ref = jtracelint._mesh_findings(mc, _jsig(sig), JPlacement(
        enabled=True, tp=4), "m")
    assert [f.code for f in port] == [PLACEMENT_TP_INDIVISIBLE]
    assert _rows(port) == _rows(ref, ref=True)


# ---- the gate ---------------------------------------------------------------

def test_pass_runs_only_when_torch_and_the_providers_are_loaded(monkeypatch):
    from seldon_core_tpu_torch.graph.spec import PredictiveUnit

    mc = "tests.synthetic:GateDrift"
    _register(monkeypatch, mc, ModelSignature(
        input_shape=(None, 4), input_dtype="float32",
        output_shape=(None, 9), output_dtype="float32"), *_dense())
    unit = PredictiveUnit.from_dict({"name": "m", "type": "MODEL",
                                     "parameters": [{"name": "model_class",
                                                     "value": mc}]})
    (f,) = graphlint._tracelint_pass(unit, {}, "")
    assert f.code == TRACE_SIGNATURE_DRIFT and f.path == "m"
    monkeypatch.delitem(sys.modules, "seldon_core_tpu_torch.models.traceable")
    assert graphlint._tracelint_pass(unit, {}, "") == []
    monkeypatch.delitem(sys.modules, "torch")
    assert graphlint._tracelint_pass(unit, {}, "") == []


def test_dtype_names_are_the_references():
    assert tracelint.dtype_name(torch.bfloat16) == "bfloat16"
    assert tracelint.dtype_name(torch.float32) == str(jnp.float32.dtype)
