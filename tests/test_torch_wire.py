"""The port's wire formats against the reference's on the CPU.

- ``binTensor``: for float32, float16, bfloat16, int8, int32, int64, uint8
  and bool, the port's JSON equals the reference's for the same values
  (numpy arrays, torch tensors, a bfloat16 torch tensor against an
  ``ml_dtypes`` array), each package decodes the other's to the same
  values, and a bfloat16 payload decodes to a ``torch.bfloat16`` tensor.
- ``ndarray``, ``tensor`` and ``Feedback`` JSON equal the reference's; a
  ``deviceRef`` payload is refused naming slice 4e.
- The Prometheus text of ``utils.metrics`` equals the reference's line for
  line for the same observations (the series cap included).
- The OpenAPI documents equal the reference's apart from the version.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import Metric as JMetric
from seldon_core_tpu.messages import MetricType as JType
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.serving import openapi as jopenapi
from seldon_core_tpu.utils.metrics import EngineMetrics as JEngineMetrics
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import __version__
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import Metric as TMetric
from seldon_core_tpu_torch.messages import MetricType as TType
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.serving import openapi as topenapi
from seldon_core_tpu_torch.utils.metrics import EngineMetrics as TEngineMetrics
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "int64", "uint8",
          "bool"]


def _values(dtype: str, shape=(2, 3, 4), seed=0) -> np.ndarray:
    """Seeded values of ``dtype`` (bfloat16 as an ml_dtypes array)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 40
    if dtype == "bool":
        return x > 0
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return np.clip(np.round(x), info.min, info.max).astype(dtype)
    return x.astype(dtype)


def _as_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return np.asarray(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_tensor_json_equals_the_reference(dtype):
    x = _values(dtype)
    want = JMessage(data=x, names=["n"], encoding="binTensor").to_dict()
    src = x if dtype != "bfloat16" else _as_torch(x)
    assert TMessage(data=src, names=["n"],
                    encoding="binTensor").to_dict() == want
    assert TMessage(data=_as_torch(x), names=["n"],
                    encoding="binTensor").to_dict() == want
    assert want["data"]["binTensor"]["dtype"] == dtype
    # each package decodes the other's JSON to the same values
    got = TMessage.from_dict(want)
    assert got.encoding == "binTensor" and got.names == ["n"]
    if dtype == "bfloat16":
        assert isinstance(got.data, torch.Tensor)
        assert got.data.dtype == torch.bfloat16
    else:
        assert isinstance(got.data, np.ndarray) and got.data.flags.writeable
    np.testing.assert_array_equal(_np(got.data), x)
    back = JMessage.from_dict(TMessage(data=got.data,
                                       encoding="binTensor").to_dict())
    np.testing.assert_array_equal(np.asarray(back.data), x)


@pytest.mark.parametrize("encoding", ["ndarray", "tensor"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_ndarray_and_tensor_json_equal_the_reference(encoding, dtype):
    x = _values(dtype, (3, 2), seed=1)
    want = JMessage(data=x, encoding=encoding).to_dict()
    assert TMessage(data=_as_torch(x), encoding=encoding).to_dict() == want
    assert TMessage.from_dict(want).to_dict() == \
        JMessage.from_dict(want).to_dict()


def test_feedback_json_and_device_refs():
    parts = dict(request={"data": {"ndarray": [[1.0, 2.0]]}},
                 response={"meta": {"routing": {"r": 1}}}, reward=0.5)
    assert TFeedback.from_dict(parts).to_dict() == \
        JFeedback.from_dict(parts).to_dict()
    assert TFeedback.from_json(JFeedback.from_dict(parts).to_json()
                               ).to_json() == \
        JFeedback.from_dict(parts).to_json()
    ref = {"data": {"deviceRef": {"ref": "r1", "shape": [1], "dtype":
                                  "float32", "nbytes": 4}}}
    with pytest.raises(ValueError, match="DeviceTensorRef") as ei:
        TMessage.from_dict(ref)
    with pytest.raises(ValueError) as ej:
        JMessage.from_dict(ref)
    assert str(ei.value) == str(ej.value)


def _observe(metrics, reg, types):
    metrics.observe_node("main", "m", 0.003)
    metrics.observe_node("main", "m", 0.2, status="error")
    metrics.observe_node("main", "m2", 12.0)
    metrics.observe_request("main", 0.0004)
    metrics.observe_request("main", 0.04, 503)
    metrics.merge_custom("m", [
        types[0]("hits", types[1].COUNTER, 2.0, {"a": "x"}),
        types[0]("hits", types[1].COUNTER, 1.0, {"a": "x"}),
        types[0]("load", types[1].GAUGE, 0.75),
        types[0]("lat", types[1].TIMER, 12.5, {"q": 'he said "hi"\n'})])
    metrics.observe_feedback("main", 0.25)
    metrics.observe_feedback("main", 1.0)
    for i in range(5):  # past the cap of 3 series: two are dropped
        reg.counter_inc("capped_total", {"i": str(i)})
    reg.gauge_set("g", 1.5)
    with reg.timer("t_seconds", {"k": "v"}):
        pass


def test_metrics_render_equals_the_reference_line_for_line():
    jreg, treg = JRegistry(max_series=3), TRegistry(max_series=3)
    jm = JEngineMetrics(jreg, deployment="dep")
    tm = TEngineMetrics(treg, deployment="dep")
    _observe(jm, jreg, (JMetric, JType))
    _observe(tm, treg, (TMetric, TType))

    def stable(text):  # the timer's seconds differ between the two runs
        return [ln for ln in text.splitlines() if "t_seconds" not in ln]

    assert stable(tm.render()) == stable(jm.render())
    assert 'seldon_metrics_dropped_series_total{metric="capped_total"} 2.0' \
        in tm.render()
    assert len([ln for ln in tm.render().splitlines()
                if "t_seconds" in ln]) == 18


@pytest.mark.parametrize("which", ["engine", "component", "component-stream",
                                   "gateway"])
def test_openapi_documents_equal_the_reference(which):
    name, _, stream = which.partition("-")
    kw = {"stream": True} if stream else {}
    got = getattr(topenapi, f"{name}_spec")(**kw)
    want = getattr(jopenapi, f"{name}_spec")(**kw)
    assert got["info"].pop("version") == __version__
    want["info"].pop("version")
    assert got == want
