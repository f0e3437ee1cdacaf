"""The port's protobuf codec against the reference's on the CPU.

- ``seldon_core_tpu_torch/proto/prediction_pb2.py`` is the reference's
  generated module byte for byte, so both import into one process (in
  either order) and share one ``SeldonMessage`` class.
- Every payload kind (ndarray, legacy tensor, binTensor of every numpy
  dtype and bfloat16, strData, binData, jsonData), meta, status,
  ``Feedback`` and ``SeldonMessageList`` serialize to the reference's
  bytes (``deterministic=True`` on both sides: exact), and the port decodes
  the reference's bytes to the values the reference decodes them to
  (exact: the same dtype and the same bits).
- A ``DeviceTensorRef`` payload minted by another process is refused
  with the reference's error (``ForeignProcessRef``, whose message names
  ``DeviceTensorRef``: the marker a sender downgrades on).
"""

import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import Meta as JMeta
from seldon_core_tpu.messages import Metric as JMetric
from seldon_core_tpu.messages import MetricType as JMetricType
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.messages import Status as JStatus
from seldon_core_tpu.proto import convert as jconvert
from seldon_core_tpu.proto import prediction_pb2 as jpb
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import Meta as TMeta
from seldon_core_tpu_torch.messages import Metric as TMetric
from seldon_core_tpu_torch.messages import MetricType as TMetricType
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.messages import Status as TStatus
from seldon_core_tpu_torch.proto import convert as tconvert
from seldon_core_tpu_torch.proto import prediction_pb2 as tpb

ROOT = Path(__file__).resolve().parents[1]


def _jbytes(msg) -> bytes:
    return jconvert.message_to_proto(msg).SerializeToString(
        deterministic=True)


def _tbytes(msg) -> bytes:
    return tconvert.message_to_proto(msg).SerializeToString(
        deterministic=True)


def _decode_both(wire: bytes):
    return (jconvert.message_from_proto(jpb.SeldonMessage.FromString(wire)),
            tconvert.message_from_proto(tpb.SeldonMessage.FromString(wire)))


def test_generated_module_is_the_references_byte_for_byte():
    ref = ROOT / "seldon_core_tpu" / "proto" / "prediction_pb2.py"
    port = ROOT / "seldon_core_tpu_torch" / "proto" / "prediction_pb2.py"
    assert port.read_bytes() == ref.read_bytes()
    assert tpb.SeldonMessage is jpb.SeldonMessage
    assert tpb.DESCRIPTOR.package == "seldon.tpu"


@pytest.mark.parametrize("first", ["seldon_core_tpu_torch", "seldon_core_tpu"])
def test_both_modules_import_in_either_order(first):
    second = ({"seldon_core_tpu_torch", "seldon_core_tpu"} - {first}).pop()
    code = (f"import {first}.proto.prediction_pb2 as a\n"
            f"import {second}.proto.prediction_pb2 as b\n"
            "assert a.SeldonMessage is b.SeldonMessage\n"
            "assert a.DESCRIPTOR is b.DESCRIPTOR\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("encoding", ["ndarray", "tensor", "binTensor"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8",
                                   "uint8", "int32", "int64", "bool"])
def test_tensor_payloads_serialize_to_the_references_bytes(encoding, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 4)) * 50).astype(dtype)
    jm = JMessage(data=arr, names=["a", "b", "c", "d"], encoding=encoding)
    tm = TMessage(data=arr, names=["a", "b", "c", "d"], encoding=encoding)
    wire = _jbytes(jm)
    assert _tbytes(tm) == wire
    # a torch tensor (the CPU's here) gives the same bytes
    assert _tbytes(TMessage(data=torch.from_numpy(arr),
                            names=["a", "b", "c", "d"],
                            encoding=encoding)) == wire
    j, t = _decode_both(wire)
    assert t.encoding == j.encoding == encoding
    assert t.names == j.names
    jd, td = j.host_data(), t.host_data()
    assert td.dtype == jd.dtype and td.shape == jd.shape
    np.testing.assert_array_equal(td, jd)
    if encoding == "binTensor":
        assert t.data.flags.writeable  # as a REST one is


def test_bfloat16_bin_tensor_without_ml_dtypes():
    arr = np.linspace(-2, 2, 8, dtype=np.float32).reshape(2, 4)
    wire = _jbytes(JMessage(data=arr.astype(ml_dtypes.bfloat16),
                            encoding="binTensor"))
    t = torch.from_numpy(arr).bfloat16()
    assert _tbytes(TMessage(data=t, encoding="binTensor")) == wire
    _, out = _decode_both(wire)
    assert out.data.dtype == torch.bfloat16
    assert torch.equal(out.data, t)


def test_non_tensor_payloads():
    jd = {"a": [1, 2, {"b": "c"}], "d": None, "e": True, "f": 2.5}
    for kw in ({"str_data": "hello"}, {"bin_data": b"\x01\x02\xff"},
               {"json_data": jd}):
        wire = _jbytes(JMessage(**kw))
        assert _tbytes(TMessage(**kw)) == wire
        j, t = _decode_both(wire)
        assert (t.str_data, t.bin_data, t.json_data) == \
            (j.str_data, j.bin_data, j.json_data)
    assert _decode_both(_jbytes(JMessage(json_data=jd)))[1].json_data == {
        "a": [1.0, 2.0, {"b": "c"}], "d": None, "e": True, "f": 2.5}


def test_meta_and_status():
    def meta(M, Mt, MT):
        return M(puid="p123", tags={"k": "v", "n": 3.0, "f": [1.5, "x"],
                                    "b": False},
                 routing={"r": 1, "s": -1}, request_path={"m": "impl"},
                 metrics=[Mt("lat", MT.TIMER, 1.25, {"t": "u"}),
                          Mt("c", MT.COUNTER, 2.0)])

    jm = JMessage(data=np.zeros((1,)), meta=meta(JMeta, JMetric, JMetricType),
                  status=JStatus.failure(500, "boom", "ERR"))
    tm = TMessage(data=np.zeros((1,)), meta=meta(TMeta, TMetric, TMetricType),
                  status=TStatus.failure(500, "boom", "ERR"))
    wire = _jbytes(jm)
    assert _tbytes(tm) == wire
    j, t = _decode_both(wire)
    assert t.meta.to_dict() == j.meta.to_dict()
    assert t.status.to_dict() == j.status.to_dict()
    ok = _jbytes(JMessage(status=JStatus()))
    assert _tbytes(TMessage(status=TStatus())) == ok
    assert _decode_both(ok)[1].status.status == "SUCCESS"


def test_feedback_and_message_list():
    def fb(F, M, Me):
        return F(request=M(data=np.array([[1.0, 2.0]]), names=["x", "y"]),
                 response=M(data=np.array([[2.0]]), meta=Me(routing={"r": 0})),
                 reward=0.75, truth=M(data=np.array([[1.0]]),
                                      encoding="tensor"))

    jw = jconvert.feedback_to_proto(fb(JFeedback, JMessage, JMeta)) \
        .SerializeToString(deterministic=True)
    tw = tconvert.feedback_to_proto(fb(TFeedback, TMessage, TMeta)) \
        .SerializeToString(deterministic=True)
    assert tw == jw
    j = jconvert.feedback_from_proto(jpb.Feedback.FromString(jw))
    t = tconvert.feedback_from_proto(tpb.Feedback.FromString(jw))
    assert t.reward == j.reward == 0.75
    assert t.response.meta.routing == j.response.meta.routing == {"r": 0}
    for part in ("request", "response", "truth"):
        np.testing.assert_array_equal(getattr(t, part).host_data(),
                                      getattr(j, part).host_data())
    only_reward = jpb.Feedback(reward=1.0).SerializeToString()
    t = tconvert.feedback_from_proto(tpb.Feedback.FromString(only_reward))
    assert (t.request, t.response, t.truth, t.reward) == (None, None, None,
                                                          1.0)
    jl, tl = jpb.SeldonMessageList(), tpb.SeldonMessageList()
    for x in (np.zeros((1, 2)), np.ones((1, 2))):
        jconvert.message_to_proto(JMessage(data=x), jl.seldonMessages.add())
        tconvert.message_to_proto(TMessage(data=x), tl.seldonMessages.add())
    assert tl.SerializeToString(deterministic=True) == \
        jl.SerializeToString(deterministic=True)


def test_device_tensor_refs_are_refused_naming_their_slice():
    p = tpb.SeldonMessage()
    p.data.device.buffer_uuid = "tok/uuid"
    with pytest.raises(ValueError, match="DeviceTensorRef") as ei:
        tconvert.message_from_proto(p)
    with pytest.raises(ValueError) as ej:
        jconvert.message_from_proto(jpb.SeldonMessage.FromString(
            p.SerializeToString()))
    assert str(ei.value) == str(ej.value)
