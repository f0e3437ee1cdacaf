"""The port's ``SeldonMessage`` and ``Feedback`` to and from the wire
protobuf (port of ``seldon_core_tpu/proto/convert.py``).

The bytes are the reference's for the same message:

- ``ndarray`` goes as a ``google.protobuf.ListValue`` of nested lists,
- ``tensor`` as the reference's double-only ``LegacyTensor``,
- ``binTensor`` as raw little-endian bytes with the numpy dtype name.

A tensor on the card is copied to the host once, where it is encoded.
bfloat16 (and float8) travel without ``ml_dtypes``: their bytes go out
through an integer view (``messages.wire_array``) and come back as a torch
tensor (``messages.array_from_buffer``).

A ``DeviceTensorRef`` payload (``data.device``, the device plane) carries
a ``runtime/device_registry.py`` ref in ``buffer_uuid``:
``message_to_proto(device_refs=True)`` registers a torch tensor in this
process (a loopback hop; another process refuses the ref),
``device_refs="shm"`` stages any tensor into same-host shared memory, and
the default sends bytes.  ``message_from_proto`` resolves the ref, or
raises (``ForeignProcessRef``, ``KeyError``) with the ``DeviceTensorRef``
marker the sender downgrades on.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
from google.protobuf import struct_pb2

from seldon_core_tpu_torch.messages import (
    Feedback,
    Meta,
    Metric,
    MetricType,
    SeldonMessage,
    Status,
    array_from_buffer,
    dtype_name,
    wire_array,
)
from seldon_core_tpu_torch.proto import prediction_pb2 as pb

__all__ = ["message_to_proto", "message_from_proto", "feedback_to_proto",
           "feedback_from_proto"]

_METRIC_TYPE_TO_PB = {
    MetricType.COUNTER: pb.Metric.COUNTER,
    MetricType.GAUGE: pb.Metric.GAUGE,
    MetricType.TIMER: pb.Metric.TIMER,
}
_METRIC_TYPE_FROM_PB = {v: k for k, v in _METRIC_TYPE_TO_PB.items()}


# ---------------------------------------------------------------------------
# meta and status
# ---------------------------------------------------------------------------

def _meta_to_proto(meta: Meta, out: pb.Meta) -> None:
    out.puid = meta.puid
    for k, v in meta.tags.items():
        out.tags[k].CopyFrom(_value_to_pb(v))
    for k, v in meta.routing.items():
        out.routing[k] = int(v)
    for k, v in meta.request_path.items():
        out.requestPath[k] = str(v)
    for m in meta.metrics:
        pm = out.metrics.add()
        pm.key = m.key
        pm.type = _METRIC_TYPE_TO_PB[m.type]
        pm.value = float(m.value)
        for tk, tv in m.tags.items():
            pm.tags[tk] = str(tv)


def _meta_from_proto(p: pb.Meta) -> Meta:
    return Meta(
        puid=p.puid,
        tags={k: _value_from_pb(v) for k, v in p.tags.items()},
        routing={k: int(v) for k, v in p.routing.items()},
        request_path=dict(p.requestPath),
        metrics=[Metric(key=m.key,
                        type=_METRIC_TYPE_FROM_PB.get(m.type,
                                                      MetricType.COUNTER),
                        value=float(m.value), tags=dict(m.tags))
                 for m in p.metrics])


def _status_to_proto(s: Status, out: pb.Status) -> None:
    out.code = s.code
    out.info = s.info
    out.reason = s.reason
    out.status = (pb.Status.FAILURE if s.status == "FAILURE"
                  else pb.Status.SUCCESS)


def _status_from_proto(p: pb.Status) -> Status:
    return Status(code=p.code, info=p.info, reason=p.reason,
                  status="FAILURE" if p.status == pb.Status.FAILURE
                  else "SUCCESS")


# ---------------------------------------------------------------------------
# google.protobuf.Value
# ---------------------------------------------------------------------------

def _value_to_pb(v: Any) -> struct_pb2.Value:
    out = struct_pb2.Value()
    if v is None:
        out.null_value = 0
    elif isinstance(v, bool):
        out.bool_value = v
    elif isinstance(v, (int, float, np.integer, np.floating)):
        out.number_value = float(v)
    elif isinstance(v, str):
        out.string_value = v
    elif isinstance(v, (list, tuple)):
        out.list_value.values.extend(_value_to_pb(x) for x in v)
    elif isinstance(v, dict):
        for k, x in v.items():
            out.struct_value.fields[str(k)].CopyFrom(_value_to_pb(x))
    else:
        out.string_value = str(v)
    return out


def _value_from_pb(v: struct_pb2.Value) -> Any:
    kind = v.WhichOneof("kind")
    if kind == "bool_value":
        return v.bool_value
    if kind == "number_value":
        # Struct numbers are doubles: a value keeps its type between the
        # REST and gRPC paths
        return v.number_value
    if kind == "string_value":
        return v.string_value
    if kind == "list_value":
        return [_value_from_pb(x) for x in v.list_value.values]
    if kind == "struct_value":
        return {k: _value_from_pb(x)
                for k, x in v.struct_value.fields.items()}
    return None


def _fill_listvalue(lv: struct_pb2.ListValue, rows: Sequence) -> None:
    for item in rows:
        v = lv.values.add()
        if isinstance(item, list):
            _fill_listvalue(v.list_value, item)
        elif isinstance(item, bool):
            v.bool_value = item
        elif isinstance(item, (int, float)):
            v.number_value = float(item)
        elif isinstance(item, str):
            v.string_value = item
        else:
            v.null_value = 0


# ---------------------------------------------------------------------------
# SeldonMessage
# ---------------------------------------------------------------------------

def message_to_proto(msg: SeldonMessage,
                     out: Optional[pb.SeldonMessage] = None,
                     device_refs=False) -> pb.SeldonMessage:
    """``device_refs=True``: a torch tensor rides as a loopback registry
    ref (peers in this process only); ``"shm"``: any tensor rides a
    same-host shm segment (one D2H); ``False``: bytes, always safe."""
    p = out if out is not None else pb.SeldonMessage()
    if msg.status is not None:
        _status_to_proto(msg.status, p.status)
    md = msg.meta
    if md.puid or md.tags or md.routing or md.request_path or md.metrics:
        _meta_to_proto(md, p.meta)
    if msg.data is not None and device_refs and (
            msg.is_device_resident or device_refs == "shm"):
        from seldon_core_tpu_torch.runtime.device_registry import registry

        arr = msg.data
        p.data.names.extend(msg.names)
        if device_refs == "shm":
            p.data.device.buffer_uuid = registry.put_shm(arr)
        else:
            p.data.device.buffer_uuid = registry.put(arr)
        p.data.device.dtype = dtype_name(getattr(arr, "dtype", "float32"))
        p.data.device.shape.extend(int(s) for s in msg.shape)
        p.data.device.sharding = ""
        return p
    if msg.data is not None:
        p.data.names.extend(msg.names)
        if msg.encoding in ("binTensor", "device"):
            buf, name = wire_array(msg.data)
            p.data.binTensor.dtype = name
            p.data.binTensor.shape.extend(int(s) for s in buf.shape)
            p.data.binTensor.raw = buf.tobytes()
        elif msg.encoding == "tensor":
            arr = msg.host_data()
            p.data.tensor.shape.extend(int(s) for s in arr.shape)
            p.data.tensor.values.extend(
                arr.astype(np.float64).ravel().tolist())
        else:
            _fill_listvalue(p.data.ndarray, msg.host_data().tolist())
    elif msg.bin_data is not None:
        p.binData = msg.bin_data
    elif msg.str_data is not None:
        p.strData = msg.str_data
    elif msg.json_data is not None:
        p.jsonData.CopyFrom(_value_to_pb(msg.json_data))
    return p


def message_from_proto(p: pb.SeldonMessage) -> SeldonMessage:
    msg = SeldonMessage()
    if p.HasField("status"):
        msg.status = _status_from_proto(p.status)
    if p.HasField("meta"):
        msg.meta = _meta_from_proto(p.meta)
    which = p.WhichOneof("data_oneof")
    if which == "data":
        msg.names = list(p.data.names)
        dwhich = p.data.WhichOneof("data_oneof")
        if dwhich == "tensor":
            t = p.data.tensor
            msg.data = np.asarray(t.values, dtype=np.float64).reshape(
                list(t.shape))
            msg.encoding = "tensor"
        elif dwhich == "ndarray":
            msg.data = np.asarray([_value_from_pb(v)
                                   for v in p.data.ndarray.values])
            msg.encoding = "ndarray"
        elif dwhich == "binTensor":
            t = p.data.binTensor
            # a bytearray: the array is writable, as a REST one is
            msg.data = array_from_buffer(bytearray(t.raw),
                                         t.dtype or "float32", list(t.shape))
            msg.encoding = "binTensor"
        elif dwhich == "device":
            from seldon_core_tpu_torch.runtime.device_registry import (
                registry,
            )

            # a ref minted by another process raises ForeignProcessRef:
            # the raise IS the downgrade signal at this boundary
            msg.data = registry.resolve(  # graphlint: disable=RL703
                p.data.device.buffer_uuid)
            msg.encoding = "device"
    elif which == "binData":
        msg.bin_data = p.binData
    elif which == "strData":
        msg.str_data = p.strData
    elif which == "jsonData":
        msg.json_data = _value_from_pb(p.jsonData)
    return msg


# ---------------------------------------------------------------------------
# Feedback
# ---------------------------------------------------------------------------

def feedback_to_proto(fb: Feedback,
                      out: Optional[pb.Feedback] = None) -> pb.Feedback:
    p = out if out is not None else pb.Feedback()
    if fb.request is not None:
        message_to_proto(fb.request, p.request)
    if fb.response is not None:
        message_to_proto(fb.response, p.response)
    if fb.truth is not None:
        message_to_proto(fb.truth, p.truth)
    p.reward = float(fb.reward)
    return p


def feedback_from_proto(p: pb.Feedback) -> Feedback:
    def part(name):
        return message_from_proto(getattr(p, name)) if p.HasField(name) \
            else None

    return Feedback(request=part("request"), response=part("response"),
                    reward=float(p.reward), truth=part("truth"))
