"""``SeldonMessage`` (port of ``seldon_core_tpu/messages.py``).

The JSON matches the reference's wire format: ``jsonData``,
``data.ndarray`` / ``data.tensor`` / ``data.binTensor``, ``strData``,
``binData``, ``meta`` (``puid``, ``tags``, ``routing``, ``requestPath``,
``metrics``) and ``status``, and the reward ``Feedback``.  ``data`` may
hold a numpy array or a torch tensor; it reaches the host only when the
message is serialized.

``binTensor`` carries a tensor's raw bytes in base64 with its shape and
dtype name (float32, float16, bfloat16, int8, int32, int64, uint8, bool and
the other numpy names).  Numpy has no bfloat16 (nor float8), so those
decode to a torch tensor through ``torch.frombuffer``; their bytes are the
reference's.  A ``deviceRef`` payload (the device plane,
:class:`DeviceTensorRef`) is resolved through
``runtime/device_registry.py``: a ref that cannot resolve here raises,
which the transports carry back to the sender as the error it downgrades
on.  ``shape`` and ``nbytes`` read a tensor's metadata and never copy it
from the card.
"""

from __future__ import annotations

import base64
import enum
import json
import secrets
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["MetricType", "Metric", "Meta", "Status", "SeldonMessage",
           "Feedback", "DeviceTensorRef", "new_puid", "wire_array",
           "array_from_buffer", "dtype_name"]


def new_puid() -> str:
    return secrets.token_hex(16)


class MetricType(str, enum.Enum):
    COUNTER = "COUNTER"
    GAUGE = "GAUGE"
    TIMER = "TIMER"


@dataclass
class Metric:
    key: str
    type: MetricType = MetricType.COUNTER
    value: float = 0.0
    tags: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"key": self.key, "type": self.type.value,
                             "value": self.value}
        if self.tags:
            d["tags"] = dict(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Metric":
        return cls(key=d.get("key", ""),
                   type=MetricType(d.get("type", "COUNTER")),
                   value=float(d.get("value", 0.0)),
                   tags=dict(d.get("tags", {})))


@dataclass
class Meta:
    puid: str = ""
    tags: dict[str, Any] = field(default_factory=dict)
    routing: dict[str, int] = field(default_factory=dict)
    request_path: dict[str, str] = field(default_factory=dict)
    metrics: list[Metric] = field(default_factory=list)

    def merge(self, other: "Meta") -> None:
        """Merge a component response's meta into the request-level meta."""
        if other.puid and not self.puid:
            self.puid = other.puid
        self.tags.update(other.tags)
        self.routing.update(other.routing)
        self.request_path.update(other.request_path)
        self.metrics.extend(other.metrics)

    def copy(self) -> "Meta":
        return Meta(puid=self.puid, tags=dict(self.tags),
                    routing=dict(self.routing),
                    request_path=dict(self.request_path),
                    metrics=[Metric(m.key, m.type, m.value, dict(m.tags))
                             for m in self.metrics])

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.puid:
            d["puid"] = self.puid
        if self.tags:
            d["tags"] = self.tags
        if self.routing:
            d["routing"] = self.routing
        if self.request_path:
            d["requestPath"] = self.request_path
        if self.metrics:
            d["metrics"] = [m.to_dict() for m in self.metrics]
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "Meta":
        d = d or {}
        return cls(puid=d.get("puid", ""), tags=dict(d.get("tags", {})),
                   routing={k: int(v) for k, v in d.get("routing", {}).items()},
                   request_path=dict(d.get("requestPath", {})),
                   metrics=[Metric.from_dict(m) for m in d.get("metrics", [])])


@dataclass
class Status:
    code: int = 200
    info: str = ""
    reason: str = ""
    status: str = "SUCCESS"  # SUCCESS | FAILURE

    @classmethod
    def failure(cls, code: int, info: str, reason: str = "") -> "Status":
        return cls(code=code, info=info, reason=reason, status="FAILURE")

    def to_dict(self) -> dict:
        return {"code": self.code, "info": self.info, "reason": self.reason,
                "status": self.status}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "Status":
        d = d or {}
        return cls(code=int(d.get("code", 200)), info=d.get("info", ""),
                   reason=d.get("reason", ""),
                   status=d.get("status", "SUCCESS"))


# dtypes numpy lacks: they travel as raw bytes and decode to torch tensors
_TORCH_ONLY = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
_TORCH_ONLY_NAMES = {v: k for k, v in _TORCH_ONLY.items()}


def dtype_name(dtype: Any) -> str:
    """The wire name of a numpy or torch dtype (numpy's names)."""
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_ONLY_NAMES:
            return _TORCH_ONLY_NAMES[dtype]
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype).name
    return np.dtype(dtype).name


def wire_array(x) -> tuple[np.ndarray, str]:
    """``x`` (numpy or torch) as a C-contiguous host array holding its
    bytes, and its dtype's wire name.  A bfloat16 or float8 tensor comes
    back as a uint16 or uint8 view of the same bytes."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype in _TORCH_ONLY_NAMES:
            view = torch.int16 if t.element_size() == 2 else torch.uint8
            return t.view(view).numpy(), _TORCH_ONLY_NAMES[t.dtype]
        return t.numpy(), dtype_name(t.dtype)
    arr = np.ascontiguousarray(x)
    return arr, dtype_name(arr.dtype)


def array_from_buffer(buf, name: str, shape) -> Any:
    """The array of dtype ``name`` and ``shape`` over ``buf``'s bytes: a
    numpy array, or a torch tensor for a dtype numpy lacks.  Writable when
    ``buf`` is (a ``bytearray``)."""
    if name in _TORCH_ONLY:
        return torch.frombuffer(buf, dtype=_TORCH_ONLY[name]).reshape(
            tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):  # possibly on the card
        t = x.detach().cpu()
        if t.dtype in _TORCH_ONLY_NAMES:
            # numpy has no bfloat16: its values, exactly, as float32
            t = t.float()
        return t.numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class DeviceTensorRef:
    """A tensor by reference, not by value: ``ref`` is a registry key
    (in-process loopback, zero copies) or an ``shm:`` / ``shmc:`` segment
    (same host, one D2H and one H2D).  ``shape``, ``dtype`` and ``nbytes``
    ride beside it, so a receiver can reason about the payload without
    resolving (and so consuming) a one-shot ref."""

    ref: str
    shape: tuple = ()
    dtype: str = ""
    nbytes: int = 0

    def to_dict(self) -> dict:
        return {"ref": self.ref, "shape": list(self.shape),
                "dtype": self.dtype, "nbytes": self.nbytes}

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceTensorRef":
        return cls(ref=str(d.get("ref", "")),
                   shape=tuple(int(s) for s in d.get("shape", ())),
                   dtype=str(d.get("dtype", "")),
                   nbytes=int(d.get("nbytes", 0)))


@dataclass
class SeldonMessage:
    data: Any = None
    names: list[str] = field(default_factory=list)
    bin_data: Optional[bytes] = None
    str_data: Optional[str] = None
    json_data: Any = None
    meta: Meta = field(default_factory=Meta)
    status: Optional[Status] = None
    encoding: str = "ndarray"  # "ndarray" | "tensor" | "binTensor"

    @classmethod
    def from_ndarray(cls, arr, names=(), **kw) -> "SeldonMessage":
        return cls(data=arr, names=list(names), **kw)

    @property
    def is_device_resident(self) -> bool:
        """``data`` is a torch tensor (the counterpart of a ``jax.Array``),
        on the card or on the CPU device."""
        return isinstance(self.data, torch.Tensor)

    @property
    def shape(self) -> Optional[tuple]:
        """The tensor's shape, from its metadata: never a copy to the
        host."""
        if self.data is None:
            return None
        shape = getattr(self.data, "shape", None)
        if shape is not None:
            return tuple(shape)
        return np.asarray(self.data).shape  # a host list or scalar

    @property
    def nbytes(self) -> Optional[int]:
        """Payload bytes, from the tensor's metadata (and the byte
        payloads' lengths): never a copy to the host."""
        if self.data is not None:
            if isinstance(self.data, torch.Tensor):
                return self.data.numel() * self.data.element_size()
            nbytes = getattr(self.data, "nbytes", None)
            if nbytes is not None:
                return int(nbytes)
            return int(np.asarray(self.data).nbytes)
        if self.bin_data is not None:
            return len(self.bin_data)
        if self.str_data is not None:
            return len(self.str_data.encode("utf-8", errors="replace"))
        return None

    def host_data(self) -> Optional[np.ndarray]:
        return None if self.data is None else _to_numpy(self.data)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        md = self.meta.to_dict()
        if md:
            out["meta"] = md
        if self.status is not None:
            out["status"] = self.status.to_dict()
        if self.data is not None:
            datad: dict[str, Any] = {"names": list(self.names)}
            if self.encoding == "binTensor":
                buf, name = wire_array(self.data)
                datad["binTensor"] = {
                    "shape": list(buf.shape),
                    "dtype": name,
                    "b64": base64.b64encode(buf.data).decode("ascii"),
                }
            elif self.encoding == "tensor":
                arr = self.host_data()
                datad["tensor"] = {
                    "shape": list(arr.shape),
                    "values": arr.astype(np.float64).ravel().tolist(),
                }
            else:
                datad["ndarray"] = self.host_data().tolist()
            out["data"] = datad
        elif self.bin_data is not None:
            out["binData"] = base64.b64encode(self.bin_data).decode("ascii")
        elif self.str_data is not None:
            out["strData"] = self.str_data
        elif self.json_data is not None:
            out["jsonData"] = self.json_data
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "SeldonMessage":
        msg = cls(meta=Meta.from_dict(d.get("meta")),
                  status=Status.from_dict(d["status"]) if "status" in d
                  else None)
        if "data" in d:
            datad = d["data"] or {}
            msg.names = list(datad.get("names") or [])
            if "ndarray" in datad:
                msg.data = np.asarray(datad["ndarray"])
                msg.encoding = "ndarray"
            elif "tensor" in datad:
                t = datad["tensor"]
                msg.data = np.asarray(t.get("values", []),
                                      dtype=np.float64).reshape(
                                          t.get("shape", [-1]))
                msg.encoding = "tensor"
            elif "binTensor" in datad:
                t = datad["binTensor"]
                # a bytearray: the array is writable, as a JSON one is
                raw = bytearray(base64.b64decode(t["b64"]))
                msg.data = array_from_buffer(
                    raw, t.get("dtype", "float32"), t["shape"])
                msg.encoding = "binTensor"
            elif "deviceRef" in datad:
                # the tensor never rode the wire: a ref that cannot
                # resolve here raises (ForeignProcessRef, KeyError), which
                # the transport answers as the error the sender
                # downgrades on, never an empty message
                from seldon_core_tpu_torch.runtime.device_registry import (
                    registry,
                )

                ref = DeviceTensorRef.from_dict(datad["deviceRef"])
                # the raise IS the downgrade signal at this boundary
                msg.data = registry.resolve(ref.ref)  # graphlint: disable=RL703
                msg.encoding = "binTensor"
            # any other ``data`` leaves the message without a tensor, as
            # the reference's does
        elif "binData" in d:
            msg.bin_data = base64.b64decode(d["binData"])
        elif "strData" in d:
            msg.str_data = d["strData"]
        elif "jsonData" in d:
            msg.json_data = d["jsonData"]
        return msg

    @classmethod
    def from_json(cls, s: Union[str, bytes]) -> "SeldonMessage":
        return cls.from_dict(json.loads(s))

    @classmethod
    def parse(cls, s: Union[str, bytes, dict, "SeldonMessage"]
              ) -> "SeldonMessage":
        """A message from JSON text or bytes, a dict, or a message (returned
        as it is)."""
        if isinstance(s, SeldonMessage):
            return s
        if isinstance(s, dict):
            return cls.from_dict(s)
        return cls.from_json(s)


@dataclass
class Feedback:
    """Reward feedback (reference ``messages.py`` ``Feedback``)."""

    request: Optional[SeldonMessage] = None
    response: Optional[SeldonMessage] = None
    reward: float = 0.0
    truth: Optional[SeldonMessage] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"reward": self.reward}
        for key in ("request", "response", "truth"):
            part = getattr(self, key)
            if part is not None:
                d[key] = part.to_dict()
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "Feedback":
        def msg(key):
            return SeldonMessage.from_dict(d[key]) if key in d else None

        return cls(request=msg("request"), response=msg("response"),
                   reward=float(d.get("reward", 0.0)), truth=msg("truth"))

    @classmethod
    def from_json(cls, s: Union[str, bytes]) -> "Feedback":
        return cls.from_dict(json.loads(s))
