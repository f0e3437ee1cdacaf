"""``SeldonMessage`` subset (port of ``seldon_core_tpu/messages.py``).

The JSON matches the reference's wire format for what this slice serves:
``jsonData``, ``data.ndarray`` / ``data.tensor``, ``strData``, ``binData``,
``meta`` (``puid``, ``tags``, ``routing``, ``requestPath``, ``metrics``) and
``status``, and the reward ``Feedback``.  ``data`` may hold a numpy array or
a torch tensor; it reaches the host only when the message is serialized.
"""

from __future__ import annotations

import base64
import enum
import json
import secrets
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import numpy as np

__all__ = ["MetricType", "Metric", "Meta", "Status", "SeldonMessage",
           "Feedback", "new_puid"]


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


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):  # torch tensor, possibly on the card
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class SeldonMessage:
    data: Any = None
    names: list[str] = field(default_factory=list)
    bin_data: Optional[bytes] = None
    str_data: Optional[str] = None
    json_data: Any = None
    meta: Meta = field(default_factory=Meta)
    status: Optional[Status] = None
    encoding: str = "ndarray"  # "ndarray" | "tensor"

    @classmethod
    def from_ndarray(cls, arr, names=(), **kw) -> "SeldonMessage":
        return cls(data=arr, names=list(names), **kw)

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
            arr = self.host_data()
            datad: dict[str, Any] = {"names": list(self.names)}
            if self.encoding == "tensor":
                datad["tensor"] = {
                    "shape": list(arr.shape),
                    "values": arr.astype(np.float64).ravel().tolist(),
                }
            else:
                datad["ndarray"] = arr.tolist()
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
            elif "tensor" in datad:
                t = datad["tensor"]
                msg.data = np.asarray(t.get("values", []),
                                      dtype=np.float64).reshape(
                                          t.get("shape", [-1]))
                msg.encoding = "tensor"
            else:
                raise ValueError("data needs ndarray or tensor")
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


@dataclass
class Feedback:
    """Reward feedback (reference ``messages.py`` ``Feedback``)."""

    request: Optional[SeldonMessage] = None
    response: Optional[SeldonMessage] = None
    reward: float = 0.0
    truth: Optional[SeldonMessage] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Feedback":
        def msg(key):
            return SeldonMessage.from_dict(d[key]) if key in d else None

        return cls(request=msg("request"), response=msg("response"),
                   reward=float(d.get("reward", 0.0)), truth=msg("truth"))
