"""SeldonDeployment graph spec (port of the parts of
``seldon_core_tpu/graph/spec.py`` this slice needs).

Parses the reference's JSON layout: the first predictor's graph, one MODEL
node with typed ``parameters[]`` (INT, FLOAT/DOUBLE, STRING, BOOL).  A
graph with more than one node raises until slice 2 of the port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

__all__ = ["GraphValidationError", "PredictiveUnit", "Deployment",
           "load_deployment"]

PARAM_TYPES = {"STRING": str, "INT": int, "FLOAT": float, "DOUBLE": float}
_BOOL_TRUE = ("1", "true", "yes")
_BOOL_FALSE = ("0", "false", "no")


class GraphValidationError(Exception):
    pass


def _coerce_param(value, ptype: str, unit: str, param: str) -> Any:
    where = f"{unit}: parameter {param!r}"
    if ptype == "BOOL":
        s = str(value).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        raise GraphValidationError(f"{where}: invalid BOOL value {value!r}")
    conv = PARAM_TYPES.get(ptype)
    if conv is None:
        raise GraphValidationError(f"{where}: unknown type {ptype!r}")
    try:
        return conv(value)
    except (TypeError, ValueError):
        raise GraphValidationError(
            f"{where}: invalid {ptype} value {value!r}") from None


@dataclass
class PredictiveUnit:
    name: str
    type: str = "MODEL"
    implementation: str = ""
    parameters: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "PredictiveUnit":
        name = d.get("name", "") or "<root>"
        if d.get("children"):
            raise NotImplementedError(
                f"graph {name!r} has more than one node; multi-node graphs "
                "come with slice 2 of the port")
        utype = d.get("type", "MODEL")
        if utype != "MODEL":
            raise NotImplementedError(
                f"node {name!r} is a {utype}; only MODEL nodes are served in "
                "this slice")
        params = {
            p["name"]: _coerce_param(p.get("value"), p.get("type", "STRING"),
                                     name, p["name"])
            for p in d.get("parameters", []) or []
        }
        return cls(name=name, type=utype,
                   implementation=d.get("implementation", "") or "",
                   parameters=params)


@dataclass
class Deployment:
    name: str
    graph: PredictiveUnit


def load_deployment(src) -> Deployment:
    """A SeldonDeployment from a dict, a JSON string or a file path."""
    if isinstance(src, dict):
        d = src
    elif isinstance(src, str) and src.lstrip().startswith("{"):
        d = json.loads(src)
    else:
        with open(src) as f:
            d = json.load(f)
    spec = d.get("spec", d)
    preds = spec.get("predictors") or []
    if not preds:
        raise GraphValidationError("deployment has no predictors")
    return Deployment(
        name=spec.get("name") or d.get("metadata", {}).get("name", ""),
        graph=PredictiveUnit.from_dict(preds[0]["graph"]),
    )
