"""Inference-graph spec: the ``PredictiveUnit`` tree of the SeldonDeployment
CRD (port of ``seldon_core_tpu/graph/spec.py`` and of the parts of
``seldon_core_tpu/operator/spec.py`` the local runner reads).

Parses the reference's JSON layout: ``PredictiveUnit{name, children[],
type, implementation, methods[], endpoint{service_host, service_port,
type}, parameters[]{name, value, type}}``, with typed parameters
(INT, FLOAT/DOUBLE, STRING, BOOL; any other type stays a string, as in the
reference).  :func:`load_deployment` takes the
first predictor's graph and the deployment's ``seldon.io/*`` annotations
(metadata, then spec, then the predictor's own, the later winning).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["UNIT_TYPES", "BUILTIN_IMPLEMENTATIONS", "GraphValidationError",
           "Endpoint", "PredictiveUnit", "parse_graph", "validate_graph",
           "Deployment", "load_deployment"]

UNIT_TYPES = ("MODEL", "ROUTER", "COMBINER", "TRANSFORMER",
              "OUTPUT_TRANSFORMER")
BUILTIN_IMPLEMENTATIONS = ("SIMPLE_MODEL", "SIMPLE_ROUTER", "RANDOM_ABTEST",
                           "AVERAGE_COMBINER", "EPSILON_GREEDY")
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
    conv = PARAM_TYPES.get(ptype, str)
    try:
        return conv(value)
    except (TypeError, ValueError):
        raise GraphValidationError(
            f"{where}: invalid {ptype} value {value!r}") from None


@dataclass
class Endpoint:
    """Where a remote node's component listens."""

    service_host: str = ""
    service_port: int = 0
    type: str = "REST"  # REST | GRPC | LOCAL

    @classmethod
    def from_dict(cls, d: Optional[dict], unit: str = "") -> "Endpoint":
        d = d or {}
        raw_port = d.get("service_port", d.get("servicePort", 0)) or 0
        try:
            port = int(raw_port)
        except (TypeError, ValueError):
            raise GraphValidationError(
                f"{unit or '<unit>'}: endpoint service_port {raw_port!r} "
                "is not an integer") from None
        return cls(service_host=d.get("service_host",
                                      d.get("serviceHost", "")),
                   service_port=port, type=d.get("type", "REST"))


@dataclass
class PredictiveUnit:
    name: str
    type: Optional[str] = None  # inferred from implementation when absent
    implementation: Optional[str] = None
    children: list["PredictiveUnit"] = field(default_factory=list)
    parameters: dict[str, Any] = field(default_factory=dict)
    methods: list[str] = field(default_factory=list)
    endpoint: Endpoint = field(default_factory=Endpoint)

    @classmethod
    def from_dict(cls, d: dict, path: str = "") -> "PredictiveUnit":
        name = d.get("name", "")
        # full name path from the root, for error messages ("root/a/b")
        path = f"{path}/{name}" if path else (name or "<root>")
        params = {
            p["name"]: _coerce_param(p.get("value"), p.get("type", "STRING"),
                                     path, p["name"])
            for p in d.get("parameters", []) or []
        }
        return cls(
            name=name, type=d.get("type"),
            implementation=d.get("implementation"),
            children=[cls.from_dict(c, path)
                      for c in d.get("children", []) or []],
            parameters=params,
            methods=list(d.get("methods", []) or []),
            endpoint=Endpoint.from_dict(d.get("endpoint"), path),
        )

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    @property
    def resolved_type(self) -> str:
        """The type, inferred from a built-in implementation when absent."""
        if self.type:
            return self.type
        impl = self.implementation or ""
        if impl in ("SIMPLE_ROUTER", "RANDOM_ABTEST", "EPSILON_GREEDY"):
            return "ROUTER"
        if impl == "AVERAGE_COMBINER":
            return "COMBINER"
        return "MODEL"


def parse_graph(spec: Any) -> PredictiveUnit:
    if isinstance(spec, PredictiveUnit):
        return spec
    if isinstance(spec, (str, bytes)):
        spec = json.loads(spec)
    return PredictiveUnit.from_dict(spec)


def validate_graph(root: PredictiveUnit) -> None:
    """Unique non-empty names, known types and implementations, and
    children under every COMBINER and ROUTER."""
    seen: set[str] = set()
    for unit in root.walk():
        if not unit.name:
            raise GraphValidationError("graph node with empty name")
        if unit.name in seen:
            raise GraphValidationError(f"duplicate node name {unit.name!r}")
        seen.add(unit.name)
        t = unit.resolved_type
        if t not in UNIT_TYPES:
            raise GraphValidationError(f"{unit.name}: unknown type {t!r}")
        if (unit.implementation
                and unit.implementation not in BUILTIN_IMPLEMENTATIONS):
            raise GraphValidationError(
                f"{unit.name}: unknown implementation "
                f"{unit.implementation!r}")
        if t in ("COMBINER", "ROUTER") and not unit.children:
            raise GraphValidationError(f"{unit.name}: {t} requires children")


@dataclass
class Deployment:
    name: str
    graph: PredictiveUnit
    annotations: dict[str, str] = field(default_factory=dict)
    predictor: str = "predictor"  # the first predictor's name


def load_deployment(src) -> Deployment:
    """A SeldonDeployment from a dict, a JSON string or a file path."""
    if isinstance(src, dict):
        d = src
    elif isinstance(src, str) and src.lstrip().startswith("{"):
        d = json.loads(src)
    else:
        with open(src) as f:
            d = json.load(f)
    meta = d.get("metadata", {})
    spec = d.get("spec", d)
    preds = spec.get("predictors") or []
    if not preds:
        raise GraphValidationError("deployment has no predictors")
    graph = parse_graph(preds[0].get("graph", {}))
    validate_graph(graph)
    return Deployment(
        name=spec.get("name") or meta.get("name", ""),
        graph=graph,
        annotations={**meta.get("annotations", {}),
                     **spec.get("annotations", {}),
                     **preds[0].get("annotations", {})},
        predictor=preds[0].get("name") or "predictor",
    )
