"""Inference-graph spec: the ``PredictiveUnit`` tree of the SeldonDeployment
CRD (port of ``seldon_core_tpu/graph/spec.py`` and of the parts of
``seldon_core_tpu/operator/spec.py`` the local runner reads).

Parses the reference's JSON layout: ``PredictiveUnit{name, children[],
type, implementation, methods[], endpoint{service_host, service_port,
type}, parameters[]{name, value, type}}``, with typed parameters
(INT, FLOAT/DOUBLE, STRING, BOOL; any other type stays a string, as in the
reference).  :func:`load_deployment` reads every predictor: its name,
graph, ``replicas`` and ``traffic`` (the reference's defaults, 1 and 100),
and its ``seldon.io/*`` annotations merged as metadata, then spec, then the
predictor's own, the later winning.  It checks what the reference checks
at admission: unique predictor names, no negative replicas, a valid graph,
and a valid ``seldon.io/graph-plan`` (:func:`graph_plan_mode`),
``seldon.io/prediction-cache*`` (:func:`prediction_cache_config`),
``seldon.io/artifact*`` (:func:`artifact_config`),
``seldon.io/device-plane*`` (:func:`device_plane_config`),
``seldon.io/tracing`` and ``seldon.io/trace-*`` (:func:`trace_config`),
``seldon.io/health*`` (:func:`health_config`) and ``seldon.io/profile*``
(:func:`profile_config`) on every predictor; a bad value raises
:class:`DeploymentValidationError` with the reference's message.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["UNIT_TYPES", "BUILTIN_IMPLEMENTATIONS", "GraphValidationError",
           "DeploymentValidationError", "Endpoint", "PredictiveUnit",
           "parse_graph", "validate_graph", "Predictor", "Deployment",
           "check_plan_mode", "graph_plan_mode", "prediction_cache_config",
           "artifact_config", "device_plane_config", "trace_config",
           "health_config", "profile_config", "placement_config",
           "load_deployment"]

UNIT_TYPES = ("MODEL", "ROUTER", "COMBINER", "TRANSFORMER",
              "OUTPUT_TRANSFORMER")
BUILTIN_IMPLEMENTATIONS = ("SIMPLE_MODEL", "SIMPLE_ROUTER", "RANDOM_ABTEST",
                           "AVERAGE_COMBINER", "EPSILON_GREEDY")
# BOOL is coerced on its own (`_coerce_param`); listed for the CRD schema
PARAM_TYPES = {"STRING": str, "INT": int, "FLOAT": float, "DOUBLE": float,
               "BOOL": None}
_BOOL_TRUE = ("1", "true", "yes")
_BOOL_FALSE = ("0", "false", "no")


class GraphValidationError(Exception):
    pass


class DeploymentValidationError(GraphValidationError):
    """A deployment the reference's admission would reject."""


def _coerce_param(value, ptype: str, unit: str, param: str) -> Any:
    where = f"{unit}: parameter {param!r}"
    if ptype == "BOOL":
        s = str(value).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        raise GraphValidationError(
            f"{where}: invalid BOOL value {value!r} "
            f"(expected one of {_BOOL_TRUE + _BOOL_FALSE})")
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

    def to_dict(self) -> dict:
        return {"service_host": self.service_host,
                "service_port": self.service_port, "type": self.type}


@dataclass
class PredictiveUnit:
    name: str
    type: Optional[str] = None  # inferred from implementation when absent
    implementation: Optional[str] = None
    children: list["PredictiveUnit"] = field(default_factory=list)
    parameters: dict[str, Any] = field(default_factory=dict)
    methods: list[str] = field(default_factory=list)
    endpoint: Endpoint = field(default_factory=Endpoint)
    # placement hint of the reference (``sliceGroup``): kept so a spec
    # round-trips through the operator unchanged
    slice_group: str = ""

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
            slice_group=d.get("sliceGroup", ""),
        )

    def to_dict(self) -> dict:
        """The reference's JSON layout; parameters carry their type."""
        d: dict[str, Any] = {"name": self.name}
        if self.type:
            d["type"] = self.type
        if self.implementation:
            d["implementation"] = self.implementation
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        if self.parameters:
            d["parameters"] = [
                {"name": k, "value": str(v), "type": _param_type_name(v)}
                for k, v in self.parameters.items()]
        if self.endpoint.service_host or self.endpoint.service_port:
            d["endpoint"] = self.endpoint.to_dict()
        if self.methods:
            d["methods"] = self.methods
        if self.slice_group:
            d["sliceGroup"] = self.slice_group
        return d

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


def _param_type_name(v: Any) -> str:
    if isinstance(v, bool):
        return "BOOL"
    if isinstance(v, int):
        return "INT"
    if isinstance(v, float):
        return "FLOAT"
    return "STRING"


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
class Predictor:
    """One predictor of a deployment: its graph, merged annotations and its
    share of the traffic (``replicas`` x ``traffic``)."""

    name: str
    graph: PredictiveUnit
    annotations: dict[str, str] = field(default_factory=dict)
    replicas: int = 1
    traffic: int = 100


@dataclass
class Deployment:
    """A SeldonDeployment: every predictor, in order.  ``graph``,
    ``annotations`` and ``predictor`` read the first one's, for callers
    that serve one."""

    name: str
    predictors: list[Predictor]

    @property
    def graph(self) -> PredictiveUnit:
        return self.predictors[0].graph

    @property
    def annotations(self) -> dict[str, str]:
        return self.predictors[0].annotations

    @property
    def predictor(self) -> str:
        return self.predictors[0].name


def check_plan_mode(value) -> str:
    """A graph-plan mode, ``walk`` or ``fused``, normalised; anything else
    raises with the reference admission's message."""
    mode = str(value).strip().lower()
    if mode not in ("walk", "fused"):
        raise DeploymentValidationError(
            f"annotation seldon.io/graph-plan must be 'walk' or 'fused', "
            f"got {mode!r}")
    return mode


def graph_plan_mode(ann: dict) -> str:
    """``seldon.io/graph-plan``: ``walk`` (default, the per-node walk) or
    ``fused`` (maximal static subgraphs run as segments, ``graph/plan.py``).
    Anything else raises, as the reference's admission does."""
    return check_plan_mode(ann.get("seldon.io/graph-plan", "walk"))


def prediction_cache_config(ann: dict, name: str):
    """``seldon.io/prediction-cache*`` as a ``caching.CacheConfig``, or None
    when the tier is off; an invalid value raises."""
    from seldon_core_tpu_torch.caching import config_from_annotations

    try:
        return config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def artifact_config(ann: dict, name: str):
    """``seldon.io/artifact*`` (or the ``SELDON_ARTIFACT_STORE`` env) as an
    ``artifacts.ArtifactConfig``, or None when the family is absent; an
    invalid value raises."""
    from seldon_core_tpu_torch.artifacts.config import (
        artifact_config_from_annotations,
    )

    try:
        return artifact_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def device_plane_config(ann: dict, name: str):
    """``seldon.io/device-plane*`` as a ``runtime.device_plane.
    DevicePlaneConfig``, or None when the family is absent; an invalid
    value raises."""
    from seldon_core_tpu_torch.runtime.device_plane import (
        device_plane_config_from_annotations,
    )

    try:
        return device_plane_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def trace_config(ann: dict, name: str):
    """``seldon.io/tracing`` / ``seldon.io/trace-*`` as a
    ``utils.tracing.TraceConfig``; an invalid value (a sample rate outside
    [0, 1], a non-numeric slow-ms bar, a bad ring size) raises with the
    reference admission's message."""
    from seldon_core_tpu_torch.utils.tracing import (
        trace_config_from_annotations,
    )

    try:
        return trace_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def health_config(ann: dict, name: str):
    """``seldon.io/health*`` / ``seldon.io/slo-availability`` as a
    ``health.HealthConfig``; an invalid value (an availability objective
    outside (0, 1), a non-positive sample interval, a bad ring size)
    raises with the reference admission's message."""
    from seldon_core_tpu_torch.health.config import (
        health_config_from_annotations,
    )

    try:
        return health_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def profile_config(ann: dict, name: str):
    """``seldon.io/profile*`` as a ``profiling.ProfileConfig``; an invalid
    value (a sampling rate outside (0, 1000], a non-positive stack-table
    cap, a capture window beyond ten minutes, a storm threshold below 2)
    raises with the reference admission's message."""
    from seldon_core_tpu_torch.profiling.config import (
        profile_config_from_annotations,
    )

    try:
        return profile_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def placement_config(ann: dict, name: str):
    """``seldon.io/mesh`` / ``seldon.io/placement`` as a
    ``placement.PlacementConfig`` (``enabled`` False without a mesh); an
    invalid value raises with the reference admission's message."""
    from seldon_core_tpu_torch.placement.config import (
        placement_config_from_annotations,
    )

    try:
        return placement_config_from_annotations(ann, name)
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


def _read_deployment_file(path) -> dict:
    """A deployment file's mapping: JSON, else YAML as ``utils/yamlite.py``
    reads it."""
    from seldon_core_tpu_torch.utils import yamlite

    with open(path) as f:
        text = f.read()
    try:
        d = json.loads(text)
    except ValueError:
        d = yamlite.safe_load(text)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: not a JSON or YAML mapping")
    return d


def load_deployment(src) -> Deployment:
    """A SeldonDeployment from a dict, a JSON string or the path of a JSON
    or YAML file."""
    if isinstance(src, dict):
        d = src
    elif isinstance(src, str) and src.lstrip().startswith("{"):
        d = json.loads(src)
    else:
        d = _read_deployment_file(src)
    meta = d.get("metadata", {})
    spec = d.get("spec", d)
    name = spec.get("name") or meta.get("name", "")
    raw = spec.get("predictors") or []
    if not raw:
        raise GraphValidationError("deployment has no predictors")
    base = {**meta.get("annotations", {}), **spec.get("annotations", {})}
    predictors, seen = [], set()
    for p in raw:
        pname = p.get("name") or "predictor"
        if pname in seen:
            raise DeploymentValidationError(f"duplicate predictor {pname!r}")
        seen.add(pname)
        pred = Predictor(name=pname, graph=parse_graph(p.get("graph", {})),
                         annotations={**base, **p.get("annotations", {})},
                         replicas=int(p.get("replicas", 1)),
                         traffic=int(p.get("traffic", 100)))
        if pred.replicas < 0:
            raise DeploymentValidationError(f"{pname}: negative replicas")
        validate_graph(pred.graph)
        graph_plan_mode(pred.annotations)
        prediction_cache_config(pred.annotations, f"{name}/{pname}")
        artifact_config(pred.annotations, f"{name}/{pname}")
        device_plane_config(pred.annotations, f"{name}/{pname}")
        trace_config(pred.annotations, f"{name}/{pname}")
        health_config(pred.annotations, f"{name}/{pname}")
        profile_config(pred.annotations, f"{name}/{pname}")
        placement_config(pred.annotations, f"{name}/{pname}")
        predictors.append(pred)
    return Deployment(name=name, predictors=predictors)
