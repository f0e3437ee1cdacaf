"""SeldonDeployment spec: the CRD data model the operator reads and writes
(port of ``seldon_core_tpu/operator/spec.py``).

Unlike :func:`~seldon_core_tpu_torch.graph.spec.load_deployment`, which
the local runner uses and which refuses a bad graph or annotation at load,
:meth:`SeldonDeployment.from_dict` only parses: the admission lint
(``analysis/graphlint.py`` :func:`lint_deployment`) reports each defect as
a finding with its own code, and :func:`validate_deployment` is the
operator's own structural check (``operator/compile.py`` runs it first).

Device annotations (all optional; the names are the reference's):
``seldon.io/tpu-chips`` the devices a predictor's graph needs (GPUs here),
``seldon.io/colocate-graph`` "true" (default: the whole graph in one pod)
or "false" (one pod per component), ``seldon.io/batch-max-size`` /
``seldon.io/batch-max-delay-ms`` the batcher of every MODEL node.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from seldon_core_tpu_torch.graph.spec import (
    DeploymentValidationError,
    GraphValidationError,
    PredictiveUnit,
    parse_graph,
    validate_graph,
)

__all__ = ["API_VERSION", "KIND", "PredictorSpec", "SeldonDeployment",
           "DeploymentValidationError", "validate_deployment"]

API_VERSION = "machinelearning.seldon.io/v1alpha3"
KIND = "SeldonDeployment"


@dataclass
class PredictorSpec:
    name: str
    graph: PredictiveUnit
    replicas: int = 1
    annotations: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    component_specs: list[dict] = field(default_factory=list)
    traffic: int = 100

    @classmethod
    def from_dict(cls, d: dict) -> "PredictorSpec":
        return cls(
            name=d.get("name", ""),
            graph=parse_graph(d.get("graph", {})),
            replicas=int(d.get("replicas", 1)),
            annotations=dict(d.get("annotations", {})),
            labels=dict(d.get("labels", {})),
            component_specs=list(d.get("componentSpecs", []) or []),
            traffic=int(d.get("traffic", 100)),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "graph": self.graph.to_dict(),
            "replicas": self.replicas,
            "annotations": self.annotations,
            "labels": self.labels,
            "componentSpecs": self.component_specs,
            "traffic": self.traffic,
        }


@dataclass
class SeldonDeployment:
    name: str
    predictors: list[PredictorSpec] = field(default_factory=list)
    oauth_key: str = ""
    oauth_secret: str = ""
    annotations: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    namespace: str = "default"

    @classmethod
    def from_dict(cls, d: dict) -> "SeldonDeployment":
        meta = d.get("metadata", {})
        spec = d.get("spec", {})
        return cls(
            name=spec.get("name") or meta.get("name", ""),
            predictors=[PredictorSpec.from_dict(p)
                        for p in spec.get("predictors", [])],
            oauth_key=spec.get("oauth_key", ""),
            oauth_secret=spec.get("oauth_secret", ""),
            # metadata + spec annotations merge (spec wins)
            annotations={**meta.get("annotations", {}),
                         **spec.get("annotations", {})},
            labels=dict(meta.get("labels", {})),
            namespace=meta.get("namespace", "default"),
        )

    @classmethod
    def from_json(cls, s) -> "SeldonDeployment":
        return cls.from_dict(json.loads(s))

    def to_dict(self) -> dict:
        return {
            "apiVersion": API_VERSION,
            "kind": KIND,
            "metadata": {"name": self.name, "namespace": self.namespace,
                         "labels": self.labels},
            "spec": {
                "name": self.name,
                "oauth_key": self.oauth_key,
                "oauth_secret": self.oauth_secret,
                "annotations": self.annotations,
                "predictors": [p.to_dict() for p in self.predictors],
            },
        }


def validate_deployment(dep: SeldonDeployment) -> None:
    """The operator's structural check: a name, predictors with unique
    names and no negative replicas, valid graphs, and every non-builtin
    node resolvable to a container, a ``model_class`` or an endpoint.
    Raises :class:`DeploymentValidationError` with the reference's
    messages."""
    if not dep.name:
        raise DeploymentValidationError("deployment has no name")
    if not dep.predictors:
        raise DeploymentValidationError("deployment has no predictors")
    seen = set()
    for p in dep.predictors:
        if p.name in seen:
            raise DeploymentValidationError(f"duplicate predictor {p.name!r}")
        seen.add(p.name)
        if p.replicas < 0:
            raise DeploymentValidationError(f"{p.name}: negative replicas")
        try:
            validate_graph(p.graph)
        except GraphValidationError as e:
            raise DeploymentValidationError(f"{p.name}: {e}") from e
        containers = _container_names(p)
        for unit in p.graph.walk():
            if unit.implementation:
                continue
            if (not unit.parameters.get("model_class")
                    and unit.name not in containers
                    and not unit.endpoint.service_host):
                raise DeploymentValidationError(
                    f"{p.name}: graph node {unit.name!r} has no "
                    "implementation, no matching container, no model_class "
                    "parameter, and no endpoint")


def _container_names(p: PredictorSpec) -> set[str]:
    names = set()
    for cs in p.component_specs:
        for c in (cs.get("spec", {}) or {}).get("containers", []) or []:
            if c.get("name"):
                names.add(c["name"])
    return names
