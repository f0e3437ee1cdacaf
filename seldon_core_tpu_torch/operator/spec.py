"""SeldonDeployment spec: the CRD data model as the operator's admission
reads it (port of the data model of ``seldon_core_tpu/operator/spec.py``).

Unlike :func:`~seldon_core_tpu_torch.graph.spec.load_deployment`, which
the local runner uses and which refuses a bad graph or annotation at load,
:meth:`SeldonDeployment.from_dict` only parses: the admission lint
(``analysis/graphlint.py`` :func:`lint_deployment`) reports each defect as
a finding with its own code.  Manifest rendering and the operator's own
validation come with the operator slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from seldon_core_tpu_torch.graph.spec import PredictiveUnit, parse_graph

__all__ = ["PredictorSpec", "SeldonDeployment"]


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
