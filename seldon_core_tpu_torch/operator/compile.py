"""Compile a SeldonDeployment into Kubernetes manifests with GPU
placement (port of ``seldon_core_tpu/operator/compile.py``).

- **defaulting**: port assignment from a base port, env injection
  (``PREDICTIVE_UNIT_SERVICE_PORT/_PARAMETERS/_ID``, ``PREDICTOR_ID``,
  ``SELDON_DEPLOYMENT_ID``), probe and preStop wiring, and the graph
  endpoints rewritten to service DNS names.
- **admission**: :func:`validate_deployment`, every plane's annotation
  parser as a hard stop (``*_config``), and the static graph checker
  (:func:`admission_lint`, ``analysis/graphlint.py``).
- **placement**: by default a predictor's whole graph is colocated in one
  pod, so graph edges stay on the device instead of HTTP hops.  The pod
  asks for ``nvidia.com/gpu`` (``seldon.io/tpu-chips`` of them, at most
  :data:`GPUS_PER_HOST`) on an H100 node pool; more devices than one host
  holds become a StatefulSet per replica with the multi-host env contract
  (:data:`ENV_WORKER_ID`, :data:`ENV_NUM_HOSTS`, :data:`ENV_COORDINATOR`).
  ``seldon.io/tpu-topology`` has no GPU counterpart and is ignored.
  Components that opt out (``colocate-graph: "false"`` or remote
  endpoints) get the reference's layout: one Deployment and ClusterIP
  Service per component.

Every other field of every manifest is the reference's, the engine's
``ENGINE_PREDICTOR`` env included, which ``operator/local.py`` boots from.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import re
from typing import Any, Optional

from seldon_core_tpu_torch.graph import spec as graph_spec
from seldon_core_tpu_torch.operator.spec import (
    DeploymentValidationError,
    PredictorSpec,
    SeldonDeployment,
    validate_deployment,
)
# the multi-host env contract, defined once in runtime/multihost.py (the
# runtime half that parses it): the manifests carry what it reads
from seldon_core_tpu_torch.runtime.multihost import (
    COORDINATOR_PORT,
    ENV_COORDINATOR,
    ENV_NUM_HOSTS,
    ENV_WORKER_ID,
)

ENGINE_PORT = 8000
GRPC_PORT = 5001
METRICS_PORT = 8000
PU_PORT_BASE = 9000
# default engine image; per-install override via env SELDON_ENGINE_IMAGE
# (the chart's engine.image value — charts/seldon-core-tpu/values.yaml)
ENGINE_IMAGE = "seldon-core-tpu/engine:latest"


def engine_image() -> str:
    return os.environ.get("SELDON_ENGINE_IMAGE", ENGINE_IMAGE)

# Model-artifact materialization (runtime/checkpoint.py model_uri): graph
# nodes with a REMOTE model_uri parameter get their artifact downloaded
# into an emptyDir by an initContainer before the serving container boots,
# and the parameter rewritten to the mount path — the artifact analog of
# the reference baking weights into the image at s2i build time
# (``wrappers/s2i/python/s2i/bin/assemble:16-60``); a rolling update of
# the CRD's model_uri rolls weight versions exactly like the reference's
# image-tag rollout (``SeldonDeploymentOperatorImpl.java:642``).
MODEL_MOUNT = "/mnt/seldon-models"
MODEL_VOLUME = "seldon-models"
MODEL_INITIALIZER_IMAGE = "seldon-core-tpu/model-initializer:latest"


def model_initializer_image() -> str:
    return os.environ.get("SELDON_MODEL_INITIALIZER_IMAGE",
                          MODEL_INITIALIZER_IMAGE)


# devices per node: an H100 host holds 8.  Predictors needing more span
# hosts as a StatefulSet per replica (the multi-host env contract above).
GPUS_PER_HOST = 8
GPU_RESOURCE = "nvidia.com/gpu"
GPU_NODE_SELECTOR = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}


def _int_ann(ann: dict, key: str, default: int) -> int:
    raw = ann.get(key, str(default)) or default
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise DeploymentValidationError(
            f"annotation {key} must be an integer, got {raw!r}"
        )


def _native_wire(dep: SeldonDeployment, p: PredictorSpec) -> bool:
    ann = {**dep.annotations, **p.annotations}
    return ann.get("seldon.io/native-wire", "").lower() == "true"


def tpu_chips_for(p: PredictorSpec, dep: SeldonDeployment) -> int:
    """Devices the predictor's pod asks for (``seldon.io/tpu-chips``)."""
    ann = {**dep.annotations, **p.annotations}
    return _int_ann(ann, "seldon.io/tpu-chips", 0)


def colocated(p: PredictorSpec, dep: SeldonDeployment) -> bool:
    ann = {**dep.annotations, **p.annotations}
    return ann.get("seldon.io/colocate-graph", "true").lower() != "false"


def defaulting(dep: SeldonDeployment) -> SeldonDeployment:
    """Assign ports + rewrite graph endpoints, in place (returns dep).

    Colocated graphs keep LOCAL endpoints (in-process edges); distributed
    graphs get service DNS endpoints like the reference."""
    for p in dep.predictors:
        port = PU_PORT_BASE
        for unit in p.graph.walk():
            if colocated(p, dep) and not unit.endpoint.service_host:
                unit.endpoint.type = "LOCAL"
                continue
            if not unit.endpoint.service_host:
                unit.endpoint.service_host = service_name(dep, p, unit.name)
                unit.endpoint.service_port = port
                port += 1
    return dep


def service_name(dep: SeldonDeployment, p: PredictorSpec, unit: str) -> str:
    return f"{dep.name}-{p.name}-{unit}"


NATIVE_PORT = 8500       # C++ REST tier (seldon.io/native-wire)
NATIVE_GRPC_PORT = 5500  # C++ h2c gRPC tier


def _remote_model_uris(p: PredictorSpec, local_only: bool = False
                       ) -> list[tuple[str, str]]:
    """``(unit_name, uri)`` for graph nodes whose ``model_uri`` parameter
    is a remote artifact (scheme'd, non-file) the pod must materialize.
    ``local_only``: restrict to nodes the ENGINE pod itself instantiates
    (implementation / LOCAL endpoint) — in the distributed layout the
    others are served by their own component pods."""
    out = []
    for unit in p.graph.walk():
        uri = unit.parameters.get("model_uri")
        if not (isinstance(uri, str)
                and re.match(r"^[a-z][a-z0-9+.-]*://", uri, re.IGNORECASE)
                and not uri.startswith("file://")):
            continue
        if local_only and not (
            unit.parameters.get("model_class") or unit.implementation
            or unit.endpoint.type == "LOCAL"
        ):
            continue
        out.append((unit.name, uri))
    return out


def _rewrite_model_uris(graph_dict: dict, names: set[str]) -> None:
    """Point the serialized graph's ``model_uri`` parameters at the
    initContainer mount paths (in place, on the DICT copy — the caller's
    spec object keeps the user's remote URIs)."""
    if graph_dict.get("name") in names:
        for param in graph_dict.get("parameters", []) or []:
            if param.get("name") == "model_uri":
                param["value"] = f"{MODEL_MOUNT}/{graph_dict['name']}"
    for child in graph_dict.get("children", []) or []:
        _rewrite_model_uris(child, names)


def _model_init(pod_spec: dict, container: dict,
                uris: list[tuple[str, str]]) -> None:
    """Mount the artifact emptyDir into ``container`` and prepend one
    initContainer that downloads every (unit, uri) into it."""
    if not uris:
        return
    pod_spec.setdefault("volumes", []).append(
        {"name": MODEL_VOLUME, "emptyDir": {}}
    )
    pod_spec.setdefault("initContainers", []).append({
        "name": "model-initializer",
        "image": model_initializer_image(),
        # pairwise [src dst ...] argv, matching the kfserving-style
        # storage-initializer contract
        "args": [a for name, uri in uris
                 for a in (uri, f"{MODEL_MOUNT}/{name}")],
        "volumeMounts": [{"name": MODEL_VOLUME, "mountPath": MODEL_MOUNT}],
    })
    container.setdefault("volumeMounts", []).append(
        {"name": MODEL_VOLUME, "mountPath": MODEL_MOUNT}
    )


def _engine_env(dep: SeldonDeployment, p: PredictorSpec) -> list[dict]:
    """Graph spec handed to the engine pod as base64 JSON in
    ``ENGINE_PREDICTOR``, which ``operator/local.py`` boots from.
    Annotations map to the local-runner flags: ``seldon.io/native-wire``
    ("true" → serve the C++ REST/gRPC tiers on NATIVE_PORT/NATIVE_GRPC_PORT
    beside the Python ones) and ``seldon.io/engine-workers`` (N →
    SO_REUSEPORT worker processes, serving/workers.py)."""
    pred = p.to_dict()
    uris = _remote_model_uris(p, local_only=True)
    if uris:
        _rewrite_model_uris(pred["graph"], {n for n, _ in uris})
    pred_json = json.dumps(pred)
    ann = {**dep.annotations, **p.annotations}
    env = [
        {"name": "ENGINE_PREDICTOR", "value": base64.b64encode(
            pred_json.encode()).decode()},
        {"name": "SELDON_DEPLOYMENT_ID", "value": dep.name},
        {"name": "PREDICTOR_ID", "value": p.name},
        {"name": "ENGINE_SERVER_PORT", "value": str(ENGINE_PORT)},
        {"name": "ENGINE_SERVER_GRPC_PORT", "value": str(GRPC_PORT)},
    ]
    if ann.get("seldon.io/native-wire", "").lower() == "true":
        env.append({"name": "ENGINE_NATIVE_PORT",
                    "value": str(NATIVE_PORT)})
        env.append({"name": "ENGINE_NATIVE_GRPC_PORT",
                    "value": str(NATIVE_GRPC_PORT)})
    workers = _int_ann(ann, "seldon.io/engine-workers", 1)
    if workers > 1:
        env.append({"name": "ENGINE_WORKERS", "value": str(workers)})
    return env


def _probes() -> dict:
    """Probe + drain wiring (reference operator ``:128-148``)."""
    return {
        "livenessProbe": {
            "httpGet": {"path": "/live", "port": ENGINE_PORT},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
        },
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": ENGINE_PORT},
            "initialDelaySeconds": 5,
            "periodSeconds": 2,
        },
        "lifecycle": {
            "preStop": {
                "exec": {
                    "command": [
                        "sh", "-c",
                        f"curl -s localhost:{ENGINE_PORT}/pause?timeout=10",
                    ]
                }
            }
        },
    }


def _ann(dep: SeldonDeployment, p: PredictorSpec) -> dict:
    return {**dep.annotations, **p.annotations}


def _where(dep: SeldonDeployment, p: PredictorSpec) -> str:
    return f"{dep.name}/{p.name}"


def _admit(parse, dep: SeldonDeployment, p: PredictorSpec):
    """``parse(annotations, where)``, its ValueError as the admission's
    DeploymentValidationError."""
    try:
        return parse(_ann(dep, p), _where(dep, p))
    except ValueError as e:
        raise DeploymentValidationError(str(e)) from None


# Each ``*_config`` below is one plane's annotation parser as an admission
# hard stop: graphlint reports the same defects as findings, this rejects
# them for callers that skip linting (``seldon.io/graphlint: off``).  The
# planes the local runner also reads go through ``graph/spec.py``'s.

def graph_plan_mode(dep: SeldonDeployment, p: PredictorSpec) -> str:
    """``seldon.io/graph-plan``: ``walk`` (default) or ``fused``."""
    return graph_spec.graph_plan_mode(_ann(dep, p))


def prediction_cache_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/prediction-cache*`` → ``caching.CacheConfig`` or None."""
    return graph_spec.prediction_cache_config(_ann(dep, p), _where(dep, p))


def trace_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/tracing`` / ``seldon.io/trace-*`` →
    ``utils.tracing.TraceConfig``."""
    return graph_spec.trace_config(_ann(dep, p), _where(dep, p))


def health_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/health*`` / ``seldon.io/slo-availability`` →
    ``health.HealthConfig``."""
    return graph_spec.health_config(_ann(dep, p), _where(dep, p))


def profile_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/profile*`` → ``profiling.ProfileConfig``."""
    return graph_spec.profile_config(_ann(dep, p), _where(dep, p))


def artifact_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/artifact-*`` → ``artifacts.ArtifactConfig`` or None."""
    return graph_spec.artifact_config(_ann(dep, p), _where(dep, p))


def device_plane_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/device-plane*`` → ``runtime.device_plane.
    DevicePlaneConfig`` or None."""
    return graph_spec.device_plane_config(_ann(dep, p), _where(dep, p))


def qos_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/slo-p95-ms`` / ``seldon.io/qos-*`` → ``qos.QosConfig``
    or None; a ``seldon.io/qos-fallback`` naming a node outside the graph,
    or its root, rejects too."""
    from seldon_core_tpu_torch.qos.policy import qos_from_annotations

    cfg = _admit(qos_from_annotations, dep, p)
    if cfg is not None and cfg.fallback_node:
        names = [u.name for u in p.graph.walk()]
        if cfg.fallback_node not in names:
            raise DeploymentValidationError(
                f"annotation seldon.io/qos-fallback names node "
                f"{cfg.fallback_node!r} which is not in predictor "
                f"{p.name!r}'s graph (nodes: {names})")
        if cfg.fallback_node == names[0]:
            raise DeploymentValidationError(
                f"annotation seldon.io/qos-fallback names the graph root "
                f"{cfg.fallback_node!r}: falling back to the primary is "
                "not a degraded mode")
    return cfg


def placement_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/mesh`` / ``seldon.io/placement`` →
    ``placement.PlacementConfig``."""
    from seldon_core_tpu_torch.placement import (
        placement_config_from_annotations,
    )

    return _admit(placement_config_from_annotations, dep, p)


def fleet_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/fleet-*`` → ``fleet.FleetConfig``."""
    from seldon_core_tpu_torch.fleet import fleet_config_from_annotations

    return _admit(fleet_config_from_annotations, dep, p)


def fleet_obs_config(dep: SeldonDeployment, p: PredictorSpec):
    """``seldon.io/fleet-obs-*`` → ``fleet.ObserveConfig``."""
    from seldon_core_tpu_torch.fleet import observe_config_from_annotations

    return _admit(observe_config_from_annotations, dep, p)


def graphlint_mode(dep: SeldonDeployment, p: PredictorSpec) -> str:
    """``seldon.io/graphlint`` enforcement mode: ``enforce`` (default,
    ERROR findings reject the spec), ``warn`` (compile anyway), ``off``
    (skip the graph checker)."""
    ann = {**dep.annotations, **p.annotations}
    return ann.get("seldon.io/graphlint", "enforce").strip().lower()


def admission_lint(dep: SeldonDeployment) -> list:
    """Static graph analysis at admission: structure, shape/dtype edges,
    deadline and memory feasibility, and, with the device plane on, the
    GL18xx residency verification, so a defective graph is rejected
    before any pod exists with its findings on ``status.analysis``.

    Raises :class:`~seldon_core_tpu_torch.analysis.GraphAnalysisError`
    when an enforce-mode predictor carries ERROR findings; returns every
    finding otherwise.  Admission loads torch and ``models/traceable.py``
    so the passes gated on them (GL1202 visible devices, GL16xx trace
    lint) always run here, whatever was imported before."""
    import torch  # noqa: F401  (opens the torch-gated passes)

    import seldon_core_tpu_torch.models.traceable  # noqa: F401
    from seldon_core_tpu_torch.analysis.graphlint import (
        GraphAnalysisError,
        lint_graph,
    )

    findings = []
    reject_findings = []
    for p in dep.predictors:
        mode = graphlint_mode(dep, p)
        if mode == "off":
            continue
        fs = lint_graph(p.graph, _ann(dep, p), path_prefix=p.name)
        findings.extend(fs)
        if mode != "warn" and any(f.severity == "ERROR" for f in fs):
            # the predictor's whole finding set, so the WARN/INFO context
            # (the GL1805 residency map) reaches status.analysis too
            reject_findings.extend(fs)
    if reject_findings:
        raise GraphAnalysisError(reject_findings)
    return findings


def compile_deployment(dep: SeldonDeployment) -> list[dict]:
    """validate → lint → default → manifests (Deployments + Services +
    optionally per-component resources)."""
    validate_deployment(dep)
    admission_lint(dep)
    defaulting(dep)
    manifests: list[dict] = []
    for p in dep.predictors:
        chips = tpu_chips_for(p, dep)
        if colocated(p, dep):
            manifests.extend(_colocated_predictor(dep, p, chips))
        else:
            manifests.extend(_distributed_predictor(dep, p, chips))
    manifests.append(_deployment_service(dep))
    return manifests


def _common_labels(dep: SeldonDeployment, p: Optional[PredictorSpec]) -> dict:
    labels = {
        "app": "seldon-core-tpu",
        "seldon-deployment-id": dep.name,
    }
    if p is not None:
        labels["seldon-predictor-id"] = p.name
        labels.update(p.labels)
    return labels


def _engine_labels(dep: SeldonDeployment, p: Optional[PredictorSpec]) -> dict:
    """Engine pods carry a role label so the deployment-wide Service and the
    engine Deployment selector never match component pods (whose labels are a
    superset of the common labels)."""
    return {**_common_labels(dep, p), "seldon-role": "engine"}


def _colocated_predictor(
    dep: SeldonDeployment, p: PredictorSpec, chips: int
) -> list[dict]:
    """One pod = engine + all graph components + the predictor's GPUs.

    More GPUs than one host holds become one StatefulSet per replica with
    ``hosts`` pods, each reading its worker ordinal from the pod index."""
    hosts = max(1, (chips + GPUS_PER_HOST - 1) // GPUS_PER_HOST) if chips else 1
    workload_name = f"{dep.name}-{p.name}"
    container: dict[str, Any] = {
        "name": "engine",
        "image": engine_image(),
        "args": ["serve", "--colocated"],
        "env": _engine_env(dep, p),
        "ports": [
            {"containerPort": ENGINE_PORT, "name": "http"},
            {"containerPort": GRPC_PORT, "name": "grpc"},
        ],
        **_probes(),
    }
    if _native_wire(dep, p):
        # expose the C++ tiers so the Service can map them in-cluster
        container["ports"].extend([
            {"containerPort": NATIVE_PORT, "name": "http-native"},
            {"containerPort": NATIVE_GRPC_PORT, "name": "grpc-native"},
        ])
    pod_spec: dict[str, Any] = {"containers": [container]}
    # remote model artifacts materialize before the engine boots; the
    # ENGINE_PREDICTOR env (already rewritten) points at the mount paths
    _model_init(pod_spec, container, _remote_model_uris(p, local_only=True))
    # merge user componentSpecs (images for user-code components)
    for cs in p.component_specs:
        for c in (cs.get("spec", {}) or {}).get("containers", []) or []:
            pod_spec["containers"].append(c)
    if chips:
        container["resources"] = {
            "limits": {GPU_RESOURCE: str(min(chips, GPUS_PER_HOST))}
        }
        pod_spec["nodeSelector"] = dict(GPU_NODE_SELECTOR)
        if hosts > 1:
            # StatefulSet pods (k8s >= 1.28) carry the pod-index label that
            # supplies the worker ordinal; Deployments never set it, so
            # multi-host predictors MUST be StatefulSets.
            container["env"].extend(
                [
                    {
                        "name": ENV_WORKER_ID,
                        "valueFrom": {
                            "fieldRef": {
                                "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"
                            }
                        },
                    },
                    {"name": ENV_NUM_HOSTS, "value": str(hosts)},
                ]
            )
    labels = _engine_labels(dep, p)

    def _pod_template(tmpl_labels: dict) -> dict:
        return {
            "metadata": {
                "labels": tmpl_labels,
                "annotations": {
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(METRICS_PORT),
                    "prometheus.io/path": "/metrics",
                },
            },
            "spec": pod_spec,
        }

    if hosts <= 1:
        return [
            {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "metadata": {
                    "name": workload_name,
                    "namespace": dep.namespace,
                    "labels": labels,
                },
                "spec": {
                    "replicas": p.replicas,
                    "strategy": {"rollingUpdate": {"maxUnavailable": "10%"}},
                    "selector": {"matchLabels": labels},
                    "template": _pod_template(labels),
                },
            }
        ]

    # Multi-host: ONE StatefulSet PER replica, each with replicas ==
    # hosts, so every pod-index is a valid worker id in [0, hosts) (a
    # single hosts*replicas StatefulSet would hand out ordinals past it).
    out: list[dict] = []
    for r in range(p.replicas):
        sts_name = workload_name if p.replicas == 1 else f"{workload_name}-r{r}"
        rlabels = {**labels, "seldon-slice-replica": str(r)}
        # per-replica pod template: the coordinator is THIS StatefulSet's
        # worker-0 pod under its headless service
        tmpl = copy.deepcopy(_pod_template(rlabels))
        coord = (
            f"{sts_name}-0.{sts_name}-hosts."
            f"{dep.namespace}.svc.cluster.local:{COORDINATOR_PORT}"
        )
        tmpl["spec"]["containers"][0]["env"].append(
            {"name": ENV_COORDINATOR, "value": coord}
        )
        out.append(
            {
                "apiVersion": "apps/v1",
                "kind": "StatefulSet",
                "metadata": {
                    "name": sts_name,
                    "namespace": dep.namespace,
                    "labels": rlabels,
                },
                "spec": {
                    "replicas": hosts,
                    "serviceName": f"{sts_name}-hosts",
                    "podManagementPolicy": "Parallel",
                    "selector": {"matchLabels": rlabels},
                    "template": tmpl,
                },
            }
        )
        out.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {
                    "name": f"{sts_name}-hosts",
                    "namespace": dep.namespace,
                    "labels": rlabels,
                },
                "spec": {
                    "clusterIP": "None",
                    "selector": rlabels,
                    "ports": [{"port": ENGINE_PORT, "name": "http"}],
                },
            }
        )
    return out


def _distributed_predictor(
    dep: SeldonDeployment, p: PredictorSpec, chips: int
) -> list[dict]:
    """Reference-style layout: engine Deployment + one Deployment/Service per
    graph component (``createResources:580-735``)."""
    out: list[dict] = []
    engine_container = {
        "name": "engine",
        "image": engine_image(),
        "args": ["serve"],
        "env": _engine_env(dep, p),
        "ports": [{"containerPort": ENGINE_PORT}],
        **_probes(),
    }
    engine_pod_spec: dict[str, Any] = {"containers": [engine_container]}
    # the engine instantiates LOCAL/implementation nodes itself — their
    # remote artifacts materialize on the engine pod
    _model_init(engine_pod_spec, engine_container,
                _remote_model_uris(p, local_only=True))
    engine = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{dep.name}-{p.name}-engine",
            "namespace": dep.namespace,
            "labels": _engine_labels(dep, p),
        },
        "spec": {
            "replicas": p.replicas,
            "selector": {"matchLabels": _engine_labels(dep, p)},
            "template": {
                "metadata": {"labels": _engine_labels(dep, p)},
                "spec": engine_pod_spec,
            },
        },
    }
    out.append(engine)
    containers = {
        c["name"]: c
        for cs in p.component_specs
        for c in (cs.get("spec", {}) or {}).get("containers", []) or []
    }
    unit_uris = _remote_model_uris(p)  # depends only on p: walk once
    for unit in p.graph.walk():
        if unit.implementation or unit.endpoint.type == "LOCAL":
            continue
        name = service_name(dep, p, unit.name)
        container = containers.get(
            unit.name,
            {"name": unit.name, "image": engine_image(), "args": ["component"]},
        ).copy()
        # this pod's own remote artifact (if any): initContainer + rewrite
        # of the parameter the component container sees
        my_uri = [(n, u) for n, u in unit_uris if n == unit.name]
        unit_params = dict(unit.parameters)
        if my_uri:
            unit_params["model_uri"] = f"{MODEL_MOUNT}/{unit.name}"
        container.setdefault("env", []).extend(
            [
                {"name": "PREDICTIVE_UNIT_SERVICE_PORT",
                 "value": str(unit.endpoint.service_port)},
                {"name": "PREDICTIVE_UNIT_PARAMETERS",
                 "value": json.dumps(
                     [{"name": k, "value": str(v)} for k, v in
                      unit_params.items()])},
                {"name": "PREDICTIVE_UNIT_ID", "value": unit.name},
                {"name": "PREDICTOR_ID", "value": p.name},
                {"name": "SELDON_DEPLOYMENT_ID", "value": dep.name},
                # runtime service-type refinement beyond the CRD node type
                # (reference s2i SERVICE_TYPE env; e.g. OUTLIER_DETECTOR
                # behind a TRANSFORMER node) — the microservice CLI reads
                # this env, mirroring operator/local.py resolve_component
                {"name": "SERVICE_TYPE",
                 "value": str(unit.parameters.get("service_type",
                                                  unit.resolved_type))},
            ]
        )
        labels = {**_common_labels(dep, p), "seldon-app": name}
        comp_pod_spec: dict[str, Any] = {"containers": [container]}
        _model_init(comp_pod_spec, container, my_uri)
        out.append(
            {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "metadata": {"name": name, "namespace": dep.namespace,
                             "labels": labels},
                "spec": {
                    "replicas": p.replicas,
                    "selector": {"matchLabels": labels},
                    "template": {
                        "metadata": {"labels": labels},
                        "spec": comp_pod_spec,
                    },
                },
            }
        )
        out.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {"name": name, "namespace": dep.namespace,
                             "labels": labels},
                "spec": {
                    "selector": labels,
                    "ports": [
                        {"port": unit.endpoint.service_port,
                         "targetPort": unit.endpoint.service_port}
                    ],
                },
            }
        )
    return out


def _deployment_service(dep: SeldonDeployment) -> dict:
    """Deployment-wide Service fronting all predictors (traffic split by
    replica ratio, reference ``:738-764``) + Ambassador-style annotation."""
    labels = {"seldon-deployment-id": dep.name}
    # select only engine pods — component pods share the deployment-id label
    # but must not receive north-bound traffic
    selector = {**labels, "seldon-role": "engine"}
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": dep.name,
            "namespace": dep.namespace,
            "labels": labels,
            "annotations": {
                "getambassador.io/config": json.dumps(
                    {
                        "apiVersion": "ambassador/v1",
                        "kind": "Mapping",
                        "name": f"seldon_{dep.name}",
                        "prefix": f"/seldon/{dep.name}/",
                        "service": f"{dep.name}.{dep.namespace}:{ENGINE_PORT}",
                    }
                )
            },
        },
        "spec": {
            "selector": selector,
            "ports": [
                {"port": ENGINE_PORT, "targetPort": ENGINE_PORT, "name": "http"},
                {"port": GRPC_PORT, "targetPort": GRPC_PORT, "name": "grpc"},
            ] + ([
                {"port": NATIVE_PORT, "targetPort": NATIVE_PORT,
                 "name": "http-native"},
                {"port": NATIVE_GRPC_PORT, "targetPort": NATIVE_GRPC_PORT,
                 "name": "grpc-native"},
            ] if any(_native_wire(dep, p) for p in dep.predictors) else []),
        },
    }
