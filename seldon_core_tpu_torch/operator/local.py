"""Local runner: boot a SeldonDeployment's graph in process and serve it
(port of the walk path of ``seldon_core_tpu/operator/local.py``).

    python -m seldon_core_tpu_torch.operator.local \\
        --graph seldon_core_tpu_torch/examples/iris.json --port 8000 \\
        [--grpc-port 5000] [--native-port 8001] [--native-grpc-port 8002] \\
        [--workers N] [--device cpu]

Every predictor of the deployment runs on a :class:`GraphEngine` of its
own (:class:`LocalPredictor`: its engine, QoS, batchers, plan and cache),
and :meth:`LocalDeployment.pick` splits the traffic among them in
proportion to ``replicas`` x ``traffic``, drawing from
``random.Random(seed)`` as the reference does (the same seed picks the same
predictor sequence).  ``predict`` and ``stream`` go through ``pick``;
feedback goes to every predictor.  Every tier below serves the
deployment, never one engine.  Built-in
nodes (``implementation``) are the engine's; every other node names its
class with the ``model_class`` parameter (``pkg.module:Class``), built from
the node's other typed parameters and ``device``.  A ``service_type``
parameter refines the node's type (an OUTLIER_DETECTOR behind a TRANSFORMER
node).  A MODEL node is wrapped in the dynamic batcher unless the
``seldon.io/batching`` annotation is ``"false"``, with the knobs of
``seldon.io/batch-{max-size, max-delay-ms, shed-after-ms, max-inflight,
materialize, max-queue-rows}``.  On the card, a batched model that states
the shape of one input row (``input_shape``) runs every bucket once at boot,
so each batch shape's first-use costs (cuDNN's choice of algorithm, the
allocator's first blocks) are paid before traffic.

``seldon.io/graph-plan: "fused"`` compiles maximal static subgraphs into
segments (``graph/plan.py``): with batching on, a segment is the batched
callable, with the batcher knobs above, and each batch replays one CUDA
graph per shape bucket on the card.  ``seldon.io/graph-plan-warmup:
"true"`` captures every bucket of every segment at boot; without it a
bucket is captured the first time it is seen.  ``seldon.io/prediction-
cache: "true"`` (``-bytes``, ``-ttl-ms``) puts the prediction cache in
front of the deterministic pure subtrees (walk) or segments (fused), keyed
with ``seldon.io/spec-hash``.

A node with an ``endpoint`` (``service_host``, ``service_port``, type
``REST`` or ``GRPC``) and no ``model_class`` is a remote component: a
:class:`~seldon_core_tpu_torch.serving.client.RemoteComponent` (with the
``seldon.io/rest-read-timeout`` and ``seldon.io/rest-connection-timeout``
annotations, milliseconds) or a
:class:`~seldon_core_tpu_torch.serving.grpc_api.GrpcComponentClient`
(``seldon.io/grpc-read-timeout``) calls it.  A tensor crosses a REST hop in
the encoding the request arrived with.

``seldon.io/artifact-store`` (or ``SELDON_ARTIFACT_STORE``) with a fused
plan turns on the artifact plane (``artifacts/``): the kernel library
loads from the store when it holds it (else it is built and published),
every stored bucket is captured at boot, held to its probe digest, and
``seldon.io/artifact-precompile`` (default true) warms every derivable
bucket at boot; ``/admin/artifacts`` reports it.
``seldon.io/mesh`` (``"dp=2"``, ``"tp=2"``, ``"dp=2,tp=2"``) turns on
the placement plane (``placement/``) on the predictor's device kind: the
mesh (repeats of the CPU with ``--device cpu``, distinct cards on the
card, where a mesh wider than the visible cards disables the plane with a
warning), the segment-to-device plan, the sharded executor on fused
segments; ``/admin/placement`` and ``status.placement`` report it.
``seldon.io/device-plane: "true"`` (``-remote``: auto, loopback, shm,
off) turns on the device plane (``runtime/device_plane.py``): remote REST
nodes negotiate ``deviceRef`` per peer, meta-only routers route without
the tensor, cache entries stay on the card; orphaned shm segments of dead
producers are reaped at boot.

Observability, one plane of each per predictor: ``seldon.io/tracing:
"true"`` (env ``SELDON_TRACING``; ``seldon.io/trace-sample``,
``-slow-ms``, ``-export`` an OTLP JSON-lines file, ``seldon.io/tracing-
max``) gives the engine a tracer, read at ``GET /trace``;
``seldon.io/health: "true"`` or ``seldon.io/slo-availability`` the health
plane (``/admin/introspect``, ``/admin/flightrecorder``,
``/admin/health``; its sampler probes device memory, the engine's
segments, batchers, cache, QoS, the device-tensor registry and the device
and artifact planes); ``seldon.io/profile: "true"`` the profiling plane
(``/admin/profile*``: host stacks, capture windows with a
``torch.profiler`` device trace, the capture ledger, capacity), whose
capture storms degrade the health verdict.  A bad value is refused when
the deployment loads (``graph/spec.py``).

QoS (``qos/``): ``seldon.io/slo-p95-ms`` turns on admission control,
``seldon.io/qos-fallback`` names the subgraph that serves while a breaker
is open or shedding passes ``seldon.io/qos-degrade-shed-level``, and every
remote node gets a circuit breaker (``seldon.io/qos-breaker``,
``-min-calls``, ``-open-ms``, ``-slow-ms``) once QoS is on.
``seldon.io/engine-walk-timeout-ms`` bounds every walk (504).

Tiers: REST on ``--port`` (``/metrics`` renders the deployment's
:class:`EngineMetrics`), the ``Seldon`` gRPC service on ``--grpc-port``
(env ``ENGINE_SERVER_GRPC_PORT``, 5000 by default as the reference's; 0
turns it off), the native (C++ epoll) REST tier on ``--native-port`` and
the native h2c gRPC tier on ``--native-grpc-port``; each port, and
``--workers``, defaults from the env the operator compiles into an engine
pod (``ENGINE_SERVER_PORT``, ``ENGINE_NATIVE_PORT``,
``ENGINE_NATIVE_GRPC_PORT``, ``ENGINE_WORKERS``).  Without ``--graph`` the
engine serves the predictor in ``ENGINE_PREDICTOR`` (base64 JSON) as
deployment ``SELDON_DEPLOYMENT_ID``; ``--max-lifetime-s`` (env
``ENGINE_MAX_LIFETIME_S``) stops it after that long.  ``--workers N`` forks
N worker processes before anything touches the card, each with its own
engine, all binding the same ports with ``SO_REUSEPORT``; the first worker
to exit stops the group.

:class:`LocalFleet` runs N replicas of one deployment in this process,
each a :class:`LocalDeployment` behind its own REST port (``urls()`` for a
gateway's replica pool), with ``kill``, ``add_replica``,
``remove_replica`` and ``autoscale_tick``; every replica answers
``/admin/fleet`` and ``/admin/fleet/*`` over the whole set.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import random
import signal
import sys
from typing import Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.graph.engine import GraphEngine, routes_on_meta
from seldon_core_tpu_torch.graph.spec import (
    Deployment,
    PredictiveUnit,
    Predictor,
    artifact_config,
    device_plane_config,
    graph_plan_mode,
    health_config,
    load_deployment,
    placement_config,
    prediction_cache_config,
    profile_config,
    trace_config,
)
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
from seldon_core_tpu_torch.qos.policy import EngineQos, qos_from_annotations
from seldon_core_tpu_torch.qos.registry import publish
from seldon_core_tpu_torch.runtime.batcher import BatchedModel, BatcherConfig
from seldon_core_tpu_torch.runtime.component import load_component
from seldon_core_tpu_torch.utils.metrics import EngineMetrics, MetricsRegistry

logger = logging.getLogger(__name__)

#: how long a killed or drained replica lets its requests in hand finish
KILL_DRAIN_S = 30.0

__all__ = ["resolve_component", "qos_config", "LocalPredictor",
           "LocalDeployment", "LocalFleet", "load_deployment_file", "serve",
           "build_parser", "engine_main"]


def _batching_enabled(ann: dict) -> bool:
    return ann.get("seldon.io/batching", "true").lower() != "false"


def _batcher_config(ann: dict) -> BatcherConfig:
    cfg = BatcherConfig(
        max_batch_size=int(ann.get("seldon.io/batch-max-size", "64")),
        max_delay_ms=float(ann.get("seldon.io/batch-max-delay-ms", "2.0")),
        shed_after_ms=float(ann.get("seldon.io/batch-shed-after-ms", "0")),
        max_inflight=int(ann.get("seldon.io/batch-max-inflight", "4")),
        materialize=ann.get("seldon.io/batch-materialize", "host"),
    )
    if "seldon.io/batch-max-queue-rows" in ann:
        cfg.max_queue_rows = int(ann["seldon.io/batch-max-queue-rows"])
    return cfg


def _timeout_s(ann: dict, key: str, default):
    """The reference's timeout annotations carry milliseconds; the clients
    take seconds."""
    raw = ann.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    return float(raw) / 1000.0


def _remote(unit: PredictiveUnit, ann: dict, qos=None, device_plane=None):
    """The client of a node served by another process, behind a circuit
    breaker when QoS is on.  A REST node's ``/route`` calls carry no
    tensor when its signature routes on meta (``routes_on_meta``), and
    ``device_plane`` turns on its per-peer ``deviceRef`` fast path."""
    if unit.endpoint.type == "GRPC":
        from seldon_core_tpu_torch.serving.grpc_api import GrpcComponentClient

        client = GrpcComponentClient(
            f"{unit.endpoint.service_host}:"
            f"{unit.endpoint.service_port or 5000}",
            methods=unit.methods, name=unit.name,
            timeout_s=_timeout_s(ann, "seldon.io/grpc-read-timeout", 30.0))
    else:
        from seldon_core_tpu_torch.serving.client import RemoteComponent

        client = RemoteComponent(
            f"http://{unit.endpoint.service_host}:"
            f"{unit.endpoint.service_port or 8000}",
            name=unit.name, methods=unit.methods,
            timeout_s=_timeout_s(ann, "seldon.io/rest-read-timeout", 30.0),
            connect_timeout_s=_timeout_s(
                ann, "seldon.io/rest-connection-timeout", None),
            route_meta_only=routes_on_meta(unit), device_plane=device_plane)
    if qos is not None and qos.config.breakers_enabled:
        from seldon_core_tpu_torch.qos.breaker import BreakerWrapper

        return BreakerWrapper(client, qos.make_breaker(unit.name),
                              name=unit.name)
    return client


def resolve_component(unit: PredictiveUnit, annotations: dict, device: str,
                      qos: Optional[EngineQos] = None, metrics=None,
                      device_plane=None):
    """The implementation of one non-built-in node; ``metrics`` (a
    ``MetricsRegistry``) receives the batcher's series."""
    model_class = unit.parameters.get("model_class")
    if not model_class:
        if unit.endpoint.service_host and unit.endpoint.type != "LOCAL":
            return _remote(unit, annotations, qos, device_plane)
        raise ValueError(
            f"node {unit.name!r}: no implementation, model_class, or "
            "endpoint")
    params = {k: v for k, v in unit.parameters.items()
              if k not in ("model_class", "service_type")}
    handle = load_component(
        model_class, params,
        service_type=unit.parameters.get("service_type", unit.resolved_type),
        device=device)
    handle.name = unit.name
    if unit.resolved_type == "MODEL" and _batching_enabled(annotations):
        return BatchedModel(handle, _batcher_config(annotations),
                            metrics=metrics)
    return handle


def qos_config(dep: Deployment, pred: Optional[Predictor] = None):
    """A predictor's QoS annotations (the first predictor's by default) as
    a ``QosConfig`` (None when QoS is off); a fallback node must be in the
    graph and not its root (``ValueError``)."""
    pred = pred or dep.predictors[0]
    cfg = qos_from_annotations(pred.annotations, f"{dep.name}/{pred.name}")
    if cfg is not None and cfg.fallback_node:
        names = [u.name for u in pred.graph.walk()]
        if cfg.fallback_node not in names:
            raise ValueError(
                f"annotation seldon.io/qos-fallback names node "
                f"{cfg.fallback_node!r} which is not in predictor "
                f"{pred.name!r}'s graph (nodes: {names})")
        if cfg.fallback_node == names[0]:
            raise ValueError(
                f"annotation seldon.io/qos-fallback names the graph root "
                f"{cfg.fallback_node!r}: falling back to the primary is not "
                "a degraded mode")
    return cfg


def _tracer_from_config(ann: dict, name: str):
    """The engine's tracer when ``seldon.io/tracing`` (or env
    ``SELDON_TRACING``) turns tracing on, else None: the head-sampling rate
    from ``seldon.io/trace-sample``, an OTLP JSON-lines sink at
    ``seldon.io/trace-export``, the tail buffer's slow bar from
    ``seldon.io/trace-slow-ms``, the ring from ``seldon.io/tracing-max``
    (values checked when the deployment loaded)."""
    from seldon_core_tpu_torch.utils.tracing import (
        FileSpanSink,
        SpanCollector,
        Tracer,
    )

    cfg = trace_config(ann, name)
    if not cfg.enabled:
        return None
    sink = FileSpanSink(cfg.export_path) if cfg.export_path else None
    return Tracer(max_traces=cfg.max_traces, sample_rate=cfg.sample_rate,
                  collector=SpanCollector(service="engine",
                                          slow_ms=cfg.slow_ms, sink=sink))


def _placement_capacity(ann: dict, n_devices: int) -> Optional[int]:
    """Per-device memory capacity in bytes: the GL3xx budget
    (``seldon.io/tpu-hbm-gb``, else chips x the card's memory) split across
    the mesh.  None when no budget is declared: the planner then reports
    loads without an over-capacity verdict."""
    from seldon_core_tpu_torch.analysis.graphlint import (
        CHIPS_ANNOTATION,
        HBM_BUDGET_ANNOTATION,
        HBM_PER_CHIP_GB,
    )

    def _num(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    budget_gb = _num(ann.get(HBM_BUDGET_ANNOTATION))
    if budget_gb is None:
        chips = _num(ann.get(CHIPS_ANNOTATION))
        if not chips or chips <= 0:
            return None
        budget_gb = chips * HBM_PER_CHIP_GB
    if budget_gb <= 0:
        return None
    return int(budget_gb * (1 << 30) / max(1, n_devices))


class LocalPredictor:
    """One predictor's live graph: its engine with its own QoS, batchers,
    plan, cache and observability planes (``metrics`` is the
    deployment's, shared)."""

    def __init__(self, dep: Deployment, pred: Predictor, device: str,
                 metrics: EngineMetrics, component_wrap=None):
        """``component_wrap(handle)`` decorates every resolved node (a
        fleet harness slowing one replica's components, say)."""
        ann = pred.annotations
        wrap = component_wrap or (lambda handle: handle)
        self.spec = pred
        self.metrics = metrics
        plan_mode = graph_plan_mode(ann)
        # a fused segment is the batched callable: one call serves a
        # cross-request batch through every fused node
        plan_batcher = (_batcher_config(ann)
                        if plan_mode == "fused" and _batching_enabled(ann)
                        else None)
        cache_cfg = prediction_cache_config(ann, f"{dep.name}/{pred.name}")
        self.cache = None
        if cache_cfg is not None:
            from seldon_core_tpu_torch.caching import PredictionCache

            self.cache = PredictionCache(cache_cfg,
                                         metrics=metrics.registry)
        cfg = qos_config(dep, pred)
        self.qos = None if cfg is None else EngineQos(
            cfg, metrics=metrics.registry)
        where = f"{dep.name}/{pred.name}"
        self.device = device
        health_cfg = health_config(ann, where)
        self.health = None
        if health_cfg.enabled:
            from seldon_core_tpu_torch.health import HealthPlane

            self.health = HealthPlane(health_cfg, metrics=metrics.registry,
                                      service="engine", deployment=dep.name)
            self.health.qos = self.qos
        profile_cfg = profile_config(ann, where)
        self.profiler = None
        if profile_cfg.enabled:
            from seldon_core_tpu_torch.profiling import ProfilePlane

            self.profiler = ProfilePlane(profile_cfg,
                                         metrics=metrics.registry,
                                         service="engine",
                                         deployment=dep.name)
            if self.health is not None:
                # a capture storm degrades the health verdict
                self.health.profiler = self.profiler
        # the placement plane: the mesh of seldon.io/mesh on the
        # predictor's device kind, the segment-to-device plan, the sharded
        # executor on shardable fused segments.  A mesh this host cannot
        # build (admission checks GL1202 against the admission host's
        # devices) disables the plane with a warning: single-device serving
        self.placement = None
        placement_cfg = placement_config(ann, where)
        if placement_cfg.enabled:
            from seldon_core_tpu_torch.parallel.mesh import MeshPlanError
            from seldon_core_tpu_torch.placement import PlacementPlane

            try:
                self.placement = PlacementPlane(
                    placement_cfg, metrics=metrics.registry,
                    deployment=dep.name, device=device,
                    capacity_bytes=_placement_capacity(
                        ann, placement_cfg.n_devices))
            except (MeshPlanError, ValueError) as e:
                logger.warning(
                    "placement plane disabled (mesh unavailable): %s", e)
        art_cfg = artifact_config(ann, where)
        self.artifacts = None
        if art_cfg is not None and art_cfg.enabled and plan_mode == "fused":
            from seldon_core_tpu_torch.artifacts import ArtifactPlane
            from seldon_core_tpu_torch.ops import _build

            self.artifacts = ArtifactPlane(art_cfg, metrics=metrics.registry,
                                           deployment=dep.name)
            # before any component launches a kernel
            _build.attach_artifacts(self.artifacts)
        dp_cfg = device_plane_config(ann, where)
        self.device_plane = None
        if dp_cfg is not None and dp_cfg.enabled:
            from seldon_core_tpu_torch.runtime.device_plane import DevicePlane
            from seldon_core_tpu_torch.runtime.device_registry import (
                registry,
            )

            self.device_plane = DevicePlane(dp_cfg, metrics=metrics.registry)
            registry.device = torch.device(device)
            registry.attach_metrics(metrics.registry)
            # a crashed producer's segments must not outlive a restart
            registry.reap_orphan_shm()
        self.engine = GraphEngine(
            pred.graph, name=pred.name, metrics_sink=metrics, qos=self.qos,
            walk_timeout_s=_timeout_s(ann, "seldon.io/engine-walk-timeout-ms",
                                      None),
            plan_mode=plan_mode, plan_batcher=plan_batcher, cache=self.cache,
            cache_version=str(ann.get("seldon.io/spec-hash", "")),
            artifacts=self.artifacts, device_plane=self.device_plane,
            tracer=_tracer_from_config(ann, where), health=self.health,
            profiler=self.profiler, placement=self.placement,
            resolver=lambda u: wrap(resolve_component(
                u, ann, device, qos=self.qos, metrics=metrics.registry,
                device_plane=self.device_plane)))
        plan = self.engine.plan
        if plan is None:
            self.artifacts = None  # nothing fused: nothing to store
        # on the card, every batched model outside the segments (all of
        # them on the walk) runs each bucket once, if it states its row
        # shape; the segments capture theirs on request or below
        fused = {s.name for seg in (plan.segments if plan else ())
                 for s in seg.members}
        for unit in pred.graph.walk():
            impl = self.engine.node_impl(unit.name)
            if unit.name not in fused and isinstance(impl, BatchedModel):
                shape = getattr(impl.handle.user, "input_shape", None)
                if shape is not None and impl.handle.device.type == "cuda":
                    impl.warmup(np.zeros(shape, np.float32))
        # an artifact plane with precompile on warms every derivable bucket
        # at boot; buckets captured from the store are skipped
        if plan is not None and (ann.get(
                "seldon.io/graph-plan-warmup", "").lower() in ("1", "true",
                                                               "yes")
                or (self.artifacts is not None and art_cfg.precompile)):
            plan.warmup()
        if self.health is not None:
            self._wire_health_probes()

    def _wire_health_probes(self) -> None:
        """Point the introspection sampler at this predictor's runtime
        objects: device memory, the engine's segments, the batchers, the
        cache, admission, the device-tensor registry and the device,
        artifact, placement and profiling planes."""
        from seldon_core_tpu_torch.health import (
            batcher_probe,
            cache_probe,
            device_memory_probe,
            device_registry_probe,
            engine_probe,
            placement_probe,
            profile_probe,
            qos_probe,
        )
        from seldon_core_tpu_torch.runtime.device_registry import registry

        registry.attach_metrics(self.metrics.registry)
        sampler = self.health.sampler
        sampler.add_probe("device", device_memory_probe(self.device))
        sampler.add_probe("device_registry", device_registry_probe())
        sampler.add_probe("engine", engine_probe(self.engine))
        if self.cache is not None:
            sampler.add_probe("cache", cache_probe(self.cache))
        if self.qos is not None:
            sampler.add_probe("qos", qos_probe(self.qos))
        if self.profiler is not None:
            sampler.add_probe("profile", profile_probe(self.profiler))
        if self.placement is not None:
            sampler.add_probe("placement", placement_probe(
                self.placement, metrics=self.metrics.registry))
        if self.artifacts is not None:
            sampler.add_probe("artifacts", self.artifacts.probe())
        if self.device_plane is not None:
            from seldon_core_tpu_torch.runtime.device_plane import (
                device_plane_probe,
            )

            sampler.add_probe("device_plane",
                              device_plane_probe(self.device_plane))
        plan = self.engine.plan
        if plan is not None:
            for seg in plan.segments:
                if seg.batcher is not None:
                    sampler.add_probe(f"batcher:{seg.label}",
                                      batcher_probe(seg.batcher))
        else:
            for name, node in self.engine._nodes.items():
                if isinstance(node.impl, BatchedModel):
                    sampler.add_probe(f"batcher:{name}",
                                      batcher_probe(node.impl._batcher))

    async def aclose(self) -> None:
        """Stop the planes' samplers (the health sampler's task, the host
        profiler's thread)."""
        if self.health is not None:
            await self.health.aclose()
        if self.profiler is not None:
            await self.profiler.aclose()


class LocalDeployment:
    """Every predictor of a SeldonDeployment, with the reference's
    replica x traffic split.  ``engine`` is the first predictor's, for
    callers that read it."""

    def __init__(self, dep: Deployment, device: Optional[str] = None,
                 seed: Optional[int] = None, publish_status: bool = True,
                 component_wrap=None):
        """``publish_status`` False leaves the process registries alone (a
        fleet's replicas publish one replica-keyed snapshot through their
        :class:`LocalFleet` instead)."""
        dev = str(resolve_device(device))
        self.spec = dep
        #: the fleet harness this replica belongs to (``/admin/fleet`` on
        #: the engine answers with its replica set), else None
        self.fleet = None
        self.metrics = EngineMetrics(MetricsRegistry(), deployment=dep.name)
        self.predictors = [LocalPredictor(dep, p, dev, self.metrics,
                                          component_wrap=component_wrap)
                           for p in dep.predictors]
        self.engine = self.predictors[0].engine
        self.qos = self.predictors[0].qos
        if publish_status and any(p.artifacts is not None
                                  for p in self.predictors):
            from seldon_core_tpu_torch.artifacts import publish as art_publish

            def _art_snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.artifacts.snapshot()}
                    for p in preds if p.artifacts is not None]}

            art_publish(dep.name, _art_snapshot)
        if publish_status and any(p.qos is not None for p in self.predictors):
            def _snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.qos.snapshot()}
                    for p in preds if p.qos is not None]}

            publish(dep.name, _snapshot)
        if publish_status and any(p.health is not None
                                  for p in self.predictors):
            from seldon_core_tpu_torch.health import publish as health_publish

            def _health_snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.health.snapshot()}
                    for p in preds if p.health is not None]}

            health_publish(dep.name, _health_snapshot)
        if publish_status and any(p.placement is not None
                                  for p in self.predictors):
            from seldon_core_tpu_torch.placement import (
                publish as placement_publish,
            )

            def _placement_snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.placement.snapshot()}
                    for p in preds if p.placement is not None]}

            placement_publish(dep.name, _placement_snapshot)
        self._rng = random.Random(seed)
        weights = [max(p.spec.replicas, 0) * max(p.spec.traffic, 0)
                   for p in self.predictors]
        total = sum(weights) or len(weights)
        self._weights = [w / total if total else 1 / len(weights)
                         for w in weights]

    @property
    def artifacts(self):
        """The first predictor's artifact plane that is on (what
        ``/admin/artifacts`` reads), or None."""
        for p in self.predictors:
            if p.artifacts is not None:
                return p.artifacts
        return None

    @property
    def placement(self):
        """The first predictor's placement plane that is on (what
        ``/admin/placement`` reads), or None."""
        for p in self.predictors:
            if p.placement is not None:
                return p.placement
        return None

    @property
    def device_plane(self):
        """The first predictor's device plane that is on, or None."""
        for p in self.predictors:
            if p.device_plane is not None:
                return p.device_plane
        return None

    @property
    def tracer(self):
        """The first traced predictor's tracer (what ``/trace`` reads)."""
        from seldon_core_tpu_torch.utils.tracing import NULL_TRACER

        for p in self.predictors:
            if p.engine.tracer is not NULL_TRACER:
                return p.engine.tracer
        return NULL_TRACER

    @property
    def health(self):
        """The first predictor's health plane that is on (what
        ``/admin/introspect``, ``/admin/flightrecorder`` and
        ``/admin/health`` read), or None."""
        for p in self.predictors:
            if p.health is not None:
                return p.health
        return None

    @property
    def profiler(self):
        """The first predictor's profiling plane that is on (what
        ``/admin/profile*`` reads), or None."""
        for p in self.predictors:
            if p.profiler is not None:
                return p.profiler
        return None

    @property
    def replica(self) -> str:
        return self.engine.replica

    def set_replica(self, rid: str) -> None:
        """Stamp replica identity on every per-replica surface: engine
        span attributes and response meta, flight records, exemplars and
        the ``X-Seldon-Replica`` answer header."""
        self.metrics.registry.exemplar_labels["replica"] = rid
        for p in self.predictors:
            p.engine.replica = rid
            if p.health is not None:
                p.health.recorder.replica = rid

    async def aclose(self) -> None:
        """Stop every predictor's plane samplers."""
        for p in self.predictors:
            await p.aclose()

    def pick(self) -> LocalPredictor:
        """The predictor of the next request (reference
        ``operator/local.py`` ``pick``, draw for draw)."""
        if len(self.predictors) == 1:
            return self.predictors[0]
        r = self._rng.random()
        acc = 0.0
        for p, w in zip(self.predictors, self._weights):
            acc += w
            if r <= acc:
                return p
        return self.predictors[-1]

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self.pick().engine.predict(msg)

    def stream(self, msg: SeldonMessage):
        """One predictor is picked per stream, weighted as predictions."""
        return self.pick().engine.stream(msg)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        # every predictor replays its own routing
        out = None
        for p in self.predictors:
            out = await p.engine.send_feedback(fb)
        return out


class LocalFleet:
    """N in-process engine replicas of ONE deployment behind real HTTP —
    the analog of ``replicas: N`` pods (reference ``operator/local.py``
    ``LocalFleet``).

    Each replica is its own :class:`LocalDeployment` (own metrics
    registry, own planes) served by a :class:`RestServer` on an ephemeral
    port; a gateway routes over :meth:`urls` through its ReplicaPool.
    Registry publishes are aggregated HERE, keyed by replica id, so the
    process registries' ``qos``/``health``/``artifacts`` snapshots stay
    truthful at N>1.  With ``seldon.io/artifact-store`` set, a replica
    added later (:meth:`add_replica`, :meth:`autoscale_tick`) captures its
    buckets at boot from the store the first replicas published, and its
    membership entry records the store's coverage.  ``autoscale_tick``
    closes the loop: demand/capacity/burn signals → Autoscaler decision →
    replicas added or drained.
    """

    def __init__(self, dep, replicas: Optional[int] = None,
                 seed: Optional[int] = None, component_wrap=None,
                 host: str = "127.0.0.1", device: Optional[str] = None):
        """``dep`` is a ``Deployment`` or what ``load_deployment`` reads;
        ``component_wrap(index, handle)`` decorates replica ``index``'s
        nodes."""
        import dataclasses

        from seldon_core_tpu_torch.fleet import (
            Autoscaler,
            FleetConfig,
            FleetObserver,
            fleet_config_from_annotations,
            observe_config_from_annotations,
        )

        if not isinstance(dep, Deployment):
            dep = load_deployment(dep)
        self.spec = dep
        merged = dict(dep.annotations)
        try:
            cfg = fleet_config_from_annotations(merged, dep.name)
        except ValueError as e:
            logger.warning("deployment %s: %s — fleet defaults in effect",
                           dep.name, e)
            cfg = None
        if cfg is None or not cfg.enabled:
            n = replicas or 1
            cfg = FleetConfig(enabled=True, replicas=n, max_replicas=max(n, 1))
        if replicas is not None and replicas != cfg.replicas:
            cfg = dataclasses.replace(
                cfg, replicas=replicas,
                min_replicas=min(cfg.min_replicas, replicas),
                max_replicas=max(cfg.max_replicas, replicas),
            )
        self.config = cfg
        self.autoscaler = Autoscaler(cfg)
        # the engine-side /admin/fleet/* aggregation endpoints scrape the
        # replica set through this observer
        try:
            obs_cfg = observe_config_from_annotations(merged, dep.name)
        except ValueError as e:
            logger.warning("deployment %s: %s — fleet-obs defaults in "
                           "effect", dep.name, e)
            obs_cfg = None
        self.observer = FleetObserver(obs_cfg)
        self._obs_session = None
        self.last_decision = None
        self._seed = seed
        self._component_wrap = component_wrap
        self._host = host
        self._device = device
        self._replicas: list = []
        self._seq = 0

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> "LocalFleet":
        for _ in range(self.config.replicas):
            await self.add_replica()
        return self

    async def stop(self) -> None:
        for rep in self._replicas:
            if not rep["killed"]:
                try:
                    await rep["server"].stop()
                except Exception:
                    pass
            await rep["local"].aclose()
        # shutdown path, called once after traffic drains — no concurrent
        # coroutine mutates the replica list here
        self._replicas.clear()  # graphlint: disable=RL602
        if self._obs_session is not None:
            await self._obs_session.close()
            self._obs_session = None
        self._unpublish()

    def obs_session(self):
        """The ``HttpSession`` of the observability scrapes (shared
        across scrapes; closed in stop())."""
        from seldon_core_tpu_torch.serving.client import HttpSession

        if self._obs_session is None:
            self._obs_session = HttpSession()
        return self._obs_session

    async def add_replica(self) -> dict:
        """Boot one more in-process replica (autoscale up / initial
        boot): a fresh LocalDeployment and REST server on an ephemeral
        port, registered into membership and the aggregated publish."""
        from seldon_core_tpu_torch.serving.rest import RestServer

        idx = self._seq
        self._seq += 1
        wrap = None
        if self._component_wrap is not None:
            cw = self._component_wrap

            def wrap(handle, _i=idx):
                return cw(_i, handle)

        local = LocalDeployment(self.spec, device=self._device,
                                seed=self._seed, publish_status=False,
                                component_wrap=wrap)
        local.fleet = self
        local.set_replica(f"r{idx}")
        # warm-artifact admission: the replica's captures from the store
        # (and the precompile warm-up) ran inside the LocalDeployment
        # build above, so its first predict cannot hit a cold capture for
        # any stored bucket; the coverage verdict is kept on the
        # membership entry
        coverage = None
        art = local.artifacts
        if art is not None:
            coverage = art.coverage()
        server = await RestServer(local, host=self._host, port=0,
                                  metrics=local.metrics).start()
        rep = {
            "rid": f"r{idx}",
            "local": local,
            "server": server,
            "url": f"http://{self._host}:{server.port}",
            "killed": False,
        }
        if coverage is not None:
            rep["artifact_coverage"] = coverage
        self._replicas.append(rep)
        self._publish()
        return rep

    async def remove_replica(self) -> Optional[dict]:
        """Drain the newest replica (autoscale down); never drops below
        one live replica."""
        live = [r for r in self._replicas if not r["killed"]]
        if len(live) <= 1:
            return None
        rep = live[-1]
        self._replicas.remove(rep)
        try:
            await rep["server"].stop(drain_s=KILL_DRAIN_S)
        except Exception:
            pass
        await rep["local"].aclose()
        self._publish()
        return rep

    async def kill(self, idx: int) -> dict:
        """Chaos: stop replica ``idx``'s server WITHOUT removing it from
        membership — connections now refuse, exactly like a crashed pod
        whose endpoint has not yet been reconciled away (requests in hand
        finish first, as aiohttp's shutdown lets them).  The gateway's
        retry-next-replica + pool ejection must absorb it."""
        rep = self._replicas[idx]
        if not rep["killed"]:
            await rep["server"].stop(drain_s=KILL_DRAIN_S)
            rep["killed"] = True
        return rep

    # -- membership / routing ------------------------------------------
    def urls(self) -> tuple:
        """Every member URL, killed ones included — membership is the
        operator's view; the pool's health gating ejects the dead."""
        return tuple(rep["url"] for rep in self._replicas)

    def replicas(self) -> list:
        return list(self._replicas)

    def __len__(self) -> int:
        return len(self._replicas)

    # -- status / signals ----------------------------------------------
    def snapshot(self) -> dict:
        """The engine ``/admin/fleet`` posture (and the fleet registry's)."""
        return {
            "deployment": self.spec.name,
            "policy": self.config.policy,
            "autoscale": self.config.autoscale,
            "desired": len(self._replicas),
            "replicas": [
                {"replica": rep["rid"], "url": rep["url"],
                 "state": "killed" if rep["killed"] else "healthy",
                 **({"artifactCoverage": rep["artifact_coverage"]}
                    if "artifact_coverage" in rep else {})}
                for rep in self._replicas
            ],
            "signals": self._signals(),
        }

    def _signals(self) -> dict:
        """Autoscale inputs: attributed-FLOP demand vs achievable fleet
        capacity (profiling plane's capacity model, summed over live
        replicas) and the worst SLO burn verdict (health plane).  Drills
        pass their own signals to :meth:`autoscale_tick` instead."""
        from seldon_core_tpu_torch.profiling.http import capacity_body

        demand = capacity = 0.0
        have = False
        burn_warn = burn_critical = False
        for rep in self._replicas:
            if rep["killed"]:
                continue
            prof = rep["local"].profiler
            if prof is not None:
                try:
                    status, payload = capacity_body(prof, {})
                except ValueError:
                    status, payload = 0, {}
                if status == 200:
                    demand += float(payload.get("observedRps") or 0.0)
                    capacity += float(payload.get("achievableRps") or 0.0)
                    have = True
            plane = rep["local"].health
            if plane is not None:
                level = plane.verdict().get("level", 0)
                burn_warn = burn_warn or level >= 1
                burn_critical = burn_critical or level >= 2
        out = {"burnWarn": burn_warn, "burnCritical": burn_critical}
        if have:
            out["demandRps"] = round(demand, 3)
            out["capacityRps"] = round(capacity, 3)
        return out

    async def autoscale_tick(self, signals: Optional[dict] = None):
        """One autoscale evaluation: signals → Autoscaler decision →
        replicas added/drained to match.  Returns the decision."""
        sig = signals if signals is not None else self._signals()
        decision = self.autoscaler.decide(
            current=len(self._replicas),
            demand_rps=sig.get("demandRps"),
            capacity_rps=sig.get("capacityRps"),
            burn_critical=bool(sig.get("burnCritical")),
            burn_warn=bool(sig.get("burnWarn")),
        )
        self.last_decision = decision
        if decision.changed:
            from seldon_core_tpu_torch.fleet.observe import record_decision

            record_decision(
                "autoscale", deployment=self.spec.name,
                reason=decision.reason, current=decision.current,
                desired=decision.desired,
            )
        while len(self._replicas) < decision.desired:
            await self.add_replica()
        while len(self._replicas) > decision.desired:
            if await self.remove_replica() is None:
                break
        return decision

    # -- registry publish ----------------------------------------------
    def _plane_status(self, attr: str) -> dict:
        """Replica-keyed plane snapshot: one list entry per (predictor,
        replica) pair, each tagged with its replica id."""
        preds: dict[str, list] = {}
        for rep in self._replicas:
            if rep["killed"]:
                continue
            for p in rep["local"].predictors:
                plane = getattr(p, attr)
                if plane is None:
                    continue
                preds.setdefault(p.spec.name, []).append(
                    {"replica": rep["rid"], **plane.snapshot()}
                )
        return {
            "predictors": [
                {"name": name, "replicas": reps}
                for name, reps in preds.items()
            ]
        }

    def _publish(self) -> None:
        from seldon_core_tpu_torch.artifacts import (
            publish as artifacts_publish,
        )
        from seldon_core_tpu_torch.fleet import publish as fleet_publish
        from seldon_core_tpu_torch.health import publish as health_publish
        from seldon_core_tpu_torch.placement import (
            publish as placement_publish,
        )

        dep = self.spec.name
        fleet_publish(dep, self.snapshot)
        live = [r for r in self._replicas if not r["killed"]]
        if not live:
            return
        sample = live[0]["local"].predictors
        if any(p.qos is not None for p in sample):
            publish(dep, lambda: self._plane_status("qos"))
        if any(p.health is not None for p in sample):
            health_publish(dep, lambda: self._plane_status("health"))
        if any(p.placement is not None for p in sample):
            placement_publish(dep, lambda: self._plane_status("placement"))
        if any(p.artifacts is not None for p in sample):
            artifacts_publish(dep, lambda: self._plane_status("artifacts"))

    def _unpublish(self) -> None:
        from seldon_core_tpu_torch.artifacts import (
            unpublish as artifacts_unpublish,
        )
        from seldon_core_tpu_torch.fleet import unpublish as fleet_unpublish
        from seldon_core_tpu_torch.health import (
            unpublish as health_unpublish,
        )
        from seldon_core_tpu_torch.placement import (
            unpublish as placement_unpublish,
        )
        from seldon_core_tpu_torch.qos.registry import (
            unpublish as qos_unpublish,
        )

        dep = self.spec.name
        fleet_unpublish(dep)
        qos_unpublish(dep)
        health_unpublish(dep)
        placement_unpublish(dep)
        artifacts_unpublish(dep)


def load_deployment_file(path: str) -> Deployment:
    """The deployment in a JSON or YAML file: what :class:`LocalDeployment`
    boots from (``graph.spec.load_deployment`` reads the file)."""
    return load_deployment(path)


async def serve(graph, port: int = 8000, host: str = "0.0.0.0",
                device: Optional[str] = None, reuse_port: bool = False,
                seed: Optional[int] = None):
    """Boot ``graph`` (path, JSON string or dict) and start its REST server;
    returns ``(server, deployment)``.  ``await server.stop()`` ends it.
    ``seed`` seeds the predictor split."""
    from seldon_core_tpu_torch.serving.rest import RestServer

    local = LocalDeployment(load_deployment(graph), device=device, seed=seed)
    server = await RestServer(local, host=host, port=port,
                              metrics=local.metrics,
                              reuse_port=reuse_port).start()
    return server, local


def _say(line: str) -> None:
    """One line to stdout in one write: forked workers share the pipe, and
    ``print`` writes the text and its newline apart when stdout is
    unbuffered (``PYTHONUNBUFFERED``), so two workers' lines could mix."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _env_int(name: str, default: str) -> int:
    return int(os.environ.get(name, default))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.operator.local")
    ap.add_argument("--graph",
                    help="path to a SeldonDeployment JSON; without it the "
                         "predictor comes from the ENGINE_PREDICTOR env "
                         "(base64 JSON, as the operator compiles it)")
    ap.add_argument("--port", type=int,
                    default=_env_int("ENGINE_SERVER_PORT", "8000"))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--grpc-port", type=int,
                    default=_env_int("ENGINE_SERVER_GRPC_PORT", "5000"),
                    help="the Seldon gRPC service's port; 0 disables")
    ap.add_argument("--native-port", type=int,
                    default=_env_int("ENGINE_NATIVE_PORT", "0"),
                    help="native (C++ epoll) REST tier port; 0 disables")
    ap.add_argument("--native-grpc-port", type=int,
                    default=_env_int("ENGINE_NATIVE_GRPC_PORT", "0"),
                    help="native (C++ h2c) gRPC tier port; 0 disables")
    ap.add_argument("--workers", type=int,
                    default=_env_int("ENGINE_WORKERS", "1"),
                    help="worker processes sharing every port "
                         "(SO_REUSEPORT), each with its own engine")
    ap.add_argument("--max-lifetime-s", type=float,
                    default=float(os.environ.get("ENGINE_MAX_LIFETIME_S",
                                                 "0")),
                    help="stop after this many seconds (0 = never)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the split among several predictors")
    return ap


def graph_from_env() -> dict:
    """The deployment an operator-compiled engine pod serves: the
    predictor in ``ENGINE_PREDICTOR`` (base64 JSON) under the name in
    ``SELDON_DEPLOYMENT_ID``.  Exits as the reference engine does when
    the variable is missing."""
    import base64

    raw = os.environ.get("ENGINE_PREDICTOR")
    if not raw:
        raise SystemExit("need --graph or ENGINE_PREDICTOR env")
    pred = json.loads(base64.b64decode(raw))
    return {"spec": {
        "name": os.environ.get("SELDON_DEPLOYMENT_ID", "deployment"),
        "predictors": [pred]}}


def engine_main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    graph = args.graph or graph_from_env()
    reuse = args.workers > 1
    if reuse:
        # before anything touches CUDA, grpc or the native library's threads
        from seldon_core_tpu_torch.serving.workers import fork_workers

        index = fork_workers(args.workers)
        _say(f"worker {index} (pid {os.getpid()})")
    # a multi-host slice's pods join its process group before anything
    # touches the card (the operator's env; nothing single-host)
    from seldon_core_tpu_torch.runtime.multihost import (
        maybe_initialize_distributed,
    )

    maybe_initialize_distributed()

    async def run():
        server, local = await serve(graph, port=args.port,
                                    host=args.host, device=args.device,
                                    reuse_port=reuse, seed=args.seed)
        stoppers = [server]
        if args.grpc_port:
            from seldon_core_tpu_torch.serving.grpc_api import (
                GrpcServer,
                seldon_service_handler,
            )

            gserver = GrpcServer([seldon_service_handler(local)],
                                 port=args.grpc_port, host=args.host,
                                 reuse_port=reuse)
            await gserver.start()
            stoppers.append(gserver)
            _say(f"gRPC Seldon service on {args.host}:{gserver.port}")
        if args.native_port:
            from seldon_core_tpu_torch.serving.native_http import (
                NativeRestServer,
            )

            # one RestServer behind both ports: /pause on either drains
            # both
            nrest = NativeRestServer(rest=server, port=args.native_port,
                                     bind=args.host, reuseport=reuse)
            await nrest.start()
            stoppers.append(nrest)
            _say(f"native REST tier on {args.host}:{nrest.port}")
        if args.native_grpc_port:
            from seldon_core_tpu_torch.serving.native_http import (
                NativeGrpcServer,
            )

            ngrpc = NativeGrpcServer(deployment=local,
                                     port=args.native_grpc_port,
                                     bind=args.host, reuseport=reuse)
            await ngrpc.start()
            stoppers.append(ngrpc)
            _say(f"native gRPC tier on {args.host}:{ngrpc.port}")
        _say(f"serving deployment {local.spec.name!r} on "
             f"{args.host}:{server.port}")
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        if args.max_lifetime_s > 0:
            loop.call_later(args.max_lifetime_s, stop.set)
        await stop.wait()
        for srv in reversed(stoppers):
            await srv.stop()
        await local.aclose()

    asyncio.run(run())


if __name__ == "__main__":
    engine_main()
