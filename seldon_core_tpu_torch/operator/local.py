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
the native h2c gRPC tier on ``--native-grpc-port``.  ``--workers N`` forks
N worker processes before anything touches the card, each with its own
engine, all binding the same ports with ``SO_REUSEPORT``; the first worker
to exit stops the group.
"""

from __future__ import annotations

import argparse
import asyncio
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

__all__ = ["resolve_component", "qos_config", "LocalPredictor",
           "LocalDeployment", "serve", "build_parser", "engine_main"]


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


class LocalPredictor:
    """One predictor's live graph: its engine with its own QoS, batchers,
    plan, cache and observability planes (``metrics`` is the
    deployment's, shared)."""

    def __init__(self, dep: Deployment, pred: Predictor, device: str,
                 metrics: EngineMetrics):
        ann = pred.annotations
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
            profiler=self.profiler,
            resolver=lambda u: resolve_component(
                u, ann, device, qos=self.qos, metrics=metrics.registry,
                device_plane=self.device_plane))
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
        artifact and profiling planes.  (The placement probe comes with
        the multi-device slice.)"""
        from seldon_core_tpu_torch.health import (
            batcher_probe,
            cache_probe,
            device_memory_probe,
            device_registry_probe,
            engine_probe,
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
                 seed: Optional[int] = None):
        dev = str(resolve_device(device))
        self.spec = dep
        self.metrics = EngineMetrics(MetricsRegistry(), deployment=dep.name)
        self.predictors = [LocalPredictor(dep, p, dev, self.metrics)
                           for p in dep.predictors]
        self.engine = self.predictors[0].engine
        self.qos = self.predictors[0].qos
        if any(p.artifacts is not None for p in self.predictors):
            from seldon_core_tpu_torch.artifacts import publish as art_publish

            def _art_snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.artifacts.snapshot()}
                    for p in preds if p.artifacts is not None]}

            art_publish(dep.name, _art_snapshot)
        if any(p.qos is not None for p in self.predictors):
            def _snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.qos.snapshot()}
                    for p in preds if p.qos is not None]}

            publish(dep.name, _snapshot)
        if any(p.health is not None for p in self.predictors):
            from seldon_core_tpu_torch.health import publish as health_publish

            def _health_snapshot(preds=self.predictors):
                return {"predictors": [
                    {"name": p.spec.name, **p.health.snapshot()}
                    for p in preds if p.health is not None]}

            health_publish(dep.name, _health_snapshot)
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.operator.local")
    ap.add_argument("--graph", required=True,
                    help="path to a SeldonDeployment JSON")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--grpc-port", type=int,
                    default=int(os.environ.get("ENGINE_SERVER_GRPC_PORT",
                                               "5000")),
                    help="the Seldon gRPC service's port; 0 disables")
    ap.add_argument("--native-port", type=int, default=0,
                    help="native (C++ epoll) REST tier port; 0 disables")
    ap.add_argument("--native-grpc-port", type=int, default=0,
                    help="native (C++ h2c) gRPC tier port; 0 disables")
    ap.add_argument("--workers", type=int,
                    default=int(os.environ.get("ENGINE_WORKERS", "1")),
                    help="worker processes sharing every port "
                         "(SO_REUSEPORT), each with its own engine")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the split among several predictors")
    return ap


def engine_main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    reuse = args.workers > 1
    if reuse:
        # before anything touches CUDA, grpc or the native library's threads
        from seldon_core_tpu_torch.serving.workers import fork_workers

        index = fork_workers(args.workers)
        _say(f"worker {index} (pid {os.getpid()})")

    async def run():
        server, local = await serve(args.graph, port=args.port,
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
        await stop.wait()
        for srv in reversed(stoppers):
            await srv.stop()
        await local.aclose()

    asyncio.run(run())


if __name__ == "__main__":
    engine_main()
