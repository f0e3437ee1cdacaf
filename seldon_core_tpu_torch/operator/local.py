"""Local runner: boot a SeldonDeployment's graph in process and serve it
(port of the walk path of ``seldon_core_tpu/operator/local.py``).

    python -m seldon_core_tpu_torch.operator.local \\
        --graph seldon_core_tpu_torch/examples/iris.json --port 8000 \\
        [--grpc-port 5000] [--native-port 8001] [--native-grpc-port 8002] \\
        [--workers N] [--device cpu]

The first predictor's graph runs on a :class:`GraphEngine`.  Built-in
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

A node with an ``endpoint`` (``service_host``, ``service_port``, type
``REST`` or ``GRPC``) and no ``model_class`` is a remote component: a
:class:`~seldon_core_tpu_torch.serving.client.RemoteComponent` (with the
``seldon.io/rest-read-timeout`` and ``seldon.io/rest-connection-timeout``
annotations, milliseconds) or a
:class:`~seldon_core_tpu_torch.serving.grpc_api.GrpcComponentClient`
(``seldon.io/grpc-read-timeout``) calls it.  A tensor crosses a REST hop in
the encoding the request arrived with.

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
import signal
from typing import Optional

import numpy as np

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.graph.spec import (
    Deployment,
    PredictiveUnit,
    load_deployment,
)
from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
from seldon_core_tpu_torch.qos.policy import EngineQos, qos_from_annotations
from seldon_core_tpu_torch.qos.registry import publish
from seldon_core_tpu_torch.runtime.batcher import BatchedModel, BatcherConfig
from seldon_core_tpu_torch.runtime.component import load_component
from seldon_core_tpu_torch.utils.metrics import EngineMetrics, MetricsRegistry

__all__ = ["resolve_component", "qos_config", "LocalDeployment", "serve",
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


def _remote(unit: PredictiveUnit, ann: dict, qos=None):
    """The client of a node served by another process, behind a circuit
    breaker when QoS is on.  Its ``/route`` calls carry the tensor: the
    reference turns ``route_meta_only`` on from the signature of a node's
    ``model_class``, and an endpoint node names none."""
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
                ann, "seldon.io/rest-connection-timeout", None))
    if qos is not None and qos.config.breakers_enabled:
        from seldon_core_tpu_torch.qos.breaker import BreakerWrapper

        return BreakerWrapper(client, qos.make_breaker(unit.name),
                              name=unit.name)
    return client


def resolve_component(unit: PredictiveUnit, annotations: dict, device: str,
                      qos: Optional[EngineQos] = None, metrics=None):
    """The implementation of one non-built-in node; ``metrics`` (a
    ``MetricsRegistry``) receives the batcher's series."""
    model_class = unit.parameters.get("model_class")
    if not model_class:
        if unit.endpoint.service_host and unit.endpoint.type != "LOCAL":
            return _remote(unit, annotations, qos)
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
        batched = BatchedModel(handle, _batcher_config(annotations),
                               metrics=metrics)
        shape = getattr(handle.user, "input_shape", None)
        if shape is not None and handle.device.type == "cuda":
            batched.warmup(np.zeros(shape, np.float32))
        return batched
    return handle


def qos_config(dep: Deployment):
    """The deployment's QoS annotations as a ``QosConfig`` (None when QoS
    is off); a fallback node must be in the graph and not its root
    (``ValueError``)."""
    cfg = qos_from_annotations(dep.annotations,
                               f"{dep.name}/{dep.predictor}")
    if cfg is not None and cfg.fallback_node:
        names = [u.name for u in dep.graph.walk()]
        if cfg.fallback_node not in names:
            raise ValueError(
                f"annotation seldon.io/qos-fallback names node "
                f"{cfg.fallback_node!r} which is not in predictor "
                f"{dep.predictor!r}'s graph (nodes: {names})")
        if cfg.fallback_node == names[0]:
            raise ValueError(
                f"annotation seldon.io/qos-fallback names the graph root "
                f"{cfg.fallback_node!r}: falling back to the primary is not "
                "a degraded mode")
    return cfg


class LocalDeployment:
    """The first predictor's graph with its live components."""

    def __init__(self, dep: Deployment, device: Optional[str] = None):
        dev = str(resolve_device(device))
        self.spec = dep
        self.metrics = EngineMetrics(MetricsRegistry(), deployment=dep.name)
        cfg = qos_config(dep)
        self.qos = None if cfg is None else EngineQos(
            cfg, metrics=self.metrics.registry)
        self.engine = GraphEngine(
            dep.graph, name=dep.predictor, metrics_sink=self.metrics,
            qos=self.qos,
            walk_timeout_s=_timeout_s(dep.annotations,
                                      "seldon.io/engine-walk-timeout-ms",
                                      None),
            resolver=lambda u: resolve_component(
                u, dep.annotations, dev, qos=self.qos,
                metrics=self.metrics.registry))
        if self.qos is not None:
            publish(dep.name, self.qos.snapshot)

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self.engine.predict(msg)

    def stream(self, msg: SeldonMessage):
        return self.engine.stream(msg)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        return await self.engine.send_feedback(fb)


async def serve(graph, port: int = 8000, host: str = "0.0.0.0",
                device: Optional[str] = None, reuse_port: bool = False):
    """Boot ``graph`` (path, JSON string or dict) and start its REST server;
    returns ``(server, deployment)``.  ``await server.stop()`` ends it."""
    from seldon_core_tpu_torch.serving.rest import RestServer

    local = LocalDeployment(load_deployment(graph), device=device)
    server = await RestServer(local, host=host, port=port,
                              metrics=local.metrics,
                              reuse_port=reuse_port).start()
    return server, local


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
    return ap


def engine_main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    reuse = args.workers > 1
    if reuse:
        # before anything touches CUDA, grpc or the native library's threads
        from seldon_core_tpu_torch.serving.workers import fork_workers

        index = fork_workers(args.workers)
        print(f"worker {index} (pid {os.getpid()})", flush=True)

    async def run():
        server, local = await serve(args.graph, port=args.port,
                                    host=args.host, device=args.device,
                                    reuse_port=reuse)
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
            print(f"gRPC Seldon service on {args.host}:{gserver.port}",
                  flush=True)
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
            print(f"native REST tier on {args.host}:{nrest.port}",
                  flush=True)
        if args.native_grpc_port:
            from seldon_core_tpu_torch.serving.native_http import (
                NativeGrpcServer,
            )

            ngrpc = NativeGrpcServer(deployment=local,
                                     port=args.native_grpc_port,
                                     bind=args.host, reuseport=reuse)
            await ngrpc.start()
            stoppers.append(ngrpc)
            print(f"native gRPC tier on {args.host}:{ngrpc.port}",
                  flush=True)
        print(f"serving deployment {local.spec.name!r} on "
              f"{args.host}:{server.port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        for srv in reversed(stoppers):
            await srv.stop()

    asyncio.run(run())


if __name__ == "__main__":
    engine_main()
