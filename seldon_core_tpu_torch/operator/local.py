"""Local runner: boot a SeldonDeployment's graph in process and serve it
over REST (port of the walk path of ``seldon_core_tpu/operator/local.py``).

    python -m seldon_core_tpu_torch.operator.local \\
        --graph seldon_core_tpu_torch/examples/iris.json --port 8000 \\
        [--native-port 8001] [--device cpu]

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
``REST``) and no ``model_class`` is a remote component: a
:class:`~seldon_core_tpu_torch.serving.client.RemoteComponent` calls it,
with the ``seldon.io/rest-read-timeout`` and
``seldon.io/rest-connection-timeout`` annotations (milliseconds).  A
tensor crosses the hop in the encoding the request arrived with.  A GRPC
endpoint waits for slice 4a-ii of the port.  ``/metrics`` renders the
deployment's :class:`EngineMetrics`; ``--native-port`` adds the native
(C++ epoll) REST tier on a second port.
"""

from __future__ import annotations

import argparse
import asyncio
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
from seldon_core_tpu_torch.runtime.batcher import BatchedModel, BatcherConfig
from seldon_core_tpu_torch.runtime.component import load_component
from seldon_core_tpu_torch.utils.metrics import EngineMetrics, MetricsRegistry

__all__ = ["resolve_component", "LocalDeployment", "serve", "engine_main"]


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


def _remote(unit: PredictiveUnit, ann: dict):
    """The client of a node served by another process.  Its ``/route``
    calls carry the tensor: the reference turns ``route_meta_only`` on
    from the signature of a node's ``model_class``, and an endpoint node
    names none."""
    if unit.endpoint.type == "GRPC":
        raise NotImplementedError(
            f"node {unit.name!r}: GRPC endpoints come with slice 4a-ii of "
            "the port; serve the component over REST")
    from seldon_core_tpu_torch.serving.client import RemoteComponent

    return RemoteComponent(
        f"http://{unit.endpoint.service_host}:"
        f"{unit.endpoint.service_port or 8000}",
        name=unit.name, methods=unit.methods,
        timeout_s=_timeout_s(ann, "seldon.io/rest-read-timeout", 30.0),
        connect_timeout_s=_timeout_s(ann, "seldon.io/rest-connection-timeout",
                                     None))


def resolve_component(unit: PredictiveUnit, annotations: dict, device: str):
    """The implementation of one non-built-in node."""
    model_class = unit.parameters.get("model_class")
    if not model_class:
        if unit.endpoint.service_host and unit.endpoint.type != "LOCAL":
            return _remote(unit, annotations)
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
        batched = BatchedModel(handle, _batcher_config(annotations))
        shape = getattr(handle.user, "input_shape", None)
        if shape is not None and handle.device.type == "cuda":
            batched.warmup(np.zeros(shape, np.float32))
        return batched
    return handle


class LocalDeployment:
    """The first predictor's graph with its live components."""

    def __init__(self, dep: Deployment, device: Optional[str] = None):
        dev = str(resolve_device(device))
        self.spec = dep
        self.metrics = EngineMetrics(MetricsRegistry(), deployment=dep.name)
        self.engine = GraphEngine(
            dep.graph, name=dep.predictor, metrics_sink=self.metrics,
            resolver=lambda u: resolve_component(u, dep.annotations, dev))

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        return await self.engine.predict(msg)

    def stream(self, msg: SeldonMessage):
        return self.engine.stream(msg)

    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        return await self.engine.send_feedback(fb)


async def serve(graph, port: int = 8000, host: str = "0.0.0.0",
                device: Optional[str] = None):
    """Boot ``graph`` (path, JSON string or dict) and start its REST server;
    returns ``(server, deployment)``.  ``await server.stop()`` ends it."""
    from seldon_core_tpu_torch.serving.rest import RestServer

    local = LocalDeployment(load_deployment(graph), device=device)
    server = await RestServer(local, host=host, port=port,
                              metrics=local.metrics).start()
    return server, local


def engine_main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.operator.local")
    ap.add_argument("--graph", required=True,
                    help="path to a SeldonDeployment JSON")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--native-port", type=int, default=0,
                    help="native (C++ epoll) REST tier port; 0 disables")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    async def run():
        server, local = await serve(args.graph, port=args.port,
                                    host=args.host, device=args.device)
        stoppers = [server]
        if args.native_port:
            from seldon_core_tpu_torch.serving.native_http import (
                NativeRestServer,
            )

            # one RestServer behind both ports: /pause on either drains
            # both
            nrest = NativeRestServer(rest=server, port=args.native_port,
                                     bind=args.host)
            await nrest.start()
            stoppers.append(nrest)
            print(f"native REST tier on {args.host}:{nrest.port}",
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
