"""Local runner: boot a SeldonDeployment's graph in process and serve it
over REST (port of the single-node path of
``seldon_core_tpu/operator/local.py``).

    python -m seldon_core_tpu_torch.operator.local \\
        --graph seldon_core_tpu_torch/examples/llm.json --port 8000 \\
        [--device cpu]

The graph's MODEL node names its class with the ``model_class`` parameter
(``pkg.module:Class``); the class is built from the node's typed parameters
and ``device``.  Responses carry the reference engine's meta: a ``puid``,
``requestPath`` ``{node: class}``, and the component's tags and metrics.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
from typing import Optional

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.graph.spec import Deployment, load_deployment
from seldon_core_tpu_torch.messages import SeldonMessage, Status, new_puid
from seldon_core_tpu_torch.runtime.component import (
    SeldonComponentError,
    load_component,
)

__all__ = ["LocalDeployment", "serve", "engine_main"]


class LocalDeployment:
    """One predictor graph (a single MODEL node) with its live component."""

    def __init__(self, dep: Deployment, device: Optional[str] = None):
        unit = dep.graph
        model_class = unit.parameters.get("model_class")
        if not model_class:
            raise ValueError(f"node {unit.name!r}: no model_class parameter")
        params = {k: v for k, v in unit.parameters.items()
                  if k not in ("model_class", "service_type")}
        dev = resolve_device(device)
        self.spec = dep
        self.unit = unit
        self.component = load_component(model_class, params, device=str(dev))

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        meta = msg.meta.copy()
        if not meta.puid:
            meta.puid = new_puid()
        meta.request_path[self.unit.name] = (
            self.unit.implementation or type(self.component).__name__)
        try:
            out = await self.component.predict(msg)
        except SeldonComponentError as e:
            return SeldonMessage(
                status=Status.failure(e.status_code, str(e), e.reason),
                meta=meta)
        except Exception as e:
            return SeldonMessage(
                status=Status.failure(500, f"{type(e).__name__}: {e}",
                                      "INTERNAL"),
                meta=meta)
        meta.merge(out.meta)
        out.meta = meta
        if out.status is None:
            out.status = Status()
        return out


async def serve(graph, port: int = 8000, host: str = "0.0.0.0",
                device: Optional[str] = None):
    """Boot ``graph`` (path, JSON string or dict) and start its REST server;
    returns ``(server, deployment)``.  ``await server.stop()`` ends it."""
    from seldon_core_tpu_torch.serving.rest import RestServer

    local = LocalDeployment(load_deployment(graph), device=device)
    server = await RestServer(local, host=host, port=port).start()
    return server, local


def engine_main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.operator.local")
    ap.add_argument("--graph", required=True,
                    help="path to a SeldonDeployment JSON")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    async def run():
        server, local = await serve(args.graph, port=args.port,
                                    host=args.host, device=args.device)
        print(f"serving deployment {local.spec.name!r} on "
              f"{args.host}:{server.port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    asyncio.run(run())


if __name__ == "__main__":
    engine_main()
