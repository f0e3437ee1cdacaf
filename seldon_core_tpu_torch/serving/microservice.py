"""Standalone component server CLI (port of
``seldon_core_tpu/serving/microservice.py``, the reference python wrapper's
``microservice.py``).

    python -m seldon_core_tpu_torch.serving.microservice \\
        seldon_core_tpu_torch.models.iris:IrisClassifier REST \\
        --service-type MODEL --port 9000 \\
        --parameters '[{"name":"seed","value":"0","type":"INT"}]' \\
        [--persistence 1 --push-frequency 60] [--device cpu]

``REST`` serves the component API of ``serving/rest.py`` (``/predict``,
``/route``, ``/send-feedback``, ``/stream``, ``/metrics``, ...);
``GRPC`` serves the component's gRPC services (``serving/grpc_api.py``:
``Generic``, the service of its role, and ``Stream`` where it streams;
messages up to 100 MiB);
``FRAMED`` serves the framed binary protocol (``serving/framed.py``) on the
native epoll server.  The component is built on the card unless ``--device
cpu`` asks for the CPU (the constructor gets ``device`` when it takes
one).

Environment, as the reference's: ``PREDICTIVE_UNIT_SERVICE_PORT``,
``PREDICTIVE_UNIT_PARAMETERS``, ``PREDICTIVE_UNIT_ID`` (the component's
name: a router's feedback reads its branch from ``meta.routing`` under
it), ``SERVICE_TYPE``, ``PERSISTENCE``, ``PUSH_FREQUENCY``.
``--persistence 1`` restores the component's state at boot, pushes it
every ``--push-frequency`` seconds and once more at exit (SIGTERM too),
under the key ``persistence_<SELDON_DEPLOYMENT_ID>_<PREDICTOR_ID>_<name>``
in the store of ``runtime.persistence.store_from_env``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import threading
from typing import Optional

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.graph.spec import _coerce_param
from seldon_core_tpu_torch.runtime.component import load_component
from seldon_core_tpu_torch.utils.metrics import EngineMetrics, MetricsRegistry

__all__ = ["parse_parameters", "build_parser", "maybe_start_custom_service",
           "main"]

logger = logging.getLogger(__name__)


def parse_parameters(raw: Optional[str]) -> dict:
    """The reference's format: a JSON list of ``{name, value, type}``."""
    if not raw:
        return {}
    return {p["name"]: _coerce_param(p.get("value"), p.get("type", "STRING"),
                                     "parameters", p["name"])
            for p in json.loads(raw)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.serving.microservice")
    ap.add_argument("interface_name",
                    help="module or module:Class of the user component")
    ap.add_argument("api_type", nargs="?", default="REST",
                    choices=["REST", "GRPC", "FRAMED"])
    ap.add_argument("--service-type",
                    default=os.environ.get("SERVICE_TYPE", "MODEL"))
    ap.add_argument("--parameters",
                    default=os.environ.get("PREDICTIVE_UNIT_PARAMETERS", "[]"))
    ap.add_argument("--port", type=int, default=int(
        os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", "9000")))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--persistence", type=int,
                    default=int(os.environ.get("PERSISTENCE", "0")),
                    help="1 = restore state on boot, push it periodically "
                         "and at exit")
    ap.add_argument("--push-frequency", type=float,
                    default=float(os.environ.get("PUSH_FREQUENCY", "60")))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def maybe_start_custom_service(user_object) -> Optional[threading.Thread]:
    """Run the user's ``custom_service()`` beside the server, in a daemon
    thread (the component's state is shared directly)."""
    fn = getattr(user_object, "custom_service", None)
    if not callable(fn):
        return None

    def run():
        try:
            fn()
        except Exception:
            logger.exception("custom_service crashed")

    t = threading.Thread(target=run, name="custom-service", daemon=True)
    t.start()
    return t


def _start_persistence(handle, push_frequency: float):
    """Restore, start the periodic push, and push once more at exit."""
    import atexit
    import signal

    from seldon_core_tpu_torch.runtime.persistence import (
        PersistenceManager,
        persistence_key,
        store_from_env,
    )

    key = persistence_key(os.environ.get("SELDON_DEPLOYMENT_ID", "dep"),
                          os.environ.get("PREDICTOR_ID", "pred"),
                          handle.name)
    pm = PersistenceManager(handle.user, store_from_env(), key,
                            push_frequency=push_frequency)
    if pm.restore():
        logger.info("restored state for %s", key)
    pm.start()
    # without the final push, up to push_frequency seconds of learned
    # state would be lost at every restart
    atexit.register(pm.stop)

    def on_term(signum, frame):
        pm.stop()
        atexit.unregister(pm.stop)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, on_term)
    return pm


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    device = str(resolve_device(args.device))
    handle = load_component(args.interface_name,
                            parse_parameters(args.parameters),
                            service_type=args.service_type, device=device)
    handle.name = os.environ.get("PREDICTIVE_UNIT_ID", handle.name)
    metrics = EngineMetrics(MetricsRegistry(), deployment=handle.name)
    if args.persistence:
        _start_persistence(handle, args.push_frequency)
    # after the restore: it replaces the user's state wholesale
    maybe_start_custom_service(handle.user)

    if args.api_type == "FRAMED":
        from seldon_core_tpu_torch.serving.framed import FramedComponentServer

        srv = FramedComponentServer(handle, port=args.port,
                                    bind=args.host).start()
        print(f"component {handle.name!r} serving FRAMED on "
              f"{args.host}:{srv.port}", flush=True)
        try:
            threading.Event().wait()
        finally:
            srv.stop()
        return

    if args.api_type == "GRPC":
        from seldon_core_tpu_torch.serving.grpc_api import (
            serve_grpc_component,
        )

        asyncio.run(serve_grpc_component(handle, host=args.host,
                                         port=args.port))
        return

    async def serve():
        from seldon_core_tpu_torch.serving.rest import RestServer

        server = await RestServer(component=handle, host=args.host,
                                  port=args.port, metrics=metrics).start()
        print(f"component {handle.name!r} serving on {args.host}:"
              f"{server.port}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
