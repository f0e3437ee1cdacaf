"""CLI: ``python -m seldon_core_tpu_torch.tools <subcommand>`` (port of
``seldon_core_tpu/tools/__main__.py``).

- ``contract-test``  standalone component tester (REST, gRPC, framed)
- ``api-test``       deployed-graph tester, through a gateway's OAuth too
- ``load``           socket load harness (closed or open loop, ``--stream``)
- ``save-model``     export a component's weights as a checkpoint dir
  (``--device``: cuda by default, cpu when asked)
- ``firehose-tail``  firehose consumer: replay/tail a client's topic by
  offset from a ``gateway/firehose_net.py`` broker
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from seldon_core_tpu_torch.tools.contract import Contract


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("contract", help="path to contract.json")
    ap.add_argument("-n", "--n-requests", type=int, default=1)
    ap.add_argument("-b", "--batch-size", type=int, default=1)
    ap.add_argument("--ndarray", action="store_true", help="ndarray payload (default: tensor)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("-v", "--verbose", action="store_true", help="print responses")


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface, exposed for drift-locking (packaging templates
    embed these flags; tests parse them against this parser)."""
    ap = argparse.ArgumentParser(prog="seldon-tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ct = sub.add_parser("contract-test", help="drive a standalone component")
    _add_common(ct)
    ct.add_argument("--host", default="127.0.0.1")
    ct.add_argument("-p", "--port", type=int, default=8000)
    ct.add_argument("-t", "--transport", choices=["rest", "grpc", "framed"], default="rest")
    ct.add_argument("--endpoint", choices=["predict", "send-feedback"], default="predict")

    at = sub.add_parser("api-test", help="drive a deployed graph via the external API")
    _add_common(at)
    at.add_argument("--url", default="http://127.0.0.1:8080", help="gateway/engine base URL")
    at.add_argument("--grpc-target", default="", help="host:port → use gRPC Seldon service")
    at.add_argument("--oauth-key", default="")
    at.add_argument("--oauth-secret", default="")
    at.add_argument("--endpoint", choices=["predict", "feedback"], default="predict")

    ld = sub.add_parser("load", help="socket load harness")
    ld.add_argument("contract", help="path to contract.json")
    ld.add_argument("--url", default="http://127.0.0.1:8080")
    ld.add_argument("--grpc-target", default="")
    ld.add_argument("--framed-target", default="", help="host:port for SELF-framed TCP")
    ld.add_argument("--path", default="/api/v0.1/predictions")
    ld.add_argument("--grpc-service", default="Seldon", choices=["Seldon", "Model"])
    ld.add_argument("--oauth-key", default="")
    ld.add_argument("--oauth-secret", default="")
    ld.add_argument("-c", "--concurrency", type=int, default=64)
    ld.add_argument("-s", "--seconds", type=float, default=5.0)
    ld.add_argument("--warmup", type=float, default=0.5)
    ld.add_argument("-b", "--batch-size", type=int, default=1)
    ld.add_argument("--seed", type=int, default=0)
    ld.add_argument("--stream", action="store_true",
                    help="drive the SSE streaming endpoint; payload is the "
                         "raw contract request (LLM contracts use jsonData) "
                         "and the report adds TTFT percentiles + tokens/s")
    ld.add_argument("--rate", type=float, default=0.0,
                    help="OPEN-loop mode: Poisson arrivals at this req/s "
                         "(latency at fixed offered load); 0 = closed-loop "
                         "with --concurrency workers")

    sm = sub.add_parser(
        "save-model",
        help="export a component's weights as a model_uri checkpoint dir",
    )
    sm.add_argument("model_class", help="pkg.module:Class (the CRD "
                                        "model_class parameter)")
    sm.add_argument("out", help="checkpoint directory to write")
    sm.add_argument("--param", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="constructor parameter (repeatable; values "
                         "JSON-decoded, falling back to string)")
    sm.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the component's device")

    ft = sub.add_parser(
        "firehose-tail",
        help="replay/tail a client's firehose topic from a broker",
    )
    ft.add_argument("client", help="client id (topic)")
    ft.add_argument("--target", default="127.0.0.1:7788",
                    help="broker host:port (gateway/firehose_net broker)")
    ft.add_argument("--from-offset", type=int, default=0,
                    help="resume offset (replay starts here)")
    ft.add_argument("--max", type=int, default=1000,
                    help="max records per poll")
    ft.add_argument("-f", "--follow", action="store_true",
                    help="keep polling for new records (tail -f)")
    ft.add_argument("--poll-interval", type=float, default=1.0)
    ft.add_argument("--token", default="", help="broker shared secret")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cmd == "save-model":
        # the weights-export half of the model_uri path
        # (runtime/checkpoint.py): construct the component the way the
        # engine pod would (model_class + parameters) and ask it to
        # export through its save_checkpoint
        import importlib

        params = {}
        for kv in args.param:
            name, _, value = kv.partition("=")
            try:
                params[name] = json.loads(value)
            except ValueError:
                params[name] = value
        if args.device is not None:
            params["device"] = args.device
        mod_name, _, cls_name = args.model_class.partition(":")
        obj = getattr(importlib.import_module(mod_name), cls_name)(**params)
        save = getattr(obj, "save_checkpoint", None)
        if not callable(save):
            print(f"save-model: {args.model_class} has no save_checkpoint()",
                  file=sys.stderr)
            return 1
        print(save(args.out))
        return 0

    if args.cmd == "firehose-tail":
        import time as _time

        from seldon_core_tpu_torch.gateway.firehose_net import broker_read

        offset = args.from_offset
        while True:
            try:
                records = broker_read(
                    args.target, args.client, from_offset=offset,
                    max_records=args.max, token=args.token,
                )
            except RuntimeError as e:
                # broker-side errors (unauthorized, unknown op) can never
                # succeed on retry — exit non-zero even under --follow
                print(f"firehose-tail: {e}", file=sys.stderr)
                return 1
            except (ConnectionError, OSError) as e:
                # --follow survives broker restarts (like the producer
                # side); a one-shot read fails cleanly instead of
                # tracebacking
                if not args.follow:
                    print(f"firehose-tail: broker unreachable: {e}",
                          file=sys.stderr)
                    return 1
                print(f"firehose-tail: {e}; retrying", file=sys.stderr)
                _time.sleep(args.poll_interval)
                continue
            for rec in records:
                print(json.dumps(rec, separators=(",", ":")))
                offset = rec["offset"] + 1
            sys.stdout.flush()
            if records:
                continue  # drain until caught up before sleeping/exiting
            if not args.follow:
                return 0
            _time.sleep(args.poll_interval)

    contract = Contract.load(args.contract)

    if args.cmd == "contract-test":
        from seldon_core_tpu_torch.tools.tester import test_component

        report = asyncio.run(
            test_component(
                contract,
                host=args.host,
                port=args.port,
                transport=args.transport,
                endpoint=args.endpoint,
                n_requests=args.n_requests,
                batch_size=args.batch_size,
                tensor=not args.ndarray,
                seed=args.seed,
            )
        )
        out = report.to_dict()
        if not args.verbose:
            out.pop("responses")
        print(json.dumps(out, indent=2))
        return 0 if report.ok else 1

    if args.cmd == "api-test":
        from seldon_core_tpu_torch.tools.tester import test_api

        report = asyncio.run(
            test_api(
                contract,
                base_url=args.url,
                oauth_key=args.oauth_key,
                oauth_secret=args.oauth_secret,
                grpc_target=args.grpc_target,
                endpoint=args.endpoint,
                n_requests=args.n_requests,
                batch_size=args.batch_size,
                tensor=not args.ndarray,
                seed=args.seed,
            )
        )
        out = report.to_dict()
        if not args.verbose:
            out.pop("responses")
        print(json.dumps(out, indent=2))
        return 0 if report.ok else 1

    # load
    from seldon_core_tpu_torch.tools.loadtest import (
        FramedDriver,
        GrpcDriver,
        RestDriver,
        SseStreamDriver,
        oauth_token,
        run_load,
        run_open_loop,
    )

    import numpy as np

    payload = contract.rest_request(
        args.batch_size, rng=np.random.default_rng(args.seed)
    )

    async def _run():
        token = ""
        if args.oauth_key:
            token = await oauth_token(args.url, args.oauth_key, args.oauth_secret)
        if args.grpc_target:
            driver = GrpcDriver(
                args.grpc_target, payload, service=args.grpc_service, token=token
            )
            proto = "grpc"
        elif args.framed_target:
            host, _, port = args.framed_target.rpartition(":")
            driver = FramedDriver(
                host or "127.0.0.1", int(port), payload, pool=args.concurrency
            )
            proto = "framed"
        elif args.stream:
            driver = SseStreamDriver(
                args.url, payload,
                path=(args.path if args.path != "/api/v0.1/predictions"
                      else "/api/v0.1/stream"),
                token=token, connections=max(args.concurrency, 16),
            )
            proto = "sse-stream"
        else:
            driver = RestDriver(
                args.url, payload, path=args.path, token=token,
                connections=max(args.concurrency, 16),
            )
            proto = "rest"
        if args.rate > 0:
            res = await run_open_loop(
                driver,
                rate=args.rate,
                seconds=args.seconds,
                warmup_s=args.warmup,
                seed=args.seed,
                protocol=proto,
            )
        else:
            res = await run_load(
                driver,
                seconds=args.seconds,
                concurrency=args.concurrency,
                warmup_s=args.warmup,
                protocol=proto,
            )
        return res, driver

    result, driver = asyncio.run(_run())
    out = result.to_dict()
    if isinstance(driver, SseStreamDriver):
        out["stream"] = driver.stream_stats(result.req_per_s)
    print(json.dumps(out, indent=2))
    return 0 if result.failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
