"""``chip_smoke.py``'s ``serve_7b`` traffic, served end to end on the card
in repeated bursts: the TTFT and TPOT medians of each burst.

    python -m seldon_core_tpu_torch.time_serve [--bursts 5] [--layers 32]
        [--eager]

Builds ``serve_7b``'s setup: the 7B-class int8 "full" model (d4096,
H32/Hkv8, ff16384, V32000, bf16, flash prefill; ``--layers`` deep) with
seeded weights made on the card, served by ``PagedLLMEngine`` (96 pages of
16, 8 slots, max_len 256) through ``LLMComponent`` behind the REST server.
After one warm-up request (it also builds the kernels), it sends
``--bursts`` bursts of the same 8 concurrent requests (prompts of 5..120
tokens, n_new 16) and prints one JSON line per burst: the TTFT and TPOT
medians from the engine's latency log (host clock) and the burst's wall
time; then one line with the median of the bursts' medians.  The engine's
programs replay CUDA graphs (captured by the warm-up request and the first
burst); ``--eager`` runs them eagerly (``programs.eager()``); each line
names the mode.

To compare two checkouts on one card, copy this file into the other
checkout's ``seldon_core_tpu_torch/`` and run it in each in turn (parent,
change, change, parent): it uses only the serving API both share.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import statistics
import subprocess
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["main"]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _post(port: int, body: dict) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


async def _post_all(port: int, bodies: list) -> list:
    # a pool of its own: the loop's default executor serves the server
    loop = asyncio.get_running_loop()
    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        outs = await asyncio.gather(*(
            loop.run_in_executor(pool, _post, port, b) for b in bodies),
            return_exceptions=True)
    for out in outs:  # raise once every request has ended
        if isinstance(out, BaseException):
            raise out
    return outs


def main(argv=None) -> list:
    from seldon_core_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params_int8,
    )
    from seldon_core_tpu_torch.runtime.llm import (
        LLMComponent,
        PagedLLMEngine,
    )
    from seldon_core_tpu_torch.runtime import programs
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.rest import RestServer

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bursts", type=int, default=5)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--eager", action="store_true",
                    help="run the engine's programs eagerly, not as graphs")
    args = ap.parse_args(argv)
    mode = "eager" if args.eager else "graphs"

    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=args.layers, n_heads=32,
        n_kv_heads=8, d_ff=16384, max_seq=512, dtype=torch.bfloat16,
        use_flash=True)
    params = init_params_int8(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    engine = PagedLLMEngine(params, cfg, PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    comp = LLMComponent(engine, n_new=16)
    rng = torch.Generator().manual_seed(7)
    lens = [5 + (115 * i) // 7 for i in range(8)]  # 5 .. 120
    bodies = [{"jsonData": {"prompt_ids": torch.randint(
        1, 32000, (n,), generator=rng).tolist(), "n_new": 16}} for n in lens]
    card = _card()

    async def run() -> list:
        server = await RestServer(comp, host="127.0.0.1", port=0).start()
        try:
            await _post_all(server.port, [{"jsonData": {
                "prompt_ids": [1, 2, 3], "n_new": 2}}])
            rows = []
            for b in range(args.bursts):
                engine.latency_log.clear()
                t0 = time.perf_counter()
                answers = await _post_all(server.port, bodies)
                wall = time.perf_counter() - t0
                if any(code != 200 for code, _ in answers):
                    raise AssertionError(f"burst {b}: {answers}")
                log = list(engine.latency_log)
                row = {"burst": b, "requests": len(bodies),
                       "ttft_ms_median": statistics.median(
                           x["ttft_s"] for x in log) * 1e3,
                       "tpot_ms_median": statistics.median(
                           x["tpot_s"] for x in log
                           if x["tpot_s"] is not None) * 1e3,
                       "wall_s": wall, "mode": mode, "card": card}
                print(json.dumps(row), flush=True)
                rows.append(row)
            return rows
        finally:
            await server.stop()

    try:
        with programs.eager() if args.eager else contextlib.nullcontext():
            rows = asyncio.run(run())
    finally:
        engine.close()
    print(json.dumps({
        "bursts": len(rows), "layers": args.layers, "mode": mode,
        "ttft_ms_median_of_bursts": statistics.median(
            r["ttft_ms_median"] for r in rows),
        "tpot_ms_median_of_bursts": statistics.median(
            r["tpot_ms_median"] for r in rows),
        "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
