"""Profile the decode tick of the 7B-class int8 paged engine.

    python -m seldon_core_tpu_torch.profile_decode [--layers 32] [--ticks 8]

Builds the model ``chip_smoke.py`` serves (L32 d4096, 32/8 heads, d_head
128, ff16384, vocab 32000, bf16, int8 "full", weights from a seeded
generator) in a ``PagedLLMEngine`` with ``PagedConfig(96, 16)``, 8 slots
and max_len 256.  All 8 slots are live, at the prompt lengths of
``chip_smoke.py``'s ``serve_7b`` phase plus one.  It then runs the engine's
own tick body (``PagedLLMEngine._tick_device``: ``paged_decode_step``,
sampling and the copy of the ids to the host) ``--ticks`` times on the
host clock, and as many again under ``torch.profiler``.

Prints one JSON line: host ms per tick; device kernels and copies per
tick; device busy ms per tick (the union of the device events' intervals);
the device's idle share of a tick (1 - busy / the host-clock median, which
the profiler's own overhead does not inflate); and the device time and
count per tick of each kernel name, largest first.  If the profiler sees
no device event, the device fields are null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params_int8,
)
from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
from seldon_core_tpu_torch.runtime.paged import PagedConfig

__all__ = ["main"]

# chip_smoke.py serve_7b: prompts of 5..120 tokens, one generated token in
SLOT_LENGTHS = [6, 21, 36, 51, 66, 81, 96, 121]
N_NEW = 16


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _live_engine(cfg: TransformerConfig, device) -> tuple:
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params_int8(gen, cfg, device=device)
    engine = PagedLLMEngine(params, cfg, PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    state = engine._tick_state({})
    first = 1
    for s, n in enumerate(SLOT_LENGTHS):
        k = engine.paged_cfg.pages_for(n + N_NEW)
        state["tables"][s, :k] = range(first, first + k)
        first += k
    state["pos"][:] = SLOT_LENGTHS
    rng = torch.Generator().manual_seed(1)
    state["tokens"][:] = torch.randint(1, cfg.vocab_size, (8,),
                                       generator=rng).numpy()
    return engine, state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=args.layers, n_heads=32,
        n_kv_heads=8, d_ff=16384, max_seq=512, dtype=torch.bfloat16,
        use_flash=True)
    engine, state = _live_engine(cfg, device)
    try:
        for _ in range(2):  # warm-up: first-use costs stay out
            engine._tick_device(state)
        host_ms = []
        for _ in range(args.ticks):
            t0 = time.perf_counter()
            engine._tick_device(state)  # ends with a copy to the host
            host_ms.append((time.perf_counter() - t0) * 1e3)

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.ticks):
                engine._tick_device(state)
            window_us = (time.perf_counter() - t0) * 1e6
    finally:
        engine.close()

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"phase": "profile_decode", "layers": args.layers,
           "slots": 8, "slot_lengths": SLOT_LENGTHS, "ticks": args.ticks,
           "host_ms_per_tick_median": statistics.median(host_ms),
           "host_ms_per_tick": host_ms,
           "profiled_window_ms_per_tick": window_us / 1e3 / args.ticks,
           "device_events_per_tick": None, "device_busy_ms_per_tick": None,
           "device_idle_share": None, "by_kernel": None}
    if dev:
        busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
        by_name: dict = {}
        for e in dev:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        out.update(
            device_events_per_tick=len(dev) / args.ticks,
            device_busy_ms_per_tick=busy / 1e3 / args.ticks,
            device_idle_share=1.0 - busy / 1e3 / args.ticks
            / statistics.median(host_ms),
            by_kernel=[{"name": name[:120],
                        "ms_per_tick": us / 1e3 / args.ticks,
                        "per_tick": n / args.ticks}
                       for name, (us, n) in top])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
