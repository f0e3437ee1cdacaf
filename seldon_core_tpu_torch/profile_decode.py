"""Profile the decode tick of the 7B-class int8 paged engine.

    python -m seldon_core_tpu_torch.profile_decode [--layers 32] [--ticks 8]
        [--eager]

Builds the model ``chip_smoke.py`` serves (L32 d4096, 32/8 heads, d_head
128, ff16384, vocab 32000, bf16, int8 "full", weights from a seeded
generator) in a ``PagedLLMEngine`` with ``PagedConfig(96, 16)``, 8 slots
and max_len 256.  All 8 slots are live, at the prompt lengths of
``chip_smoke.py``'s ``serve_7b`` phase plus one.  It then runs the engine's
own tick body (``PagedLLMEngine._tick_device``: the tick program, sampling
and the copy of the ids to the host) on the engine's device worker
``--ticks`` times on the host clock, and as many again under
``torch.profiler``.  The tick program replays its CUDA graph (captured in
the warm-up); ``--eager`` runs it eagerly (``programs.eager()``).

Prints one JSON line: the mode; host ms per tick; device kernels and
copies per tick; device busy ms per tick (the union of the device events'
intervals); the device's idle share of a tick (1 - busy / the host-clock
median, which the profiler's own overhead does not inflate); and the
device time and count per tick of each kernel name, largest first.  If
the profiler sees no device event, the device fields are null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params_int8,
)
from seldon_core_tpu_torch.runtime import programs
from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
from seldon_core_tpu_torch.runtime.paged import PagedConfig

__all__ = ["main", "live_state", "profile_ticks"]

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


def live_state(engine, vocab_size: int) -> dict:
    """A tick snapshot of ``engine`` (8 slots; paged: at least 96 pages of
    16) with every slot live at :data:`SLOT_LENGTHS`, each on pages of its
    own."""
    state = engine._tick_state({})
    first = 1
    for s, n in enumerate(SLOT_LENGTHS if "tables" in state else ()):
        k = engine.paged_cfg.pages_for(n + N_NEW)
        state["tables"][s, :k] = range(first, first + k)
        first += k
    state["pos"][:] = SLOT_LENGTHS
    rng = torch.Generator().manual_seed(1)
    state["tokens"][:] = torch.randint(1, vocab_size, (8,),
                                       generator=rng).numpy()
    return state


def profile_ticks(engine, state, ticks: int, eager: bool = False) -> dict:
    """Time ``engine``'s tick body on its device worker, ``ticks`` times on
    the host clock and ``ticks`` times under torch.profiler, after two
    warm-up ticks (the tick program's capture among them); the JSON
    fields of :func:`main`."""
    mode = programs.eager() if eager else contextlib.nullcontext()

    def tick():
        # ends with the ids' copy to the host
        return engine._device_worker.submit(engine._tick_device,
                                            state).result()

    with mode:
        mode_name = "graphs" if programs.graphs_on(engine.device) else "eager"
        for _ in range(2):  # warm-up: first-use costs stay out
            tick()
        host_ms = []
        for _ in range(ticks):
            t0 = time.perf_counter()
            tick()
            host_ms.append((time.perf_counter() - t0) * 1e3)

        acts = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                tick()
            window_us = (time.perf_counter() - t0) * 1e6

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"phase": "profile_decode",
           "mode": mode_name,
           "slots": 8, "slot_lengths": SLOT_LENGTHS, "ticks": ticks,
           "host_ms_per_tick_median": statistics.median(host_ms),
           "host_ms_per_tick": host_ms,
           "profiled_window_ms_per_tick": window_us / 1e3 / ticks,
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
            device_events_per_tick=len(dev) / ticks,
            device_busy_ms_per_tick=busy / 1e3 / ticks,
            device_idle_share=1.0 - busy / 1e3 / ticks
            / statistics.median(host_ms),
            by_kernel=[{"name": name[:120],
                        "ms_per_tick": us / 1e3 / ticks,
                        "per_tick": n / ticks}
                       for name, (us, n) in top])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--eager", action="store_true",
                    help="run the tick program eagerly, not as its graph")
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=args.layers, n_heads=32,
        n_kv_heads=8, d_ff=16384, max_seq=512, dtype=torch.bfloat16,
        use_flash=True)
    gen = torch.Generator(device=device).manual_seed(0)
    engine = PagedLLMEngine(init_params_int8(gen, cfg, device=device), cfg,
                            PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    try:
        out = profile_ticks(engine, live_state(engine, cfg.vocab_size),
                            args.ticks, eager=args.eager)
    finally:
        engine.close()
    out["layers"] = args.layers
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
