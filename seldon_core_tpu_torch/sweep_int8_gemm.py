"""Time K1's ``"mma_gemm"`` schedule under every plan at the 7B prefill
shapes, on one card.

    python -m seldon_core_tpu_torch.sweep_int8_gemm

For M in (32, 128) and each projection of a 7B-class layer plus the
lm_head, every plan (tile rows 32/64/128, K splits 1-16) is checked bit for bit against the plain version and
timed over a cold L2 (``cuda_timer.ColdTimer``, median of 20) in each of 3
rounds over the plans; a plan's time is its fastest round.  Prints one JSON line per
plan, then per shape the fastest plan beside the one ``gemm_plan`` picks,
and the card as ``nvidia-smi`` names it.  Measurement only: the port never
calls this module.
"""

from __future__ import annotations

import json
import subprocess

import torch

from seldon_core_tpu_torch.cuda_timer import ColdTimer
from seldon_core_tpu_torch.ops import quant

ROUNDS = 3
SHAPES = [("wq_wo", 4096, 4096), ("wk_wv", 4096, 1024), ("w1", 4096, 16384),
          ("w2", 16384, 4096), ("lm_head", 4096, 32000)]


def _plans(M: int, K: int, N: int, sms: int):
    nk = -(-K // 128)
    for bm in (32, 64, 128):
        tiles = -(-M // bm) * -(-N // 128)
        for splits in (1, 2, 4, 8, 16):
            if splits > nk or (splits > 1 and tiles * splits > 4 * sms):
                continue
            yield quant.GemmPlan(bm, splits)


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    timer = ColdTimer()
    best = []
    for M in (32, 128):
        for name, K, N in SHAPES:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = quant.quantize_int8(
                torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5)
            ref = quant.int8_matmul_ref(x, w.values, w.scales, torch.bfloat16)
            plans = list(_plans(M, K, N, sms))
            for plan in plans:
                got = quant.int8_matmul_cuda(x, w.values, w.scales,
                                             torch.bfloat16, plan=plan)
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} M{M} {plan}: not bitwise "
                                         f"equal to the plain version")
            # ROUNDS passes over the plans, each plan keeping its fastest
            # median: a slow spell of the card then spoils one round only
            best_of = {}
            for _ in range(ROUNDS):
                for plan in plans:
                    ms = timer(lambda plan=plan: quant.int8_matmul_cuda(
                        x, w.values, w.scales, torch.bfloat16, plan=plan))
                    best_of[plan] = min(ms, best_of.get(plan, ms))
            rows = [(ms, plan) for plan, ms in best_of.items()]
            for ms, plan in rows:
                print(json.dumps({"shape": f"{name} {M}x{K}x{N}",
                                  "plan": plan._asdict(), "ms": ms,
                                  "bitwise_equal": True, "card": card}),
                      flush=True)
            chosen = quant.gemm_plan(M, K, N, sms)
            chosen_ms = next(ms for ms, p in rows if p == chosen)
            ms, plan = min(rows)
            best.append({"shape": f"{name} {M}x{K}x{N}",
                         "best": plan._asdict(), "best_ms": ms,
                         "gemm_plan": chosen._asdict(),
                         "gemm_plan_ms": chosen_ms})
    print(json.dumps({"best": best, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
