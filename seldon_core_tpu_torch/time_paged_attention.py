"""Kernel K2's decode cases, and the kernel's time at each on the card.

    python -m seldon_core_tpu_torch.time_paged_attention [--reps 20]
        [--cases NAME ...] [--sweep]

``CASES`` are the paged-attention cases ``chip_smoke.py`` holds against the
plain version; :func:`make_inputs` builds each from a seeded generator on
the card, the same way for every checkout.  The command prints one JSON
line per case with the kernel's time (``ms``: ``cuda_timer.ColdTimer``,
median of ``--reps`` launches over a cold L2; ``ms_back_to_back``: the
mean of launches queued back to back) and the wrapper's split plan, or
null and the error where the kernel refuses the case.  ``--sweep`` also
times the kernel at every plan of 1, 2, 4, ... pages per block.

To time two checkouts' kernels on the same inputs on one card, copy this
file into the other checkout's ``seldon_core_tpu_torch/`` and run it
there too (its own build directory, its own kernel): the module uses only
``paged_attention_cuda(q, k_pages, v_pages, lengths, tables)`` and
``ColdTimer`` of the checkout it runs in.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch

__all__ = ["Case", "CASES", "make_inputs", "yardstick", "work", "main"]


class Case(NamedTuple):
    name: str
    S: int
    H: int
    Hkv: int
    D: int
    n_pages: int        # pool pages, trash page 0 included
    page_size: int
    lengths: tuple
    dtype: str          # "bfloat16" or "float32"
    trash: tuple = ()   # slots whose pages after the first are page 0
    timed: bool = False  # chip_smoke.py times it beside its yardsticks
    shared: int = 0     # leading pages every slot's table shares (a prefix)


# serve_7b's live slots at its first decode tick: prompts 5..120, +1
SERVE_LENGTHS = (6, 21, 36, 51, 66, 81, 96, 121)

CASES = (
    Case("7b_decode", 8, 32, 8, 128, 96, 16, SERVE_LENGTHS, "bfloat16",
         timed=True),
    Case("7b_decode_inactive_and_full_page", 8, 32, 8, 128, 96, 16,
         (0, 16, 32, 1, 17, 0, 200, 5), "bfloat16"),
    Case("llm_json_decode", 4, 4, 2, 16, 65, 16, (9, 16, 40, 0), "float32",
         timed=True),
    # long contexts: 18432 live tokens over 8 slots, and one slot of 8192
    Case("7b_decode_long", 8, 32, 8, 128, 1153, 16,
         tuple(512 * k for k in range(1, 9)), "bfloat16", timed=True),
    Case("7b_decode_one_long", 1, 32, 8, 128, 513, 16, (8192,), "bfloat16",
         timed=True),
    # the kernel's floor per launch: every slot inactive
    Case("7b_decode_all_inactive", 8, 32, 8, 128, 96, 16, (0,) * 8,
         "bfloat16", timed=True),
    # group sizes, head dims and types beside the main shape
    Case("g16", 8, 32, 2, 128, 64, 16, (1, 17, 100, 250, 0, 33, 64, 129),
         "bfloat16"),
    Case("mha_g1_d64", 8, 8, 8, 64, 48, 16, (3, 50, 200, 7, 0, 129, 16, 77),
         "bfloat16"),
    # float32 D256 takes 16-token chunks: a 64-row page is four of them
    Case("d256_f32", 4, 8, 2, 256, 12, 64, (5, 100, 300, 0), "float32"),
    # the 7B width with 64-page tables: partitions of 13 pages (208
    # tokens) on a 132-SM card; lengths on a partition boundary, one past
    # it, one short of it, and a slot (7) whose pages after the first are
    # the trash page
    Case("partition_edges", 8, 32, 8, 128, 192, 16,
         (208, 209, 416, 417, 1, 207, 1024, 100), "bfloat16", trash=(7,)),
    # a registered 192-token prefix aliased by 8 slots: the same 12 page
    # ids lead every table, each slot's own pages after them
    Case("7b_decode_shared_prefix", 8, 32, 8, 128, 96, 16,
         (200, 208, 215, 224, 231, 240, 193, 256), "bfloat16", timed=True,
         shared=12),
)


def make_inputs(case: Case, gen: torch.Generator) -> tuple:
    """(q, k_pages, v_pages, lengths, tables) on the card: each slot's
    pages drawn without repeats from the pool's pages 1.. (the first
    ``case.shared`` of them the same for every slot), the rest of its table
    row the trash page 0; unit-variance q, K and V."""
    dt = getattr(torch, case.dtype)
    S, ps = case.S, case.page_size
    pp = max(1, max(-(-n // ps) for n in case.lengths))
    perm = torch.randperm(case.n_pages - 1, generator=gen,
                          device="cuda") + 1
    tables = torch.zeros((S, pp), dtype=torch.int32, device="cuda")
    used = case.shared
    for s, n in enumerate(case.lengths):
        k = min(1, n) if s in case.trash else -(-n // ps)
        tables[s, :case.shared] = perm[:case.shared]
        tables[s, case.shared:k] = perm[used:used + k - case.shared]
        used += k - case.shared
    q = torch.randn((S, case.H, case.D), generator=gen, device="cuda").to(dt)
    shape = (case.Hkv, case.n_pages, ps, case.D)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dt)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dt)
    lens = torch.tensor(case.lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, lens, tables


def yardstick(q, kp, vp, lens, tables):
    """One PyTorch call per step computing the same function: gather the
    slots' pages, then ``scaled_dot_product_attention`` with the length
    mask (K/V repeated over each group's query heads)."""
    S, H, D = q.shape
    Hkv, _, ps, _ = kp.shape
    T = tables.shape[1] * ps
    g = H // Hkv
    mask = (torch.arange(T, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]

    def call():
        kg = kp[:, tables].reshape(Hkv, S, T, D).transpose(0, 1)
        vg = vp[:, tables].reshape(Hkv, S, T, D).transpose(0, 1)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kg.repeat_interleave(g, 1),
            vg.repeat_interleave(g, 1), attn_mask=mask)

    return call


def work(case: Case) -> tuple:
    """(bytes, operations) the function needs at this case: q, the live
    K/V rows (a shared page's once), lengths, tables and the float32 output
    once each; 4 flops per query head and live K/V element."""
    isz = 2 if case.dtype == "bfloat16" else 4
    pp = max(1, max(-(-n // case.page_size) for n in case.lengths))
    live = sum(min(n, pp * case.page_size) for n in case.lengths)
    shared_rows = case.shared * case.page_size
    distinct = live - (case.S - 1) * shared_rows
    nbytes = (case.S * case.H * case.D * isz
              + 2 * distinct * case.Hkv * case.D * isz
              + 4 * case.S + 4 * case.S * pp + case.S * case.H * case.D * 4)
    return nbytes, 4.0 * case.H * case.D * live


def back_to_back_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``reps`` launches queued back to back between two events:
    no flush, so the L2 holds what the previous launch left (all of it for
    small cases; for cases above the 50 MB L2 it is mostly cold, but holds
    no dirty lines of a flush to write back)."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="case names (default: all)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every split plan of 1, 2, 4, .. pages "
                         "per block (this checkout's wrapper only)")
    args = ap.parse_args(argv)
    from seldon_core_tpu_torch.cuda_timer import ColdTimer
    from seldon_core_tpu_torch.runtime import paged

    timer = ColdTimer()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1234)
    plan_of = getattr(paged, "kernel_split_plan", None)  # absent before
    rows = []                                             # the split
    for case in CASES:
        if args.cases and case.name not in args.cases:
            continue
        q, kp, vp, lens, tables = make_inputs(case, gen)
        pp = tables.shape[1]
        row = {"case": case.name, "ms": None}
        if plan_of is not None:
            plan = plan_of(case.S, case.H, case.Hkv, case.D, case.page_size,
                           pp, q.element_size(), sms)
            row.update(n_split=plan.n_split, pages_per_split=plan.pages)
        call = lambda: paged.paged_attention_cuda(  # noqa: E731
            q, kp, vp, lens, tables)
        try:
            row["ms"] = timer(call, reps=args.reps)
            row["ms_back_to_back"] = back_to_back_ms(call, args.reps)
        except (ValueError, RuntimeError) as e:
            row["error"] = str(e)
        rows.append(row)
        print(json.dumps(row), flush=True)
        pages = 1
        while args.sweep and plan_of is not None and pages <= pp:
            plan = paged.SplitPlan(-(-pp // pages), pages)
            ms = timer(lambda: paged.paged_attention_cuda(
                q, kp, vp, lens, tables, plan=plan), reps=args.reps)
            print(json.dumps({"case": case.name, "sweep_n_split":
                              plan.n_split, "sweep_pages": pages, "ms": ms}),
                  flush=True)
            pages *= 2
        del q, kp, vp
    return rows


if __name__ == "__main__":
    main()
