"""One full train step of the MoE transformer over one mesh plan (the
port's counterpart of ``__graft_entry__.py`` ``_dryrun_one_plan``).

Every rank of the plan's mesh is one device (``device`` repeated: the CPU,
or one card), so a plan of 8 ranks runs anywhere.  The configuration is
the reference's: 2 layers per stage, d_model 64, 4 heads, d_ff 128,
vocabulary 128, ``max(2, dp)`` experts with top-1 routing, float32; ring
attention with sequence sharding where tp > 1 and pp = 1, else dense
attention through the flash kernel with Megatron sequence parallelism.
The batch is ``max(4, 2 * dp)`` rows of 16 tokens.  Given the reference's
params (converted) and its batch, the summary line equals the reference's
letter for letter; without them the weights and the data are seeded here.

The reference's two multi-host lines come from
``runtime/multihost.py`` ``run_multihost_dryrun`` (two processes of
``n_devices // 2`` ranks each), in the reference's words
(:func:`multihost_lines`).  The same training step runs over a mesh whose
ranks span processes (``dryrun_training(..., mesh=process_mesh(...))``;
``runtime/multihost.py`` ``run_multihost_training`` spawns them) and
prints the same line.

Run both of the reference's training lines and its two multi-host lines::

    python -m seldon_core_tpu_torch.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    make_train_step,
    shard_params,
)
from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    MeshPlan,
    make_mesh,
    plan_mesh,
)

__all__ = ["dryrun_config", "dryrun_batch", "dryrun_training",
           "multihost_lines", "plan_label", "TRAINING_PLANS"]

#: the reference's two training plans on 8 devices (``dryrun_multichip``)
TRAINING_PLANS = (dict(tp=2, pp=2), dict(tp=4, pp=1))


def dryrun_config(plan: MeshPlan) -> TransformerConfig:
    ring = plan.tp > 1 and plan.pp == 1
    return TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2 * plan.pp, n_heads=4,
        d_ff=128, max_seq=64, n_experts=max(2, plan.dp), top_k=1,
        dtype=torch.float32, attention="ring" if ring else "dense",
        seq_shard=plan.tp > 1, use_flash=not ring)


def dryrun_batch(plan: MeshPlan, cfg: TransformerConfig, device,
                 seed: int = 1) -> dict:
    """``max(4, 2 * dp)`` rows of 16 tokens drawn from a seeded generator;
    targets are the inputs shifted by one."""
    B, L = max(4, 2 * plan.dp), 16
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, L + 1), generator=gen,
                        device=device)
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:],
            "mask": torch.ones((B, L), dtype=torch.float32, device=device)}


def plan_label(plan: MeshPlan) -> str:
    return f"dp{plan.dp}pp{plan.pp}tp{plan.tp}"


def dryrun_training(plan: MeshPlan, device="cuda",
                    params: Optional[dict] = None,
                    batch: Optional[dict] = None,
                    mesh: Optional[Mesh] = None) -> tuple:
    """One AdamW step of :func:`dryrun_config`'s model over ``plan``, every
    rank on ``device``, or over ``mesh`` (the plan's shape, e.g. a
    ``process_mesh`` whose ranks span processes: every process calls it
    with the same params and batch).  ``params`` (an unplaced float tree,
    e.g. converted from the reference's) and ``batch`` default to seeded
    ones (weights from seed 0, data from seed 1).  Returns ``(summary line,
    loss, params after the step)``: this process's placed pieces."""
    if mesh is not None:
        device = mesh.first_local_device
    device = torch.device(device)
    cfg = dryrun_config(plan)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    if batch is None:
        batch = dryrun_batch(plan, cfg, device)
    if mesh is None:
        mesh = make_mesh(plan, devices=[device] * plan.n_devices)
    params = shard_params(params, mesh, cfg, pp=plan.pp)
    init_opt, step = make_train_step(
        cfg, mesh=mesh, pp=plan.pp,
        n_microbatches=2 if plan.pp > 1 else 1)
    opt_state = init_opt(params)
    params, opt_state, loss = step(params, opt_state, batch)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    line = (f"mesh(dp={plan.dp},pp={plan.pp},tp={plan.tp}) "
            f"attention={cfg.attention} "
            f"sp={'ring' if cfg.attention == 'ring' else 'megatron'} "
            f"experts={cfg.n_experts} loss={loss:.4f}")
    return line, loss, params


def multihost_lines(r: dict) -> list:
    """The reference's two multi-host summary lines of a
    ``run_multihost_dryrun`` result, word for word (its wording names the
    reference's backend)."""
    return [
        "multihost 2-process jax.distributed "
        f"LLMEngine tp={r['global_devices']} spanning processes, "
        "byte-identical to single-device decode ok",
        "multihost 2-process PagedLLMEngine "
        f"paged-KV x spec x ring-prefill x prefix-aliasing tp="
        f"{r['global_devices']} spanning processes: "
        f"{r['paged_requests']} requests byte-identical to plain decode, "
        f"{r['spec_rounds']} spec rounds, {r['pinned_pages']} shared "
        "pages pinned+returned per rank ok",
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-devices", type=int, default=8)
    args = ap.parse_args(argv)
    for kw in TRAINING_PLANS:
        line, _, _ = dryrun_training(plan_mesh(args.n_devices, **kw),
                                     args.device)
        print(f"dryrun_training OK: {line}", flush=True)
    from seldon_core_tpu_torch.runtime.multihost import run_multihost_dryrun

    r = run_multihost_dryrun(n_hosts=2,
                             devices_per_host=max(1, args.n_devices // 2),
                             device=args.device)
    for line in multihost_lines(r):
        print(f"dryrun_multichip OK: {line}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
