"""Training, and the MoE serving path, over a mesh whose dp, pp and tp axes
cross process boundaries (``parallel/mesh.py`` ``process_mesh(...,
plan=)``, ``runtime/multihost.py`` ``run_multihost_training``), against
the reference and the port's single controller on the CPU.

- The reference's two training dryrun lines, from its params and batch
  (converted), letter for letter in every process at 2 x 4 and 4 x 2
  processes x ranks, and the (dp=2,pp=1,tp=2) line at 2 x 2.
- The params after the step, and their gradients, against the single
  controller's on the same inputs: bitwise, at both layouts and both plans
  (every move sums in float32 in rank order, and a leaf that several ranks
  use sums their gradients in rank order, in one process as across
  several).
- The gradients within 1e-5 of ``jax.grad(lm_loss)`` on the reference's
  mesh; a piece several processes keep bitwise equal in each of them;
  the MoE's routing (the experts chosen, the buffer slots, the drops)
  EQUAL the single controller's.
- The MoE's ``prefill`` and ``decode_step`` over 2 processes x 2 ranks at
  tp = 4 and at dp = 2, tp = 2 (the experts over dp): logits within the
  reference's by ``LOGIT_ATOL`` (``tests/test_torch_train.py``'s), ids
  EQUAL.
- The exchange layer: an exchange over every line of the mesh (a line
  that two of four processes span runs in its own gloo group), and every
  move's backward against the single controller's gradients, over 2 and 4
  processes, in bf16 and float32, bitwise.
- Each of the seven paths a process-spanning mesh was refused on until now
  (``forward``, ``lm_loss``, ``make_train_step``, the MoE in serving,
  ``moe_forward``, ``pipeline_apply``, ``ring_attention_sharded``) over 2
  processes x 2 ranks, bitwise the single controller's.

Every spawning test runs its processes (2 ranks each unless stated) under
a deadline of its own on free ports; the pytest process never joins a
process group.  Run this file as a script with ``--worker MODE OUT`` to
get one worker.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.dryrun import (
    TRAINING_PLANS,
    dryrun_config,
    dryrun_training,
    plan_label,
)
from seldon_core_tpu_torch.parallel import mesh as M
from seldon_core_tpu_torch.runtime import multihost as MH

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120.0
LOGIT_ATOL = 2e-4  # tests/test_torch_train.py's
GRAD_ATOL = 1e-5
#: (processes, ranks a process) of the two 8-rank layouts
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}
PLANS = {plan_label(M.plan_mesh(8, **kw)): kw for kw in TRAINING_PLANS}


# ----------------------------------------------------------------------
# spawning
# ----------------------------------------------------------------------

def _spawn(n: int, args: list, out: Path) -> list:
    """``n`` processes of this file under the env contract on a free port,
    all killed past the deadline; each writes under ``out``.  Returns
    their logs."""
    from seldon_core_tpu_torch.serving.workers import pick_free_port

    port = pick_free_port()
    procs = []
    for i in range(n):
        env = {**os.environ, MH.ENV_NUM_HOSTS: str(n),
               MH.ENV_WORKER_ID: str(i),
               MH.ENV_COORDINATOR: f"127.0.0.1:{port}",
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", *args, str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=DEADLINE_S)
            logs.append(log)
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree_np(tree, prefix: str = "") -> dict:
    return {k: t.detach().cpu().numpy()
            for k, t in M.leaf_items(tree, prefix)}


def _grads_np(tree, prefix: str = "") -> dict:
    return {k: t.grad.cpu().numpy() for k, t in M.leaf_items(tree, prefix)
            if t.grad is not None}


# ----------------------------------------------------------------------
# workers (run in the spawned processes)
# ----------------------------------------------------------------------

def train_worker(ranks_per_process: int, plans: str, inputs: str,
                 out: str) -> None:
    """The runtime's training worker on the given plans, with each MoE
    routing at the routing rank recorded (``w<process>_routing.npz``)."""
    import torch.distributed as dist

    from seldon_core_tpu_torch.parallel import moe

    routed = []
    plain = moe.moe_route

    def recording(x, router, cfg):
        r = plain(x, router, cfg)
        routed.append({k: r[k].detach().cpu().numpy()
                       for k in ("gate_idx", "slot", "kept")})
        return r

    moe.moe_route = recording
    rank = int(os.environ[MH.ENV_WORKER_ID])
    MH._train_worker(ranks_per_process, "cpu",
                     [MH._parse_plan(p) for p in plans.split(",")], inputs,
                     out)
    assert not dist.is_initialized()
    np.savez(os.path.join(out, f"w{rank}_routing.npz"),
             **{f"{i}/{k}": v for i, r in enumerate(routed)
                for k, v in r.items()})


def serve_worker(out: str) -> None:
    """The MoE's prefill and decode_step over 2 x 2 at tp = 4 and at
    dp = 2, tp = 2, on the reference's params (``serve_inputs.npz``)."""
    import torch.distributed as dist

    from seldon_core_tpu_torch.models import transformer as T

    assert MH.maybe_initialize_distributed()
    torch.set_num_threads(2)
    z = _load(Path(out) / "serve_inputs.npz")
    params = MH._unflat(z, "params/")
    ids = torch.from_numpy(z["ids"])
    tok = torch.from_numpy(z["tok"])
    cfg = _serve_cfg()
    res = {}
    for name, plan in SERVE_LAYOUTS.items():
        mesh = M.process_mesh(["cpu"] * 2, plan=plan)
        tp = T.shard_params(params, mesh, cfg)
        with torch.no_grad():
            logits, _ = T.prefill(tp, ids, cfg, max_len=12, logit_pos=7,
                                  mesh=mesh)
            cache = T.init_cache(cfg, 2, max_len=12, mesh=mesh)
            for t in range(ids.shape[1]):
                _, cache = T.decode_step(tp, cache, ids[:, t], cfg,
                                         mesh=mesh)
            logits2, _ = T.decode_step(tp, cache, tok, cfg, mesh=mesh)
        res[f"{name}/prefill"] = logits.numpy()
        res[f"{name}/decode"] = logits2.numpy()
    np.savez(os.path.join(out, f"w{dist.get_rank()}.npz"), **res)
    dist.destroy_process_group()


def exchange_worker(out: str) -> None:
    """The exchange layer across processes: exchanges over every line of
    the mesh, and every move's gradients."""
    import torch.distributed as dist

    assert MH.maybe_initialize_distributed()
    torch.set_num_threads(1)
    n_proc = dist.get_world_size()
    res = {}
    mesh = M.process_mesh(["cpu"] * 2, plan=_exchange_plan(n_proc))
    res.update(_subgroup_exchanges(mesh))
    for dname, dtype in DTYPES.items():
        for coll in MOVES:
            res.update(_move_grads(mesh, coll, dname, dtype))
    np.savez(os.path.join(out, f"w{dist.get_rank()}.npz"), **res)
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# the exchange layer: shared by the workers and the single controller
# ----------------------------------------------------------------------

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
MOVES = ("psum", "psum_scatter", "all_gather", "ppermute", "all_to_all",
         "scatter", "gather")


def _exchange_plan(n_proc: int):
    # 2 processes: tp spans both; 4: dp = 2 with each tp line over two
    return M.MeshPlan(tp=4) if n_proc == 2 else M.MeshPlan(dp=2, tp=4)


def _seeded(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _subgroup_exchanges(mesh) -> dict:
    """An exchange of each rank's seeded tensor over every line of the
    mesh (a dp line spans processes 0 and 2 at 4 x 2, a tp line 0 and
    1): what each process receives, by line and rank."""
    res = {}
    for axis in mesh.axis_names:
        others = [a for a in mesh.axis_names if a != axis]
        for coords in np.ndindex(*[mesh.axis_size(a) for a in others]):
            devs = mesh.axis_devices(axis, **dict(zip(others, coords)))
            parts = [None if d is None else _seeded((3, 5), 100 + r)
                     for r, d in zip(devs.ids, devs)]
            if all(p is None for p in parts):
                continue
            for r, t in zip(devs.ids, M._exchange(parts, devs)):
                res[f"exchange/{axis}{coords}/{r}"] = t.numpy()
    return res


def _move_grads(mesh, coll: str, dname: str, dtype) -> dict:
    """One move over the first tp line of ``mesh`` (and, for scatter and
    gather, rank 0 of it as the source or the destination), a seeded
    weighted sum of its outputs as the loss: the gradient of every input
    this process holds."""
    devs = mesh.axis_devices("tp")
    n = len(devs)
    held = [d is not None for d in devs]
    xs = [_seeded((2, 4 * n, 2 * n), 10 + r, dtype).requires_grad_()
          if h else None for r, h in enumerate(held)]
    with M.exchange_tape(mesh) as tape:
        if coll == "scatter":
            src = devs.ids[0]
            x = xs[0]
            outs = M.scatter(x, src, devs, lambda x: [
                (slice(None), slice(4 * r, 4 * r + 4)) if r % 2 else
                (slice(None),) for r in range(n)])
        elif coll == "gather":
            y = M.gather(xs, devs, devs.ids[0],
                         lambda ps: torch.cat(ps, dim=1),
                         lambda c: list(torch.chunk(c, n, dim=1)))
            outs = [y] + [None] * (n - 1)
        else:
            kw = {"psum": {}, "psum_scatter": {"dim": 1},
                  "all_gather": {"dim": 2}, "ppermute": {},
                  "all_to_all": {"split_dim": 1, "concat_dim": 2}}[coll]
            outs = list(getattr(M, coll)(xs, ranks=devs, **kw))
        loss = None
        for r, o in enumerate(outs):
            if o is None:
                continue
            term = (o.float() * _seeded(tuple(o.shape), 50 + r)).sum()
            loss = term if loss is None else loss + term
        if loss is None:
            loss = torch.zeros(())
        if tape is not None:
            loss = tape.close(loss)
    if loss.requires_grad:
        loss.backward()
    return {f"grad/{coll}/{dname}/{r}": x.grad.float().numpy()
            for r, x in enumerate(xs) if x is not None and x.grad is not None}


def _moe_case(mesh) -> dict:
    from seldon_core_tpu_torch.parallel.moe import (
        MoEConfig,
        init_moe_params,
        moe_forward,
        moe_param_specs,
    )

    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=1.0, d_model=16,
                    d_ff=32)
    raw = init_moe_params(torch.Generator().manual_seed(3), cfg)
    specs = moe_param_specs(cfg)
    placed = {k: M.place(v, M.named_sharding(mesh, *specs[k]))
              for k, v in raw.items()}
    y, aux = moe_forward(placed, _seeded((24, 16), 4), cfg, mesh=mesh)
    return {"y": y, "aux": aux}


def _pipeline_case(mesh) -> dict:
    from seldon_core_tpu_torch.parallel.pipeline import pipeline_apply

    placed = M.place(_seeded((2, 6, 6), 5),
                     M.named_sharding(mesh, "pp", None, None))
    x = _seeded((4, 6), 6) if mesh.owner(0) == mesh.me else None

    def stage(p, a, s):
        return None if a is None else torch.tanh(a @ p[0].to(a.device))

    y = pipeline_apply(stage, placed, x, mesh, n_microbatches=2)
    return {} if y is None else {"y": y}


def _ring_case(mesh) -> dict:
    from seldon_core_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded,
    )

    q, k, v = (_seeded((2, 8, 2, 4), s) for s in (7, 8, 9))
    return {"out": ring_attention_sharded(q, k, v, mesh)}


def _small_model(mesh):
    """A 2-layer MoE transformer (2 experts top-1, 2 heads), seeded, placed
    over ``mesh``, and a seeded batch."""
    from seldon_core_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=32, d_model=16, n_layers=2,
                              n_heads=2, d_ff=32, max_seq=16, n_experts=2,
                              top_k=1, dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(11), cfg)
    ids = torch.randint(0, 32, (4, 9), generator=torch.Generator()
                        .manual_seed(12))
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    return cfg, T.shard_params(params, mesh, cfg), batch


def _forward_case(mesh) -> dict:
    from seldon_core_tpu_torch.models import transformer as T

    cfg, params, batch = _small_model(mesh)
    with torch.no_grad():
        logits, aux = T.forward(params, batch["input_ids"], cfg, mesh=mesh)
    return {"logits": logits, "aux": aux}


def _lm_loss_case(mesh) -> dict:
    from seldon_core_tpu_torch.models import transformer as T

    cfg, params, batch = _small_model(mesh)
    for t in T.param_leaves(params):
        t.requires_grad_()
    loss = T.lm_loss(params, batch, cfg, mesh=mesh)
    loss.backward()
    return {"loss": loss.detach(),
            **{f"grad/{k}": t.grad for k, t in M.leaf_items(params)}}


def _train_step_case(mesh) -> dict:
    from seldon_core_tpu_torch.models import transformer as T

    cfg, params, batch = _small_model(mesh)
    init_opt, step = T.make_train_step(cfg, mesh=mesh, learning_rate=1e-2)
    opt = init_opt(params)
    out = {}
    for i in range(2):
        params, opt, loss = step(params, opt, batch)
        out[f"loss{i}"] = loss
    return {**out, **{k: t.detach() for k, t in M.leaf_items(params)}}


def _moe_serving_case(mesh) -> dict:
    """``ffn_block`` with a MoE over the mesh, as prefill runs it: every
    row in every process."""
    from seldon_core_tpu_torch.models import transformer as T

    cfg, params, _ = _small_model(mesh)
    p = T._layer_params(params["blocks"], 1)
    with torch.no_grad():
        y, aux = T.ffn_block(p, _seeded((4, 8, 16), 13), cfg, mesh=mesh)
    return {"y": y, "aux": aux}


#: the seven paths a process-spanning mesh was refused on, each with its
#: mesh plan over 2 processes x 2 ranks and its case
PARITY = {
    "forward": (M.MeshPlan(dp=2, tp=2), _forward_case),
    "lm_loss": (M.MeshPlan(dp=2, tp=2), _lm_loss_case),
    "make_train_step": (M.MeshPlan(dp=2, tp=2), _train_step_case),
    "moe_serving": (M.MeshPlan(dp=2, tp=2), _moe_serving_case),
    "moe_forward": (M.MeshPlan(dp=2, tp=2), _moe_case),
    "pipeline_apply": (M.MeshPlan(pp=2, tp=2), _pipeline_case),
    "ring_attention_sharded": (M.MeshPlan(tp=4), _ring_case),
}


def parity_worker(out: str) -> None:
    import torch.distributed as dist

    assert MH.maybe_initialize_distributed()
    torch.set_num_threads(1)
    res = {}
    for name, (plan, fn) in PARITY.items():
        mesh = M.process_mesh(["cpu"] * 2, plan=plan)
        for k, t in fn(mesh).items():
            res[f"{name}/{k}"] = t.detach().numpy()
    np.savez(os.path.join(out, f"w{dist.get_rank()}.npz"), **res)
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# the reference and the single controller
# ----------------------------------------------------------------------

def _host(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _reference_plan(kw: dict, n: int) -> dict:
    """The reference's line for one plan on ``n`` of conftest's devices,
    its params and batch, its gradients of ``lm_loss`` on its mesh, and
    the port's single controller's step from the same inputs (its line,
    its params and gradients after the step, its routing)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _dryrun_one_plan
    from seldon_core_tpu.models import transformer as J
    from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
    from seldon_core_tpu.parallel.mesh import plan_mesh as jplan_mesh
    from seldon_core_tpu_torch.convert import params_from_jax
    from seldon_core_tpu_torch.parallel import moe

    want = _dryrun_one_plan(jplan_mesh(n, **kw))
    plan = M.plan_mesh(n, **kw)
    cfg = dryrun_config(plan)
    jc = J.TransformerConfig(
        **{f: getattr(cfg, f) for f in (
            "vocab_size", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
            "n_experts", "top_k", "attention", "seq_shard", "use_flash")},
        dtype=jnp.float32)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    B, L = max(4, 2 * plan.dp), 16
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, L + 1), 0,
                                        jc.vocab_size))
    tbatch = {"input_ids": torch.from_numpy(ids[:, :-1].copy()),
              "targets": torch.from_numpy(ids[:, 1:].copy()),
              "mask": torch.ones((B, L))}
    jm = jmake_mesh(n_devices=n, tp=plan.tp, pp=plan.pp)
    nm = 2 if plan.pp > 1 else 1
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    _, jg = jax.jit(jax.value_and_grad(
        lambda p: J.lm_loss(p, jbatch, jc, jm, plan.pp, nm)))(
        J.shard_params(params, jm, jc, pp=plan.pp))
    one = M.make_mesh(plan, devices=["cpu"] * n)
    label = plan_label(plan)
    routed = []
    plain = moe.moe_route

    def recording(x, router, c):
        r = plain(x, router, c)
        routed.append({k: r[k].detach().cpu().numpy()
                       for k in ("gate_idx", "slot", "kept")})
        return r

    moe.moe_route = recording
    try:
        line, loss, placed = dryrun_training(
            plan, "cpu", params=params_from_jax(_host(params)), batch=tbatch)
    finally:
        moe.moe_route = plain
    return {
        "want": want, "plan": plan, "label": label,
        "inputs": (params_from_jax(_host(params)), tbatch),
        "jax_grads": _tree_np(params_from_jax(_host(jg), mesh=one, cfg=cfg,
                                              pp=plan.pp), label),
        "line": line, "loss": loss,
        "params": _tree_np(placed, label), "grads": _grads_np(placed, label),
        "routing": routed,
    }


@pytest.fixture(scope="module")
def references():
    return {label: _reference_plan(kw, 8) for label, kw in PLANS.items()}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def trained(request, references, tmp_path_factory):
    """The workers' step at one layout, both plans, from the reference's
    inputs: their JSON lines, their pieces and gradients, their routing."""
    layout = request.param
    n_proc, per = LAYOUTS[layout]
    tmp = tmp_path_factory.mktemp(f"train{layout}")
    inputs = MH.write_training_inputs(
        str(tmp / "inputs.npz"),
        {label: ref["inputs"] for label, ref in references.items()})
    logs = _spawn(n_proc, ["train", str(per), ",".join(references), inputs],
                  tmp)
    lines = [json.loads([ln for ln in log.splitlines()
                         if ln.startswith("{")][-1]) for log in logs]
    return {"layout": layout, "lines": lines,
            "pieces": [_load(tmp / f"w{i}.npz") for i in range(n_proc)],
            "routing": [_load(tmp / f"w{i}_routing.npz")
                        for i in range(n_proc)]}


# ----------------------------------------------------------------------
# training across processes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("label", sorted(PLANS))
def test_training_lines_across_processes_are_the_references(trained,
                                                            references,
                                                            label):
    ref = references[label]
    for proc in trained["lines"]:
        got = {p["plan"]: p for p in proc["plans"]}[label]
        assert got["line"] == ref["want"] == ref["line"]
        assert got["replicas"]["equal"] and got["replicas"]["leaves"] > 0
    want_loss = {"dp2pp2tp2": "5.4837", "dp2pp1tp4": "5.4265"}[label]
    assert ref["want"].endswith(f"loss={want_loss}")


@pytest.mark.parametrize("label", sorted(PLANS))
def test_params_after_the_step_equal_the_single_controller(trained,
                                                           references,
                                                           label):
    """Every piece each process keeps, and its gradient, bitwise the
    single controller's."""
    ref = references[label]
    seen = set()
    for pieces in trained["pieces"]:
        for key, got in pieces.items():
            kind, name = key.split("/", 1)
            if not name.startswith(label):
                continue
            seen.add(name)
            want = ref["params" if kind == "param" else "grads"][name]
            assert np.array_equal(got, want), key
    assert seen == set(ref["params"])  # every piece is held somewhere


@pytest.mark.parametrize("label", sorted(PLANS))
def test_gradients_match_jax_grad(trained, references, label):
    ref = references[label]
    for pieces in trained["pieces"]:
        for key, got in pieces.items():
            if key.startswith(f"grad/{label}"):
                name = key[len("grad/"):]
                np.testing.assert_allclose(got, ref["jax_grads"][name],
                                           atol=GRAD_ATOL, err_msg=name)


def test_replicated_pieces_are_bitwise_equal_between_processes(trained):
    by_key: dict = {}
    for pieces in trained["pieces"]:
        for key, value in pieces.items():
            by_key.setdefault(key, []).append(value)
    shared = {k: v for k, v in by_key.items() if len(v) > 1}
    assert any(k.startswith("param/") for k in shared)
    for key, values in shared.items():
        assert all(np.array_equal(v, values[0]) for v in values), key


def test_moe_routing_is_equal_to_the_single_controller(trained, references):
    """Routing runs on each stage's first rank over the global batch:
    every routing of the step (the experts chosen, the buffer slots, the
    drops), over every process, EQUAL the single controller's."""

    def records(z):
        n = len(z) // 3
        return [tuple(z[f"{i}/{k}"].tobytes() for k in
                      ("gate_idx", "slot", "kept")) for i in range(n)]

    got = sorted(r for z in trained["routing"] for r in records(z))
    want = sorted(tuple(r[k].tobytes() for k in ("gate_idx", "slot", "kept"))
                  for label in references
                  for r in references[label]["routing"])
    assert want and got == want


def test_training_at_2x2_through_the_runtime(tmp_path):
    """``run_multihost_training`` at 2 processes x 2 ranks on the
    reference's inputs for (dp=2,pp=1,tp=2): its line is the reference's
    at that plan, in both processes."""
    ref = _reference_plan(dict(tp=2, pp=1), 4)
    assert ref["want"] == (
        "mesh(dp=2,pp=1,tp=2) attention=ring sp=ring experts=2 loss=5.4265")
    inputs = MH.write_training_inputs(str(tmp_path / "in.npz"),
                                      {ref["label"]: ref["inputs"]})
    r = MH.run_multihost_training(2, 2, timeout=DEADLINE_S, device="cpu",
                                  plans=[ref["plan"]], inputs=inputs)
    assert [p["line"] for p in r["plans"]] == [ref["want"]]
    assert [p["plan"] for p in r["processes"][0]["plans"]] == [ref["label"]]


# ----------------------------------------------------------------------
# the MoE in serving across processes
# ----------------------------------------------------------------------

SERVE_LAYOUTS = {"tp4": M.MeshPlan(tp=4), "dp2_tp2": M.MeshPlan(dp=2, tp=2)}


def _serve_cfg():
    from seldon_core_tpu_torch.models import transformer as T

    return T.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                               n_heads=4, d_ff=64, max_seq=32, n_experts=4,
                               top_k=2, use_flash=True, dtype=torch.float32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's prefill and decode_step over its mesh at each
    layout, and the port's over 2 processes x 2 ranks."""
    import jax
    import jax.numpy as jnp

    from seldon_core_tpu.models import transformer as J
    from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
    from seldon_core_tpu_torch.convert import params_from_jax

    c = _serve_cfg()
    jc = J.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, d_ff=64, max_seq=32, n_experts=4,
                             top_k=2, use_flash=True, dtype=jnp.float32)
    assert c.d_model == jc.d_model
    params = J.init_params(jax.random.PRNGKey(0), jc)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                        64))
    want = {}
    tok = None
    for name, plan in SERVE_LAYOUTS.items():
        jm = jmake_mesh(n_devices=4, tp=plan.tp, pp=1)
        jp = J.shard_params(params, jm, jc)
        jl, jcache = jax.jit(lambda p, i: J.prefill(
            p, i, jc, max_len=12, logit_pos=7, mesh=jm))(jp, jnp.asarray(ids))
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tok = t if tok is None else tok
        assert np.array_equal(t, tok)
        jl2, _ = jax.jit(lambda p, cc, tt: J.decode_step(
            p, cc, tt, jc, mesh=jm))(jp, jcache, jnp.asarray(tok))
        want[name] = (np.asarray(jl), np.asarray(jl2))
    tmp = tmp_path_factory.mktemp("serve")
    np.savez(tmp / "serve_inputs.npz", ids=ids, tok=tok,
             **MH._flat(params_from_jax(_host(params)), "params/"))
    _spawn(2, ["serve"], tmp)
    return want, tok, [_load(tmp / f"w{i}.npz") for i in range(2)]


@pytest.mark.parametrize("layout", sorted(SERVE_LAYOUTS))
def test_moe_serving_across_processes_matches_the_reference(served, layout):
    want, tok, got = served
    for res in got:
        prefill, decode = res[f"{layout}/prefill"], res[f"{layout}/decode"]
        np.testing.assert_allclose(prefill, want[layout][0], atol=LOGIT_ATOL)
        np.testing.assert_array_equal(prefill.argmax(-1), tok)
        np.testing.assert_allclose(decode, want[layout][1], atol=LOGIT_ATOL)
        np.testing.assert_array_equal(decode.argmax(-1),
                                      want[layout][1].argmax(-1))
    assert np.array_equal(got[0][f"{layout}/decode"],
                          got[1][f"{layout}/decode"])


# ----------------------------------------------------------------------
# the exchange layer
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def exchanged(request, tmp_path_factory):
    n_proc = request.param
    tmp = tmp_path_factory.mktemp(f"exchange{n_proc}")
    _spawn(n_proc, ["exchange"], tmp)
    out = {}
    for i in range(n_proc):
        for k, v in _load(tmp / f"w{i}.npz").items():
            out.setdefault(k, []).append(v)
    return n_proc, out


def _single(plan) -> "M.Mesh":
    return M.make_mesh(plan, devices=["cpu"] * plan.n_devices)


def test_subgroup_exchange_equals_every_ranks_tensor(exchanged):
    n_proc, out = exchanged
    mesh = _single(_exchange_plan(n_proc))
    want = _subgroup_exchanges(mesh)
    got_keys = {k for k in out if k.startswith("exchange/")}
    assert got_keys == set(want)
    for k, values in out.items():
        if k.startswith("exchange/"):
            for v in values:  # every process that took part got them all
                assert np.array_equal(v, want[k]), k
    if n_proc == 4:  # a dp line spans processes 0 and 2 only
        assert (0, 2) in _spawned_sets(mesh, n_proc)


def _spawned_sets(mesh, n_proc):
    owned = M.Mesh(mesh.devices, mesh.axis_names,
                   owners=[r // 2 for r in range(mesh.devices.size)], me=0)
    return M._spanned_process_sets(owned)


@pytest.mark.parametrize("coll", MOVES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_move_backward_across_processes_equals_the_single_controller(
        exchanged, coll, dtype):
    n_proc, out = exchanged
    want = _move_grads(_single(_exchange_plan(n_proc)), coll, dtype,
                       DTYPES[dtype])
    got = {k: v[0] for k, v in out.items() if k.startswith(
        f"grad/{coll}/{dtype}/")}
    assert set(got) == set(want) and want
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    _spawn(2, ["parity"], tmp)
    return [_load(tmp / f"w{i}.npz") for i in range(2)]


@pytest.mark.parametrize("what", sorted(PARITY))
def test_what_was_refused_across_processes_equals_the_single_controller(
        parity, what):
    """Each of the seven paths a process-spanning mesh was refused on
    until now, over 2 processes x 2 ranks, against the single controller
    on 4 ranks of the CPU: bitwise."""
    plan, fn = PARITY[what]
    want = {k: t.detach().numpy() for k, t in fn(_single(plan)).items()}
    seen = set()
    for res in parity:
        for key, got in res.items():
            if key.startswith(f"{what}/"):
                name = key[len(what) + 1:]
                seen.add(name)
                assert np.array_equal(got, want[name]), (what, name)
    assert seen == set(want)


if __name__ == "__main__":
    mode = sys.argv[2]
    if mode == "train":
        train_worker(int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    elif mode == "serve":
        serve_worker(sys.argv[3])
    elif mode == "parity":
        parity_worker(sys.argv[3])
    else:
        exchange_worker(sys.argv[3])
