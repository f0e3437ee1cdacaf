"""Training in the port (``models/transformer.py`` ``forward``, ``lm_loss``,
``make_train_step``; ``dryrun.py``; the flash kernel's autograd Function)
against the reference's on the CPU: the reference's params (converted) and
numpy-seeded or the reference's own inputs, the reference over conftest's
virtual devices (its flash kernel in interpret mode), the port over repeats
of the CPU device.  Counterparts of ``tests/test_transformer.py:39-145`` and
of ``__graft_entry__.py`` ``_dryrun_one_plan``.

Tolerances: logits within 2e-4 (``tests/test_transformer.py``'s bound for
sharded against unsharded; seen up to a few 1e-6), the MoE aux within a
relative 1e-5, losses within 1e-5 and gradients within 1e-5 (float32, sums
in another order), each dryrun line's loss within 1e-4 of the
reference's.  AdamW is held to optax's ``adamw`` on identical gradients
within a relative 1e-6 (a few float32 ulps: torch applies the decay and the
step one after the other, optax adds them first).  Discrete outputs (greedy ids, the dryrun lines' text) are
EQUAL.  A comparison of params after a step leaves out the elements whose
gradient is below 1e-6 in magnitude: Adam's first step moves each element
by about ``lr * sign(g)``, and such a gradient's sign is rounding noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _dryrun_one_plan
from seldon_core_tpu.models import transformer as J
from seldon_core_tpu.ops import attention as jattn
from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu.parallel.mesh import plan_mesh as jplan_mesh
from seldon_core_tpu.runtime import checkpoint as jck
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.dryrun import (
    TRAINING_PLANS,
    dryrun_batch,
    dryrun_config,
    dryrun_training,
)
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.ops import attention as tattn
from seldon_core_tpu_torch.parallel.mesh import (
    Shards,
    make_mesh,
    plan_mesh,
    unshard,
)
from seldon_core_tpu_torch.runtime import checkpoint as tck

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
          max_seq=32)
LOGIT_ATOL = 2e-4
GRAD_ATOL = 1e-5


def _cfgs(**kw):
    kw = {**KW, **kw}
    return (J.TransformerConfig(**kw, dtype=jnp.float32),
            T.TransformerConfig(**kw, dtype=torch.float32))


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _ids(B, L, seed=1, vocab=64):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, L), 0,
                                         vocab))


def _grads(tree):
    """The gradient tree of a (placed) param tree, unsharded."""
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return unshard(Shards([_grads(t) for t in tree], tree.dim,
                              tree.axis))
    return tree.grad


def _unshard_tree(tree):
    if isinstance(tree, dict):
        return {k: _unshard_tree(v) for k, v in tree.items()}
    return unshard(tree)


def _assert_trees_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               err_msg=path)


# ---- forward ---------------------------------------------------------------

FORWARD = {
    "dense": (dict(), None),
    "flash": (dict(use_flash=True), None),
    "moe": (dict(n_experts=4, top_k=2), None),
    "moe_flash_gqa_drops": (dict(n_experts=4, top_k=2, use_flash=True,
                                 n_kv_heads=2, capacity_factor=0.5), None),
    "tp2_flash_seq_shard": (dict(use_flash=True), dict(n=4, tp=2)),
    "tp2_dense_no_seq_shard": (dict(seq_shard=False), dict(n=4, tp=2)),
    "ring_tp4": (dict(attention="ring"), dict(n=8, tp=4)),
    "ring_tp4_chunked": (dict(attention="ring", ring_kv_chunk=2),
                         dict(n=8, tp=4)),
    "moe_dp2_tp2_flash": (dict(n_experts=4, top_k=2, use_flash=True),
                          dict(n=4, tp=2)),
    "moe_dp4_ring_tp2_drops": (dict(n_experts=4, top_k=1, attention="ring",
                                    capacity_factor=0.5), dict(n=8, tp=2)),
}


@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_matches_the_reference(name):
    kw, mesh = FORWARD[name]
    jc, tc = _cfgs(**kw)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    ids = _ids(4, 16)
    if mesh is None:
        jl, jaux = jax.jit(lambda p, i: J.forward(p, i, jc))(
            params, jnp.asarray(ids))
        tl, taux = T.forward(params_from_jax(_host(params)),
                             torch.from_numpy(ids), tc)
    else:
        jm = jmake_mesh(n_devices=mesh["n"], tp=mesh["tp"], pp=1)
        jl, jaux = jax.jit(lambda p, i: J.forward(p, i, jc, mesh=jm))(
            J.shard_params(params, jm, jc), jnp.asarray(ids))
        tm = make_mesh(n_devices=mesh["n"], tp=mesh["tp"], device="cpu")
        tl, taux = T.forward(params_from_jax(_host(params), mesh=tm, cfg=tc),
                             torch.from_numpy(ids), tc, mesh=tm)
    assert tl.dtype == torch.float32 and tl.shape == (4, 16, 64)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if kw.get("n_experts"):
        assert float(taux) > 0.0


def test_ring_inside_the_pipeline_is_refused():
    jc, tc = _cfgs(attention="ring", n_layers=2)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    jm = jmake_mesh(n_devices=4, tp=2, pp=2)
    with pytest.raises(ValueError, match="ring"):
        J.forward(J.shard_params(params, jm, jc, pp=2),
                  jnp.asarray(_ids(2, 8)), jc, mesh=jm, pp=2)
    tm = make_mesh(n_devices=4, tp=2, pp=2, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        T.forward(params_from_jax(_host(params), mesh=tm, cfg=tc, pp=2),
                  torch.from_numpy(_ids(2, 8)), tc, mesh=tm, pp=2)


def test_int8_params_are_refused_under_the_pipeline():
    jc, tc = _cfgs()
    q8 = params_from_jax(_host(J.quantize_ffn_params(
        J.init_params(jax.random.PRNGKey(0), jc))))
    tm = make_mesh(n_devices=4, tp=2, pp=2, device="cpu")
    with pytest.raises(ValueError, match="pp pipeline"):
        T.shard_params(q8, tm, tc, pp=2)
    with pytest.raises(ValueError, match="pp pipeline"):
        T.forward(q8, torch.from_numpy(_ids(2, 8)), tc, mesh=tm, pp=2)
    # without the pipeline an int8 tree runs its layers unrolled
    logits, aux = T.forward(q8, torch.from_numpy(_ids(2, 8)), tc)
    assert torch.isfinite(logits).all() and float(aux) == 0.0


def test_remat_changes_nothing():
    """``cfg.remat`` recomputes each block in the backward: the loss and
    the gradients are bitwise those of the plain run, with and without a
    mesh."""
    jc, tc = _cfgs(n_experts=2, top_k=1, use_flash=True)
    host = _host(J.init_params(jax.random.PRNGKey(0), jc))
    ids = _ids(4, 9)
    batch = {"input_ids": torch.from_numpy(ids[:, :-1]),
             "targets": torch.from_numpy(ids[:, 1:])}
    tm = make_mesh(n_devices=4, tp=2, device="cpu")
    for mesh in (None, tm):
        out = []
        for remat in (False, True):
            cfg = T.TransformerConfig(**{**KW, "n_experts": 2, "top_k": 1,
                                         "use_flash": True, "remat": remat},
                                      dtype=torch.float32)
            p = (params_from_jax(host) if mesh is None
                 else params_from_jax(host, mesh=mesh, cfg=cfg))
            for t in T.param_leaves(p):
                t.requires_grad_()
            loss = T.lm_loss(p, batch, cfg, mesh=mesh)
            loss.backward()
            out.append((loss.item(), _grads(p)))
        assert out[0][0] == out[1][0]
        _assert_trees_close(out[1][1], out[0][1], atol=0.0)


# ---- loss and gradients ----------------------------------------------------

LOSS = {
    "moe_flash": (dict(n_experts=4, top_k=2, use_flash=True), None),
    "moe_drops": (dict(n_experts=4, top_k=2, capacity_factor=0.5), None),
    "dp2_tp2_moe_flash": (dict(n_experts=4, top_k=2, use_flash=True),
                          dict(n=4, tp=2, pp=1)),
    "dp2_pp2_tp2_moe_flash": (dict(n_experts=2, top_k=2, use_flash=True,
                                   n_layers=4), dict(n=8, tp=2, pp=2)),
}


@pytest.mark.parametrize("name", list(LOSS))
def test_lm_loss_and_gradients_match_value_and_grad(name):
    """The loss and every gradient against ``jax.value_and_grad`` of the
    reference's ``lm_loss``, with a mask that drops some tokens."""
    kw, mesh = LOSS[name]
    jc, tc = _cfgs(**kw)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    ids = _ids(4, 17)
    mask = np.ones((4, 16), np.float32)
    mask[1, 10:] = 0.0
    mask[3, :4] = 0.0
    jbatch = {"input_ids": jnp.asarray(ids[:, :-1]),
              "targets": jnp.asarray(ids[:, 1:]), "mask": jnp.asarray(mask)}
    tbatch = {"input_ids": torch.from_numpy(ids[:, :-1].copy()),
              "targets": torch.from_numpy(ids[:, 1:].copy()),
              "mask": torch.from_numpy(mask)}
    if mesh is None:
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: J.lm_loss(p, jbatch, jc)))(params)
        tp = params_from_jax(_host(params))
        tm, pp, nm = None, 1, 1
    else:
        pp = mesh["pp"]
        nm = 2 if pp > 1 else 1
        jm = jmake_mesh(n_devices=mesh["n"], tp=mesh["tp"], pp=pp)
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: J.lm_loss(p, jbatch, jc, jm, pp, nm)))(
            J.shard_params(params, jm, jc, pp=pp))
        tm = make_mesh(n_devices=mesh["n"], tp=mesh["tp"], pp=pp,
                       device="cpu")
        tp = params_from_jax(_host(params), mesh=tm, cfg=tc, pp=pp)
    for t in T.param_leaves(tp):
        t.requires_grad_()
    loss = T.lm_loss(tp, tbatch, tc, tm, pp, nm)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    _assert_trees_close(_grads(tp), _host(jg), GRAD_ATOL)


def test_adamw_update_equals_optax():
    """The same params and the same gradients, three steps: the port's
    optimizer (``make_train_step``'s ``init_opt``) against optax
    ``adamw(1e-3, weight_decay=0.01)``, the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 4), "b": (5,), "c": (3, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-7, 1, s)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    opt = optax.adamw(1e-3, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
    _, tc = _cfgs()
    init_opt, _ = T.make_train_step(tc)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = init_opt(tp)
    for g in grads:
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_train_step_descends():
    """Ten AdamW steps of a small MoE model on one repeated batch: every
    loss finite, the last below the first, params updated in place."""
    _, tc = _cfgs(n_experts=4, top_k=2, use_flash=True)
    params = T.init_params(torch.Generator().manual_seed(0), tc)
    wq = params["blocks"]["wq"]
    before = wq.detach().clone()
    ids = torch.randint(0, 64, (4, 17), generator=torch.Generator()
                        .manual_seed(1))
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    init_opt, step = T.make_train_step(tc, learning_rate=1e-2)
    opt = init_opt(params)
    losses = []
    for _ in range(10):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert params["blocks"]["wq"] is wq and not torch.equal(wq, before)
    assert wq.grad is not None and wq.grad.abs().sum() > 0


def test_a_step_under_inference_mode_still_trains():
    """The step leaves a caller's ``inference_mode`` and ``no_grad``."""
    _, tc = _cfgs(use_flash=True)
    params = T.init_params(torch.Generator().manual_seed(0), tc)
    ids = torch.randint(0, 64, (2, 9), generator=torch.Generator()
                        .manual_seed(1))
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    init_opt, step = T.make_train_step(tc)
    opt = init_opt(params)
    with torch.inference_mode():
        _, _, loss = step(params, opt, batch)
    assert np.isfinite(float(loss))
    assert params["blocks"]["wk"].grad.abs().sum() > 0


# ---- the reference's two training dryrun lines ------------------------------

@pytest.mark.parametrize("kw", TRAINING_PLANS,
                         ids=lambda kw: f"tp{kw['tp']}_pp{kw['pp']}")
def test_dryrun_line_as_the_reference(kw):
    """``_dryrun_one_plan`` on conftest's 8 devices and the port's
    ``dryrun_training`` on 8 CPU ranks from the reference's params and
    batch: the summary lines EQUAL, the losses within 1e-4, and the port's
    gradients of that loss within 1e-5 of ``jax.grad(lm_loss)``'s on the
    reference's mesh."""
    want = _dryrun_one_plan(jplan_mesh(8, **kw))
    plan = plan_mesh(8, **kw)
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
    line, loss, _ = dryrun_training(plan, "cpu",
                                    params=params_from_jax(_host(params)),
                                    batch=tbatch)
    assert line == want
    assert abs(loss - float(want.rsplit("loss=", 1)[1])) < 1e-4
    # the loss and gradients before the step, against the reference's
    jm = jmake_mesh(n_devices=8, tp=plan.tp, pp=plan.pp)
    nm = 2 if plan.pp > 1 else 1
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: J.lm_loss(p, jbatch, jc, jm, plan.pp, nm)))(
        J.shard_params(params, jm, jc, pp=plan.pp))
    assert abs(loss - float(jloss)) < 1e-4
    tm = make_mesh(plan, devices=["cpu"] * 8)
    tp = params_from_jax(_host(params), mesh=tm, cfg=cfg, pp=plan.pp)
    for t in T.param_leaves(tp):
        t.requires_grad_()
    T.lm_loss(tp, tbatch, cfg, tm, plan.pp, nm).backward()
    _assert_trees_close(_grads(tp), _host(jg), GRAD_ATOL)


def test_sharded_step_equals_the_unsharded_step():
    """The ring plan's step on 8 CPU ranks and the same step with no mesh:
    the losses within 1e-5 and the updated params within 1e-6 wherever the
    gradient is at least 1e-6 in magnitude."""
    plan = plan_mesh(8, tp=4, pp=1)
    cfg = dryrun_config(plan)
    base = T.init_params(torch.Generator().manual_seed(0), cfg)

    def copy(tree=base):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree.clone()

    _, l_sh, p_sh = dryrun_training(plan, "cpu", params=copy())
    # the same step with no mesh: make_train_step's AdamW over lm_loss
    p_one = copy()
    init_opt, step = T.make_train_step(cfg)
    p_one, _, l_one = step(p_one, init_opt(p_one),
                           dryrun_batch(plan, cfg, "cpu"))
    l_one = float(l_one)
    assert abs(l_sh - l_one) < 1e-5
    got = T.param_leaves(_unshard_tree(p_sh))
    want = T.param_leaves(p_one)
    grads = T.param_leaves(_grads(p_one))
    assert len(got) == len(want) == len(grads)
    for a, b, g in zip(got, want, grads):
        sure = g.abs() >= 1e-6
        np.testing.assert_allclose(a.detach()[sure].numpy(),
                                   b.detach()[sure].numpy(), atol=1e-6)


# ---- serving a MoE, checkpoints -------------------------------------------

def test_moe_generate_ids_equal_the_reference():
    jc, tc = _cfgs(n_experts=4, top_k=2, use_flash=True, n_kv_heads=2)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    prompt = _ids(2, 5, seed=3)
    want = J.generate(params, jnp.asarray(prompt), 8, jc)
    got = T.generate(params_from_jax(_host(params)), torch.from_numpy(prompt),
                     8, tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_checkpoint_reads_in_both_directions(tmp_path):
    jc, tc = _cfgs(n_experts=4, top_k=1, capacity_factor=1.25,
                   seq_shard=False, remat=True)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    jck.save_transformer(str(tmp_path / "ref"), params, jc)
    got, cfg = tck.load_transformer(str(tmp_path / "ref"), device="cpu")
    assert cfg == tc
    _assert_trees_close(got, _host(params), atol=0.0)
    tck.save_transformer(str(tmp_path / "port"),
                         params_from_jax(_host(params)), tc)
    back, jcfg = jck.load_transformer(str(tmp_path / "port"))
    assert (jcfg.n_experts, jcfg.top_k, jcfg.capacity_factor,
            jcfg.seq_shard, jcfg.remat) == (4, 1, 1.25, False, True)
    _assert_trees_close(_host(back), _host(params), atol=0.0)


# ---- the flash kernel under autograd ---------------------------------------

@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attention_backward_is_the_dense_recompute(hkv):
    """``flash_attention``'s gradients: bitwise those of autograd through
    its plain version (the backward is that recompute), and within 1e-5 of
    the reference's ``jax.grad`` through its Pallas kernel (interpret mode)
    on GQA-expanded K/V."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, hkv, 16)).astype(np.float32)
    w = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)

    def run(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts, causal=True) * torch.from_numpy(w)).sum().backward()
        return [t.grad for t in ts]

    got = run(tattn.flash_attention)
    plain = run(tattn.flash_attention_ref)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)

    g = 4 // hkv

    def jloss(q, k, v):
        out = jattn.flash_attention(q, jnp.repeat(k, g, axis=2),
                                    jnp.repeat(v, g, axis=2), causal=True,
                                    block_q=8, block_k=8)
        return (out * w).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


@pytest.mark.parametrize("dp", [1, 2], ids=["tp2", "dp2_tp2"])
def test_moe_serving_over_a_tp_mesh_matches_the_reference(dp):
    """A MoE model's prefill and decode step over mesh(tp=2), and over
    mesh(dp=2, tp=2) with the experts over dp: the experts' d_ff over the
    two ranks, routing over every row of the call (both dp groups' rows
    together); logits within 2e-4 of the reference's over its mesh,
    greedy ids EQUAL."""
    jc, tc = _cfgs(n_experts=4, top_k=2, use_flash=True)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    jm = jmake_mesh(n_devices=2 * dp, tp=2, pp=1)
    tm = make_mesh(n_devices=2 * dp, tp=2, device="cpu")
    ids = _ids(2, 8)
    jp = J.shard_params(params, jm, jc)
    jl, jcache = jax.jit(lambda p, i: J.prefill(p, i, jc, max_len=12,
                                                logit_pos=7, mesh=jm))(
        jp, jnp.asarray(ids))
    tp = params_from_jax(_host(params), mesh=tm, cfg=tc)
    tl, tcache = T.prefill(tp, torch.from_numpy(ids), tc, max_len=12,
                           logit_pos=7, mesh=tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
    jl2, _ = jax.jit(lambda p, c, t: J.decode_step(p, c, t, jc, mesh=jm))(
        jp, jcache, jnp.asarray(tok))
    tcache = T.init_cache(tc, 2, max_len=12, mesh=tm)
    for t in range(8):
        _, tcache = T.decode_step(tp, tcache, torch.from_numpy(ids[:, t]),
                                  tc, mesh=tm)
    tl2, _ = T.decode_step(tp, tcache, torch.from_numpy(tok), tc, mesh=tm)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_ATOL)


def test_dryrun_cli_prints_both_lines(capsys):
    """``python -m seldon_core_tpu_torch.dryrun --device cpu``: both of the
    reference's training lines, seeded here, in its wording, then its two
    multi-host lines (two processes of 4 ranks: tp = 8)."""
    import re

    from seldon_core_tpu_torch import dryrun

    assert dryrun.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    train, multihost = lines[:2], lines[2:]
    assert [ln.rsplit("loss=", 1)[0] for ln in train] == [
        "dryrun_training OK: mesh(dp=2,pp=2,tp=2) attention=dense "
        "sp=megatron experts=2 ",
        "dryrun_training OK: mesh(dp=2,pp=1,tp=4) attention=ring sp=ring "
        "experts=2 "]
    assert all(np.isfinite(float(ln.rsplit("=", 1)[1])) for ln in train)
    assert multihost[0] == (
        "dryrun_multichip OK: multihost 2-process jax.distributed LLMEngine "
        "tp=8 spanning processes, byte-identical to single-device decode ok")
    assert re.fullmatch(
        r"dryrun_multichip OK: multihost 2-process PagedLLMEngine paged-KV x "
        r"spec x ring-prefill x prefix-aliasing tp=8 spanning processes: 3 "
        r"requests byte-identical to plain decode, [1-9][0-9]* spec rounds, "
        r"4 shared pages pinned\+returned per rank ok", multihost[1])
    assert len(multihost) == 2
