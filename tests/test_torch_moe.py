"""The port's mixture of experts (``seldon_core_tpu_torch/parallel/moe.py``)
against the reference's (``seldon_core_tpu/parallel/moe.py``) on the CPU:
the same numpy-seeded tokens and the reference's params (converted).

Routing is discrete and held EQUAL: the top-k expert ids, each
assignment's slot in its expert's buffer, the kept mask and the capacity.
The reference's moe_forward does not return its routing, so
``_jax_route`` runs the reference's own lines (``moe.py:75-87``) in jax.
Float outputs: y within atol 1e-5 (the products differ only in summation
order), with and without drops (capacity factors 8.0 and 0.5, as
``tests/test_parallel.py:111-131``); the aux loss and the renormalised
gate values within 1e-6 (float32 means); gradients within 1e-5.  The
sharded MoE on a dp=2, tp=2 CPU mesh equals the unsharded one within
1e-5 (the counterpart of ``tests/test_parallel.py:133``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.parallel import moe as jmoe
from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.parallel import moe as tmoe
from seldon_core_tpu_torch.parallel.mesh import (
    Shards,
    make_mesh,
    named_sharding,
    place,
)

ATOL = 1e-5
AUX_TOL = 1e-6


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _x(T, D, seed=1):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)


def _params(jcfg, seed=0):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _jax_route(params, x, cfg):
    """The reference's routing, its moe_forward's lines as they stand."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = jmoe.moe_capacity(cfg, T)
    probs = jax.nn.softmax((x @ params["router"]).astype(jnp.float32), -1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.transpose(1, 0, 2).reshape(K * T, E)
    pos = (jnp.cumsum(flat, axis=0) * flat - 1).reshape(K, T, E).transpose(
        1, 0, 2)
    slot = pos.max(-1)
    kept = (slot >= 0) & (slot < C)
    return {"gate_vals": np.asarray(gate_vals),
            "gate_idx": np.asarray(gate_idx), "slot": np.asarray(slot),
            "kept": np.asarray(kept), "capacity": C}


CASES = [
    dict(n_experts=4, top_k=2, capacity_factor=8.0, d_model=16, d_ff=32,
         T=24),
    dict(n_experts=4, top_k=2, capacity_factor=0.5, d_model=16, d_ff=32,
         T=24),
    dict(n_experts=2, top_k=1, capacity_factor=0.5, d_model=8, d_ff=16,
         T=16),
    dict(n_experts=8, top_k=3, capacity_factor=1.0, d_model=16, d_ff=24,
         T=40),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"E{c['n_experts']}k{c['top_k']}"
                                       f"cf{c['capacity_factor']}")
def test_routing_output_and_aux_equal_the_reference(case):
    case = dict(case)
    T = case.pop("T")
    jcfg, tcfg = _cfgs(**case)
    jp, tp = _params(jcfg)
    x = _x(T, jcfg.d_model)
    want = _jax_route(jp, jnp.asarray(x), jcfg)
    got = tmoe.moe_route(torch.from_numpy(x), tp["router"], tcfg)
    assert got["capacity"] == want["capacity"] == tmoe.moe_capacity(tcfg, T)
    for name in ("gate_idx", "slot", "kept"):
        np.testing.assert_array_equal(got[name].numpy(), want[name],
                                      err_msg=name)
    np.testing.assert_allclose(got["gate_vals"].numpy(), want["gate_vals"],
                               atol=AUX_TOL)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_TOL)
    if case["capacity_factor"] < 1.0:
        # some assignments dropped; the same tokens' rows are zero
        assert not got["kept"].all()
        np.testing.assert_array_equal(
            (ty.abs().sum(-1) == 0).numpy(),
            np.asarray(jnp.abs(jy).sum(-1) == 0))


def test_no_drop_equals_the_dense_reference():
    """Capacity 8x: nothing dropped, equal to both packages' per-expert
    reference (``tests/test_parallel.py:111``)."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=8.0,
                       d_model=16, d_ff=32)
    jp, tp = _params(jcfg)
    x = _x(24, 16)
    y, aux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    dense = tmoe.moe_forward_dense_reference(tp, torch.from_numpy(x), tcfg)
    jdense = jmoe.moe_forward_dense_reference(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=ATOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL)
    assert float(aux) > 0.0


def test_capacity_drops_tokens_gracefully():
    """``tests/test_parallel.py:121``: a tiny capacity drops tokens, whose
    output rows are zero (the reference's one_hot of -1: an all-zero row,
    where torch's one_hot of -1 would raise)."""
    _, tcfg = _cfgs(n_experts=2, top_k=1, capacity_factor=0.5, d_model=8,
                    d_ff=16)
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(_x(16, 8))
    y, _ = tmoe.moe_forward(tp, x, tcfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert (y.abs().sum(-1) == 0).any()


def test_ties_choose_the_lower_expert_as_lax_top_k():
    """A zero router gives every expert the same probability: top-k takes
    the lowest ids, in order, as ``lax.top_k`` does; k-major slots
    follow."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.0,
                       d_model=8, d_ff=16)
    jp, tp = _params(jcfg)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _x(6, 8)
    want = _jax_route(jp, jnp.asarray(x), jcfg)
    got = tmoe.moe_route(torch.from_numpy(x), tp["router"], tcfg)
    assert got["gate_idx"].tolist() == [[0, 1]] * 6
    for name in ("gate_idx", "slot", "kept"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_gradients_equal_the_reference():
    """d(sum(y) + aux) by every param and by x, against ``jax.grad``."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.0,
                       d_model=16, d_ff=32)
    jp, tp = _params(jcfg)
    x = _x(20, 16)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, x, jcfg)
        return (y * y).sum() + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_forward(tp, tx, tcfg)
    ((y * y).sum() + aux).backward()
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)


def test_bfloat16_routing_equal():
    """bf16 tokens and weights (the train step's activations): the router
    logits in bf16, the softmax in float32; routing EQUAL, y within one
    bf16 step of the output scale."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.0,
                       d_model=16, d_ff=32)
    jp, tp = _params(jcfg)
    x = _x(32, 16)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jxb = jnp.asarray(x).astype(jnp.bfloat16)
    tpb = {k: v.bfloat16() for k, v in tp.items()}
    txb = torch.from_numpy(x).bfloat16()
    want = _jax_route(jpb, jxb, jcfg)
    got = tmoe.moe_route(txb, tpb["router"], tcfg)
    for name in ("gate_idx", "slot", "kept"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    jy, _ = jmoe.moe_forward(jpb, jxb, jcfg)
    ty, _ = tmoe.moe_forward(tpb, txb, tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=3e-2)


def test_sharded_on_a_cpu_mesh_equals_unsharded():
    """Experts over dp = 2, d_ff over tp = 2 (``moe_param_specs``): equal to
    the unsharded layer and to the reference's sharded one
    (``tests/test_parallel.py:133``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=8.0,
                       d_model=16, d_ff=32, expert_axis="dp")
    jp, tp = _params(jcfg)
    x = _x(32, 16)
    jm = jmake_mesh(n_devices=4, tp=2, pp=1)  # dp=2, tp=2
    specs = jmoe.moe_param_specs(jcfg)
    jsh = {k: jax.device_put(v, NamedSharding(jm, specs[k]))
           for k, v in jp.items()}

    def constrain(a, *axes):
        return jax.lax.with_sharding_constraint(a, NamedSharding(jm,
                                                                 P(*axes)))

    jy = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg,
                                               constrain=constrain)[0])(
        jsh, jnp.asarray(x))
    tm = make_mesh(n_devices=4, tp=2, device="cpu")
    tspecs = tmoe.moe_param_specs(tcfg)
    placed = {k: place(v, named_sharding(tm, *tspecs[k]))
              for k, v in tp.items()}
    w_in = placed["w_in"]
    assert isinstance(w_in, Shards) and w_in.axis == "dp" and \
        len(w_in) == 2 and w_in[0].axis == "tp"
    assert tuple(w_in[1][1].shape) == (2, 16, 16)
    y, aux = tmoe.moe_forward(placed, torch.from_numpy(x), tcfg, mesh=tm)
    y0, aux0 = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    assert float(aux) == float(aux0)


def test_sharded_gradients_reach_every_piece():
    """Backward through the sharded experts: each placed piece's gradient
    is the unsharded gradient's piece."""
    _, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.0, d_model=8,
                    d_ff=16)
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(3), tcfg)
    x = torch.from_numpy(_x(16, 8))
    tm = make_mesh(n_devices=4, tp=2, device="cpu")
    specs = tmoe.moe_param_specs(tcfg)
    placed = {k: place(v, named_sharding(tm, *specs[k]))
              for k, v in tp.items()}
    pieces = [placed["router"]] + [t for g in placed["w_in"] for t in g] + \
        [t for g in placed["w_out"] for t in g]
    for t in pieces:
        t.requires_grad_()
    whole = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    y, aux = tmoe.moe_forward(placed, x, tcfg, mesh=tm)
    ((y * y).sum() + aux).backward()
    y0, aux0 = tmoe.moe_forward(whole, x, tcfg)
    ((y0 * y0).sum() + aux0).backward()
    np.testing.assert_allclose(placed["router"].grad.numpy(),
                               whole["router"].grad.numpy(), atol=ATOL)
    g_in = whole["w_in"].grad
    np.testing.assert_allclose(placed["w_in"][1][0].grad.numpy(),
                               g_in[2:, :, :8].numpy(), atol=ATOL)
    g_out = whole["w_out"].grad
    np.testing.assert_allclose(placed["w_out"][0][1].grad.numpy(),
                               g_out[:2, 8:, :].numpy(), atol=ATOL)


@pytest.mark.parametrize("T", [1, 7, 64, 1000])
def test_capacity_as_the_reference(T):
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, capacity_factor=1.5)
    assert tmoe.moe_capacity(tcfg, T) == jmoe.moe_capacity(jcfg, T)


def test_init_and_specs_layout():
    jcfg, tcfg = _cfgs(n_experts=4, top_k=2, d_model=16, d_ff=32)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    jspecs = jmoe.moe_param_specs(jcfg)
    assert {k: tuple(v) for k, v in tmoe.moe_param_specs(tcfg).items()} == \
        {k: tuple(v) for k, v in jspecs.items()}
