"""The port's GPipe schedule (``seldon_core_tpu_torch/parallel/pipeline.py``)
against the reference's (``seldon_core_tpu/parallel/pipeline.py``) on the
CPU: the reference over conftest's virtual devices, the port over repeats
of the CPU device, the same numpy-seeded inputs.  Counterparts of
``tests/test_parallel.py:160-215`` (sequential, degenerate,
differentiable), plus the schedule's order, the stage split of placed
trees, and the transformer's pipelined forward with the flash kernel
inside each stage.

Tolerances: the stage functions are the same float32 products in both
packages, so outputs and gradients agree within 1e-5; the pipelined
transformer's logits within 2e-4 (``tests/test_transformer.py``'s bound for
sharded against unsharded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as J
from seldon_core_tpu.parallel import pipeline as jpipe
from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.parallel import pipeline as tpipe
from seldon_core_tpu_torch.parallel.mesh import Shards, make_mesh, unshard

ATOL = 1e-5


def _stages(d=8, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal((d,)) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jstage(p, a):
    return jnp.tanh(a @ p["w"][0] + p["b"][0])


def _tstage(p, a, s):
    return torch.tanh(a @ p["w"][0] + p["b"][0])


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_matches_sequential_and_the_reference(n_micro):
    per = _stages()
    x = np.random.default_rng(1).standard_normal((8, 8)).astype(np.float32)
    jm = jmake_mesh(n_devices=8, tp=2, pp=2)
    jy = jpipe.pipeline_apply(_jstage, jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per]),
        jnp.asarray(x), jm, n_microbatches=n_micro)
    tm = make_mesh(n_devices=8, tp=2, pp=2, device="cpu")
    stacked = tpipe.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in per])
    y = tpipe.pipeline_apply(_tstage, stacked, torch.from_numpy(x), tm,
                             n_microbatches=n_micro)
    ref = torch.from_numpy(x)
    for p in per:
        ref = torch.tanh(ref @ torch.from_numpy(p["w"])
                         + torch.from_numpy(p["b"]))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


def test_pipeline_single_stage_degenerate():
    tm = make_mesh(n_devices=8, tp=8, pp=1, device="cpu")
    y = tpipe.pipeline_apply(lambda p, a, s: a * p["s"][0],
                             {"s": torch.ones((1,)) * 3.0},
                             torch.ones((4, 2)), tm, n_microbatches=2)
    np.testing.assert_allclose(y.numpy(), 3.0 * np.ones((4, 2)))


def test_pipeline_is_differentiable_as_the_reference():
    """``tests/test_parallel.py:190``, its gradient held to jax.grad's."""
    per = [{"w": np.eye(4, dtype=np.float32) * (i + 1.0)} for i in range(2)]
    x = np.random.default_rng(2).standard_normal((4, 4)).astype(np.float32)
    jm = jmake_mesh(n_devices=8, tp=1, pp=2)  # dp=4, pp=2

    def jloss(params):
        return (jpipe.pipeline_apply(lambda p, a: a @ p["w"][0], params,
                                     jnp.asarray(x), jm,
                                     n_microbatches=2) ** 2).sum()

    jg = jax.grad(jloss)(jpipe.stack_stage_params(
        [{"w": jnp.asarray(p["w"])} for p in per]))
    tm = make_mesh(n_devices=8, tp=1, pp=2, device="cpu")
    stacked = tpipe.stack_stage_params(
        [{"w": torch.from_numpy(p["w"])} for p in per])
    stacked["w"].requires_grad_()
    y = tpipe.pipeline_apply(lambda p, a, s: a @ p["w"][0], stacked,
                             torch.from_numpy(x), tm, n_microbatches=2)
    (y ** 2).sum().backward()
    g = stacked["w"].grad
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["w"]), atol=ATOL)


def test_gpipe_schedule_order():
    """Tick t runs stage s on microbatch t - s, stages in order within a
    tick; no bubble tick calls a stage."""
    calls = []

    def stage(p, a, s):
        calls.append((s, int(a[0, 0])))
        return a

    tm = make_mesh(n_devices=2, tp=1, pp=2, device="cpu")
    x = torch.arange(3.0)[:, None].repeat(1, 2)  # row i is microbatch i
    y = tpipe.pipeline_apply(stage, {"w": torch.zeros(2, 1)}, x, tm,
                             n_microbatches=3)
    assert torch.equal(y, x)
    assert calls == [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (1, 2)]


def test_batch_must_divide_in_microbatches():
    tm = make_mesh(n_devices=2, tp=1, pp=2, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(lambda p, a, s: a, {"w": torch.zeros(2, 1)},
                             torch.zeros(5, 2), tm, n_microbatches=2)


KW = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
          max_seq=32)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_placed_stages_own_their_storage():
    """``shard_params(pp=2)``: the stacked layer dim over "pp" (outermost),
    each stage piece its own storage, the whole tree back by unshard."""
    jc = J.TransformerConfig(**KW, n_experts=2, top_k=1, dtype=jnp.float32)
    tc = T.TransformerConfig(**KW, n_experts=2, top_k=1,
                             dtype=torch.float32)
    base = params_from_jax(_host(J.init_params(jax.random.PRNGKey(0), jc)))
    tm = make_mesh(n_devices=8, tp=2, pp=2, device="cpu")  # dp=2
    placed = T.shard_params(base, tm, tc, pp=2)
    wq = placed["blocks"]["wq"]
    assert wq.axis == "pp" and wq.dim == 0 and len(wq) == 2
    assert wq[1].axis == "tp" and tuple(wq[1][0].shape) == (2, 32, 2, 8)
    w_in = placed["blocks"]["moe"]["w_in"]  # pp, then dp, then tp
    assert [w_in.axis, w_in[0].axis, w_in[0][0].axis] == ["pp", "dp", "tp"]
    assert tuple(w_in[1][1][0].shape) == (2, 1, 32, 32)
    ln1 = placed["blocks"]["ln1"]
    assert ln1.axis == "pp" and isinstance(ln1[0], torch.Tensor)
    leaves = T.param_leaves(placed)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == \
        len(leaves)
    for name in ("wq", "wo", "ln1", "ln2"):
        assert torch.equal(unshard(placed["blocks"][name]),
                           base["blocks"][name])
    assert torch.equal(unshard(w_in), base["blocks"]["moe"]["w_in"])
    assert isinstance(placed["lm_head"], Shards)
    assert tpipe.stage_slice(placed["blocks"], 1, 2)["wq"] is wq[1]


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pipelined_transformer_with_flash_matches_the_reference(n_micro):
    """mesh(dp=2, pp=2, tp=2): the layer stack in two stages, K3's plain
    version per rank inside each stage, Megatron sequence sharding; the
    logits equal the reference's pipelined ones (its flash in interpret
    mode) and the port's unpipelined ones; the aux is 0 (the pipeline
    carries activations only)."""
    kw = dict(KW, use_flash=True, n_experts=2, top_k=2)
    jc = J.TransformerConfig(**kw, dtype=jnp.float32)
    tc = T.TransformerConfig(**kw, dtype=torch.float32)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                        64))
    jm = jmake_mesh(n_devices=8, tp=2, pp=2)
    jl, jaux = jax.jit(lambda p, i: J.forward(p, i, jc, mesh=jm, pp=2,
                                              n_microbatches=n_micro))(
        J.shard_params(params, jm, jc, pp=2), jnp.asarray(ids))
    tm = make_mesh(n_devices=8, tp=2, pp=2, device="cpu")
    tp = params_from_jax(_host(params), mesh=tm, cfg=tc, pp=2)
    tl, taux = T.forward(tp, torch.from_numpy(ids), tc, mesh=tm, pp=2,
                         n_microbatches=n_micro)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    assert float(taux) == float(jaux) == 0.0
    one, _ = T.forward(params_from_jax(_host(params)), torch.from_numpy(ids),
                       tc)
    np.testing.assert_allclose(tl.numpy(), one.numpy(), atol=2e-4)
