"""The port's tensor-parallel transformer (``models/transformer.py`` with
``mesh=``) against the reference's on the CPU: the reference over 2 (or 8)
of conftest's virtual devices, the port over repeats of the CPU device,
both from the same params (the reference's, through ``convert.py``; a tree
the reference sharded and quantized crosses as ``jax.device_get`` gives
it).  Counterparts of ``tests/test_transformer.py`` :201, :223, :324, :339
and of ``__graft_entry__.py`` ``_dryrun_serving``.

Discrete outputs (greedy ids, argmax) are EQUAL.  Float32 logits agree
within 1e-4 (tp and int8 paths: the int8 product is exact and the partial
sums meet in float32; the order of the float adds differs by a few ulps)
and within 2e-4 for ring attention against dense (the reference's own
bound).  The single-chip int8 decode of the serving dryrun is held within
0.05 (``Q8_STEP_ATOL``): there a float32 ulp of difference upstream moves
one activation by one int8 step, as the test says."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as J
from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.ops.quant import is_k_major
from seldon_core_tpu_torch.parallel.mesh import Shards, make_mesh, unshard

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
          max_seq=32)
JTINY = J.TransformerConfig(**KW, dtype=jnp.float32)
TTINY = T.TransformerConfig(**KW, dtype=torch.float32)
ATOL = 1e-4
Q8_STEP_ATOL = 0.05


def _cfgs(**kw):
    return (J.TransformerConfig(**{**KW, **kw}, dtype=jnp.float32),
            T.TransformerConfig(**{**KW, **kw}, dtype=torch.float32))


def _ids(B, L, seed=0, vocab=64):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, L), 0,
                                         vocab))


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _meshes(n, tp):
    return (jmake_mesh(n_devices=n, tp=tp, pp=1),
            make_mesh(n_devices=n, tp=tp, device="cpu"))


@pytest.fixture(scope="module")
def base():
    return J.init_params(jax.random.PRNGKey(0), JTINY)


def test_quantized_ffn_tensor_parallel_matches_the_reference(base):
    """int8 FFN + lm_head at tp = 2 (K1 per rank, psum of w2's float32
    partials): the port's logits of every position equal the reference's
    tp = 2 logits; both stay within the reference's bound of single-chip."""
    jm, tm = _meshes(2, 2)
    ids = _ids(4, 16)
    jq = J.quantize_ffn_params(J.shard_params(base, jm, JTINY), mesh=jm)
    ref, _ = jax.jit(lambda p, i: J.prefill(p, i, JTINY, max_len=16,
                                            mesh=jm))(jq, jnp.asarray(ids))
    tq = params_from_jax(_host(jq), mesh=tm, cfg=TTINY)
    out, cache = T.prefill(tq, torch.from_numpy(ids), TTINY, max_len=16,
                           mesh=tm)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    np.testing.assert_array_equal(out.numpy().argmax(-1), ref.argmax(-1))
    # the port quantizing its own placed float tree places the same leaves
    tq2 = T.quantize_ffn_params(T.shard_params(
        params_from_jax(_host(base)), tm, TTINY), mesh=tm)
    for a, b in zip(tq["blocks"]["w2"]["values"],
                    tq2["blocks"]["w2"]["values"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # single-chip int8 agrees at the reference's own bound
    one, _ = T.prefill(T.quantize_ffn_params(params_from_jax(_host(base))),
                       torch.from_numpy(ids), TTINY, max_len=16)
    agree = (one.numpy().argmax(-1) == out.numpy().argmax(-1)).mean()
    assert agree >= 0.98, agree
    assert isinstance(cache["k"], Shards) and cache["k"].dim == 3


def test_quantized_leaves_are_placed_megatron(base):
    _, tm = _meshes(2, 2)
    tq = T.quantize_ffn_params(T.shard_params(
        params_from_jax(_host(base)), tm, TTINY), mesh=tm)
    w1, w2, lm = tq["blocks"]["w1"], tq["blocks"]["w2"], tq["lm_head"]
    D, Fd, V = KW["d_model"], KW["d_ff"], KW["vocab_size"]
    assert [tuple(v.shape) for v in w1["values"][0]] == [(D, Fd // 2)] * 2
    assert [tuple(s.shape) for s in w1["scales"][0]] == [(Fd // 2,)] * 2
    # w2 by rows, stored K-major at the local K; its scales whole per rank
    assert [tuple(v.shape) for v in w2["values"][0]] == [(Fd // 2, D)] * 2
    assert all(is_k_major(v) for v in w2["values"][0])
    assert w2["scales"][0].dim is None
    assert [tuple(s.shape) for s in w2["scales"][0]] == [(D,)] * 2
    assert [tuple(v.shape) for v in lm["values"]] == [(D, V // 2)] * 2


def test_quantized_decode_tensor_parallel_dp4_tp2(base):
    jm, tm = _meshes(8, 2)  # dp = 4: the batch divides over dp
    ids = _ids(4, 4)
    jq = J.quantize_ffn_params(J.shard_params(base, jm, JTINY), mesh=jm)
    ref, _ = jax.jit(lambda p, c, t: J.decode_step(p, c, t, JTINY, mesh=jm))(
        jq, J.init_cache(JTINY, 4, max_len=8), jnp.asarray(ids[:, 0]))
    tq = params_from_jax(_host(jq), mesh=tm, cfg=TTINY)
    out, cache = T.decode_step(tq, T.init_cache(TTINY, 4, max_len=8,
                                                mesh=tm),
                               torch.from_numpy(ids[:, 0]), TTINY, mesh=tm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(out.numpy().argmax(-1),
                                  np.asarray(ref).argmax(-1))
    assert cache["pos"].tolist() == [1] * 4


def test_tp_generate_and_speculative_equal_the_reference(base):
    """``generate`` at tp = 2 (the prompt token by token through the tp
    decode, as the reference's) and ``speculative_generate`` with both
    models placed give the reference's tp = 2 ids."""
    jc, tc = _cfgs(n_kv_heads=2)
    p = J.init_params(jax.random.PRNGKey(0), jc)
    jm, tm = _meshes(2, 2)
    prompt = _ids(1, 5, seed=3)
    ref = np.asarray(J.generate(J.shard_params(p, jm, jc),
                                jnp.asarray(prompt), 6, jc, mesh=jm))
    tp_params = params_from_jax(_host(p), mesh=tm, cfg=tc)
    out = T.generate(tp_params, torch.from_numpy(prompt), 6, tc, mesh=tm)
    np.testing.assert_array_equal(out.numpy(), ref)
    dkw = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=4,
               n_kv_heads=2, d_ff=32, max_seq=32)
    dc = T.TransformerConfig(**dkw, dtype=torch.float32)
    dp = params_from_jax(_host(J.init_params(
        jax.random.PRNGKey(9), J.TransformerConfig(**dkw,
                                                   dtype=jnp.float32))),
        mesh=tm, cfg=dc)
    spec, stats = T.speculative_generate(tp_params, dp,
                                         torch.from_numpy(prompt), 6, tc, dc,
                                         k_draft=3, mesh=tm)
    np.testing.assert_array_equal(spec.numpy(), ref)
    assert stats["rounds"] >= 1


def test_gqa_ring_composition_matches_the_reference_and_dense():
    """attention="ring" at tp = 2 with GQA: q/k/v to sequence shards,
    compact K/V rotate the ring, the output back to head shards.  The
    logits equal the reference's ring prefill and the dense single-chip
    ones; the K/V come back split by KV head, equal to dense."""
    jc, tc = _cfgs(n_kv_heads=2, attention="ring")
    jd, td = _cfgs(n_kv_heads=2)
    p = J.init_params(jax.random.PRNGKey(0), jc)
    jm, tm = _meshes(2, 2)
    ids = _ids(4, 16)
    ref, jcache = jax.jit(lambda q, i: J.prefill(q, i, jc, max_len=16,
                                                 mesh=jm))(
        J.shard_params(p, jm, jc), jnp.asarray(ids))
    host = params_from_jax(_host(p))
    out, cache = T.prefill(T.shard_params(host, tm, tc),
                           torch.from_numpy(ids), tc, max_len=16, mesh=tm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    dense, dcache = T.prefill(host, torch.from_numpy(ids), td, max_len=16)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-4)
    np.testing.assert_allclose(unshard(cache["k"]).numpy(),
                               dcache["k"].numpy(), atol=2e-4)
    np.testing.assert_allclose(unshard(cache["v"]).numpy(),
                               np.asarray(jcache["v"]), atol=2e-4)


def test_ring_kv_chunk_does_not_change_the_prefill():
    _, tc = _cfgs(attention="ring")
    _, tcc = _cfgs(attention="ring", ring_kv_chunk=2)
    host = params_from_jax(_host(J.init_params(jax.random.PRNGKey(0),
                                               JTINY)))
    tm = make_mesh(n_devices=4, tp=4, device="cpu")
    sp = T.shard_params(host, tm, TTINY)
    ids = torch.from_numpy(_ids(2, 16))
    a, _ = T.prefill(sp, ids, tc, max_len=16, mesh=tm)
    b, _ = T.prefill(sp, ids, tcc, max_len=16, mesh=tm)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_kv_heads_below_tp_rejected_up_front():
    jc, tc = _cfgs(n_kv_heads=1)  # MQA with tp = 4: no head dim to split
    p = J.init_params(jax.random.PRNGKey(0), jc)
    jm, tm = _meshes(8, 4)
    with pytest.raises(ValueError, match="n_kv_heads"):
        J.shard_params(p, jm, jc)
    with pytest.raises(ValueError, match="n_kv_heads"):
        T.shard_params(params_from_jax(_host(p)), tm, tc)
    with pytest.raises(ValueError, match="n_kv_heads"):
        T.init_cache(tc, 2, max_len=8, mesh=tm)


def test_int8_attention_refused_under_a_mesh(base):
    jm, tm = _meshes(2, 2)
    jfull = J.quantize_attn_params(J.quantize_ffn_params(base))
    with pytest.raises(ValueError, match="single-chip"):
        J.decode_step(jfull, J.init_cache(JTINY, 2, max_len=8),
                      jnp.zeros((2,), jnp.int32), JTINY, mesh=jm)
    tfull = params_from_jax(_host(jfull))
    with pytest.raises(ValueError, match="single-chip"):
        T.shard_params(tfull, tm, TTINY)
    # a tree placed over pipeline stages trains (forward with pp); the
    # serving paths refuse its mesh
    pm = make_mesh(n_devices=4, tp=2, pp=2, device="cpu")
    staged = T.shard_params(params_from_jax(_host(base)), pm, TTINY, pp=2)
    with pytest.raises(NotImplementedError, match="training"):
        T.prefill(staged, torch.zeros((2, 4), dtype=torch.long), TTINY,
                  max_len=8, mesh=pm)


def test_serving_dryrun_as_the_reference():
    """``_dryrun_serving``'s body in both packages: A, single-chip int8
    with the flash prefill and the decode it hands over to; B, int8
    tensor-parallel decode on mesh(dp=4, tp=2), two steps.  The ids are
    EQUAL and the logits agree."""
    kw = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_seq=32, use_flash=True)
    jc = J.TransformerConfig(**kw, dtype=jnp.float32)
    tc = T.TransformerConfig(**kw, dtype=torch.float32)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                        128))
    # A
    jq1 = J.quantize_ffn_params(params)
    jl, jcache = jax.jit(lambda p, i: J.prefill(p, i, jc, max_len=16,
                                                logit_pos=7))(
        jq1, jnp.asarray(ids))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    jl1, _ = jax.jit(lambda p, c, t: J.decode_step(p, c, t, jc))(
        jq1, jcache, jtok)
    tq1 = params_from_jax(_host(jq1))
    tl, tcache = T.prefill(tq1, torch.from_numpy(ids), tc, max_len=16,
                           logit_pos=7)
    ttok = tl.argmax(-1)
    tl1, _ = T.decode_step(tq1, tcache, ttok, tc)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    # one float32 ulp upstream (XLA's fused jit against torch) can move one
    # activation of the int8 FFN by one quantization step, which moves
    # these unit-scale logits by about 0.01-0.02 (ROADMAP Queue 3): the
    # bound here is Q8_STEP_ATOL, the ids stay EQUAL
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1),
                               atol=Q8_STEP_ATOL)
    np.testing.assert_array_equal(tl1.numpy().argmax(-1),
                                  np.asarray(jl1).argmax(-1))
    # B
    jm, tm = _meshes(8, 2)
    B = 2 * 4
    jq = J.quantize_ffn_params(J.shard_params(params, jm, jc), mesh=jm)
    tq = params_from_jax(_host(jq), mesh=tm, cfg=tc)
    jstep = jax.jit(lambda p, c, t: J.decode_step(p, c, t, jc, mesh=jm))
    jc_ = J.init_cache(jc, B, max_len=16)
    tc_ = T.init_cache(tc, B, max_len=16, mesh=tm)
    jt = jnp.zeros((B,), jnp.int32)
    tt = torch.zeros((B,), dtype=torch.long)
    for _ in range(2):
        jl, jc_ = jstep(jq, jc_, jt)
        tl, tc_ = T.decode_step(tq, tc_, tt, tc, mesh=tm)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert np.isfinite(tl.numpy()).all()
    assert tq["lm_head"]["values"][0].shape[1] == kw["vocab_size"] // 2
