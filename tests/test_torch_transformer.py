"""Port transformer math against the JAX reference on the CPU: rmsnorm,
rope, prefill (logits and K/V) and ticks of paged decode, for int8 "none",
"ffn" and "full" at a small GQA config (d_model 32, 2 layers, 4 query / 2
KV heads, page 4), float32.

Tolerances: the two sides run the same float32 formulas; they differ in
summation order and in the float32 sin/cos/pow/exp implementations of XLA
and PyTorch (an ulp or two), so float comparisons use atol/rtol 1e-5 on
unit-scale values (the largest difference seen is 2.5e-6).  The int8 paths
are held to the same bound: an ulp upstream could in principle move one
activation by one quantization step, but at these inputs none does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtf
from seldon_core_tpu.runtime import paged as jpaged
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.runtime import paged as tpaged

JCFG = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=torch.float32)
_BASE = jtf.init_params(jax.random.PRNGKey(0), JCFG)
ATOL = 1e-5


def _jparams(int8: str):
    p = _BASE
    if int8 in ("ffn", "full"):
        p = jtf.quantize_ffn_params(p)
    if int8 == "full":
        p = jtf.quantize_attn_params(p)
    return p


def _both(int8: str):
    jp = _jparams(int8)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().cpu().numpy()


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    ref = jtf.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    out = ttf.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dh", [8, 16])
def test_rope_matches_reference(dh):
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 7)).astype(np.int32)
    ref = jtf.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = ttf.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_param_layout_matches_reference():
    jp, tp = _both("full")
    assert tuple(tp["blocks"]["wq"]["values"][0].shape) == (32, 32)
    assert tuple(tp["blocks"]["wk"]["values"][1].shape) == (32, 16)
    assert tuple(tp["blocks"]["wo"]["values"][0].shape) == (32, 32)
    assert tuple(tp["lm_head"]["values"].shape) == (32, 64)
    assert len(tp["blocks"]["w1"]["values"]) == JCFG.n_layers
    # the port's own quantization of the same float weights is the same
    tq = ttf.quantize_attn_params(ttf.quantize_ffn_params(
        convert.params_from_jax(jax.tree.map(np.asarray, _BASE))))
    for name in ("wq", "wo", "w1", "w2"):
        for i in range(JCFG.n_layers):
            assert torch.equal(tq["blocks"][name]["values"][i],
                               tp["blocks"][name]["values"][i])


def _int8_values(params):
    """Every int8 ``values`` tensor of a param tree."""
    found = []

    def walk(t):
        if isinstance(t, dict):
            if "values" in t and "scales" in t:
                v = t["values"]
                found.extend(v if isinstance(v, list) else [v])
            else:
                for x in t.values():
                    walk(x)

    walk(params)
    return found


@pytest.mark.parametrize("source", ["init_params_int8", "params_from_jax",
                                    "quantize_attn_ffn"])
def test_int8_values_are_k_major(source):
    """Every way of making int8 weights stores them K-major: shape (K, N),
    strides (1, K), the layout the int8 kernel reads."""
    if source == "init_params_int8":
        p = ttf.init_params_int8(torch.Generator().manual_seed(0), TCFG)
    elif source == "params_from_jax":
        p = _both("full")[1]
    else:
        p = ttf.quantize_attn_params(ttf.quantize_ffn_params(
            ttf.init_params(torch.Generator().manual_seed(0), TCFG)))
    vals = _int8_values(p)
    assert len(vals) == 6 * TCFG.n_layers + 1  # q k v o w1 w2 + lm_head
    for v in vals:
        assert v.dtype == torch.int8
        assert v.stride() == (1, v.shape[0]), (tuple(v.shape), v.stride())


def test_init_params_int8_layout_and_forward():
    """The layer-by-layer int8 init (used for 7B-class models) gives the
    layout of quantize_attn_params(quantize_ffn_params(init_params())),
    with the embedding in the activation dtype, and prefill runs on it."""
    cfg = ttf.TransformerConfig(**{**TCFG.__dict__, "dtype": torch.bfloat16})
    a = ttf.init_params_int8(torch.Generator().manual_seed(0), cfg)
    b = ttf.quantize_attn_params(ttf.quantize_ffn_params(
        ttf.init_params(torch.Generator().manual_seed(0), cfg)))
    assert a["embed"].dtype == torch.bfloat16
    assert tuple(a["embed"].shape) == tuple(b["embed"].shape)
    assert set(a["blocks"]) == set(b["blocks"])
    for name, v in b["blocks"].items():
        if isinstance(v, dict):
            for part in ("values", "scales"):
                assert [tuple(t.shape) for t in a["blocks"][name][part]] == \
                    [tuple(t.shape) for t in v[part]]
                assert a["blocks"][name][part][0].dtype == v[part][0].dtype
        else:
            assert torch.equal(a["blocks"][name], v)  # the ones of ln1/ln2
    assert tuple(a["lm_head"]["values"].shape) == (32, 64)
    logits, cache = ttf.prefill(a, torch.arange(8)[None, :], cfg, max_len=8,
                                logit_pos=7)
    assert logits.shape == (1, 64) and torch.isfinite(logits).all()
    assert cache["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_prefill_logits_and_kv(int8):
    jp, tp = _both(int8)
    ids = np.random.default_rng(1).integers(0, 64, size=(2, 8)).astype(
        np.int32)
    jl, jc = jtf.prefill(jp, jnp.asarray(ids), JCFG, max_len=12)
    tl, tc = ttf.prefill(tp, torch.from_numpy(ids).long(), TCFG, max_len=12)
    atol = ATOL
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=atol, rtol=1e-5)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   atol=atol, rtol=1e-5)
    np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
    # scalar and per-row logit_pos project only those positions
    jl1, _ = jtf.prefill(jp, jnp.asarray(ids), JCFG, max_len=8, logit_pos=5)
    tl1, _ = ttf.prefill(tp, torch.from_numpy(ids).long(), TCFG, max_len=8,
                         logit_pos=5)
    np.testing.assert_allclose(_np(tl1), np.asarray(jl1), atol=atol,
                               rtol=1e-5)
    rows = np.array([3, 7], np.int32)
    jl2, _ = jtf.prefill(jp, jnp.asarray(ids), JCFG, max_len=8,
                         logit_pos=jnp.asarray(rows))
    tl2, _ = ttf.prefill(tp, torch.from_numpy(ids).long(), TCFG, max_len=8,
                         logit_pos=torch.from_numpy(rows))
    np.testing.assert_allclose(_np(tl2), np.asarray(jl2), atol=atol,
                               rtol=1e-5)


def test_flash_prefill_equals_dense_prefill():
    """use_flash routes prefill attention through flash_attention (on the
    CPU its plain version); same logits as the dense path (atol 1e-5)."""
    _, tp = _both("none")
    ids = torch.arange(10)[None, :] % 64
    flash = ttf.TransformerConfig(**{**TCFG.__dict__, "use_flash": True})
    a, _ = ttf.prefill(tp, ids, TCFG, max_len=10)
    b, _ = ttf.prefill(tp, ids, flash, max_len=10)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_paged_decode_ticks(int8):
    """Two prompts prefilled into pages, a third slot inactive (trash page),
    then 4 decode ticks on both sides with the same token feed; logits and
    the whole page pool agree each tick."""
    jp, tp = _both(int8)
    paged_j = jpaged.PagedConfig(n_pages=9, page_size=4)
    paged_t = tpaged.PagedConfig(n_pages=9, page_size=4)
    jcache = jpaged.init_paged_cache(JCFG, paged_j)
    tcache = tpaged.init_paged_cache(TCFG, paged_t)
    rng = np.random.default_rng(2)
    tables = np.array([[3, 5, 1], [2, 7, 0], [0, 0, 0]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    for slot, L0 in ((0, 6), (1, 3)):
        ids = rng.integers(0, 64, size=(1, 8)).astype(np.int32)
        _, jsmall = jtf.prefill(jp, jnp.asarray(ids), JCFG, max_len=8)
        _, tsmall = ttf.prefill(tp, torch.from_numpy(ids).long(), TCFG,
                                max_len=8)
        idx = np.arange(L0)
        rows = tables[slot][idx // 4] * 4 + idx % 4
        jcache = jpaged.insert_rows(jcache, jsmall, jnp.asarray(rows),
                                    true_len=L0)
        tcache = tpaged.insert_rows(tcache, tsmall, torch.from_numpy(rows),
                                    true_len=L0)
    atol = ATOL
    for _ in range(4):
        tok = rng.integers(0, 64, size=(3,)).astype(np.int32)
        jl, jcache = jpaged.paged_decode_step(
            jp, jcache, jnp.asarray(tables), jnp.asarray(pos),
            jnp.asarray(tok), JCFG, paged_j, use_kernel=False)
        tl, tcache = tpaged.paged_decode_step(
            tp, tcache, torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(tok).long(), TCFG, paged_t)
        np.testing.assert_allclose(_np(tl)[:2], np.asarray(jl)[:2],
                                   atol=atol, rtol=1e-5)
        for name in ("k", "v"):
            # page 0 is the trash page: inactive slots' rows, unread
            np.testing.assert_allclose(
                _np(tcache[name])[:, :, 1:], np.asarray(jcache[name])[:, :, 1:],
                atol=atol, rtol=1e-5)
        pos = pos + np.array([1, 1, 0], np.int32)
