"""The port's speculative decoding against the JAX reference on the CPU.

- ``rejection_verify``: greedy rows give the reference's ``(tokens,
  n_emit)`` EXACTLY on the same inputs; sampled rows emit tokens whose
  marginal is the target distribution p (chi-square, V = 8).
- The slab and paged speculative engines' greedy ids EQUAL the reference's
  speculative engine's and the port's plain engine's, for int8 none, ffn
  and full, with a draft that agrees with the target often but not always
  (the target's weights plus seeded noise) and with a small unrelated draft.
- A perfect draft (the target itself) accepts every draft, greedy and
  sampled; it leaves no unwritten row in the draft's cache.
- Sampled speculation is seed-deterministic, runs beside greedy slots in
  the same ticks, draws the paged engine's ids equal to the slab engine's,
  and its second token follows the target's exact conditional
  distribution.
- Speculation composes with registered and automatic prefixes, chunked
  and batched prefill, page aliasing and preemption; slots and pages come
  back; ``from_checkpoint(draft_path=)`` loads the draft.
- ``generate`` and ``speculative_generate`` give the reference's ids.

Small size: 2 layers, d64, vocab 256, float32, weights converted from the
reference's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtf
from seldon_core_tpu.runtime import llm as jllm
from seldon_core_tpu.runtime import paged as jpaged
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime import paged as tpaged

_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **_KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **_KW)
# a small unrelated draft (low acceptance)
_DKW = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=2, d_ff=64,
            max_seq=64)
JDCFG = jtf.TransformerConfig(dtype=jnp.float32, **_DKW)
TDCFG = ttf.TransformerConfig(dtype=torch.float32, **_DKW)
_BASE = jtf.init_params(jax.random.PRNGKey(0), JCFG)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(tree, scale, seed):
    """The target's float weights plus seeded noise of ``scale`` times each
    leaf's spread: a draft that agrees with the target often, not always."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(treedef, [
        x + scale * jnp.std(x) * jax.random.normal(k, x.shape)
        for x, k in zip(leaves, keys)])


JNOISY = _noisy(_BASE, 0.1, 7)
TNOISY = convert.params_from_jax(_host(JNOISY))
JSMALL = jtf.init_params(jax.random.PRNGKey(7), JDCFG)
TSMALL = convert.params_from_jax(_host(JSMALL))
_CACHE: dict = {}


def _params(int8: str = "none"):
    if int8 not in _CACHE:
        p = _BASE
        if int8 in ("ffn", "full"):
            p = jtf.quantize_ffn_params(p)
        if int8 == "full":
            p = jtf.quantize_attn_params(p)
        _CACHE[int8] = (p, convert.params_from_jax(_host(p)))
    return _CACHE[int8]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 256, size=n).astype(
        np.int32)


def _ref_ids(p, n, int8="none"):
    jp, _ = _params(int8)
    return np.asarray(jtf.generate(jp, jnp.asarray(p)[None], n, JCFG))[0]


def _port(kind="slab", int8="none", draft="noisy", pages=(48, 4), **kw):
    """A port engine, speculative with ``draft`` ("noisy", "small",
    "perfect") or plain (None)."""
    _, tp = _params(int8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 40)
    if draft is not None:
        dp, dcfg = {"noisy": (TNOISY, TCFG), "small": (TSMALL, TDCFG),
                    "perfect": (tp, TCFG)}[draft]
        kw.update(draft_params=dp, draft_cfg=dcfg)
    if kind == "slab":
        return tllm.LLMEngine(tp, TCFG, **kw)
    return tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(*pages), **kw)


def _ref(kind="slab", int8="none", pages=(48, 4), **kw):
    """The reference's speculative engine with the noisy draft."""
    jp, _ = _params(int8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 40)
    kw.update(draft_params=JNOISY, draft_cfg=JCFG)
    if kind == "slab":
        return jllm.LLMEngine(jp, JCFG, **kw)
    return jllm.PagedLLMEngine(jp, JCFG, jpaged.PagedConfig(*pages), **kw)


def _drained(eng):
    """Every slot (and page) back."""
    assert not eng._slots and sorted(eng._free) == list(range(eng.max_slots))
    if isinstance(eng, tllm.PagedLLMEngine):
        assert eng.free_pages == eng.paged_cfg.n_pages - 1 - eng._pinned_pages


REQS = [(_prompt(5, 1), 12), (_prompt(9, 2), 8), (_prompt(3, 3), 10),
        (_prompt(14, 4), 7)]


async def _gather(eng, reqs=REQS, **kw):
    return [o.reshape(-1).tolist() if isinstance(o, torch.Tensor)
            else np.asarray(o).reshape(-1).tolist()
            for o in await asyncio.gather(*(eng.generate(p, n, **kw)
                                            for p, n in reqs))]


# ----------------------------------------------------------------------
# rejection_verify
# ----------------------------------------------------------------------

def _verify_inputs(S=16, k=4, V=16, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((S, k + 1, V)).astype(np.float32) ** 3
    q = rng.random((S, k, V)).astype(np.float32) ** 3
    p /= p.sum(-1, keepdims=True)
    q /= q.sum(-1, keepdims=True)
    tgt = rng.integers(0, V, size=(S, k + 1)).astype(np.int32)
    drafts = rng.integers(0, V, size=(S, k)).astype(np.int32)
    # row s agrees with the target on its first s % (k + 1) drafts
    for s in range(S):
        n = s % (k + 1)
        drafts[s, :n] = tgt[s, :n]
    return p, q, drafts, tgt


def test_rejection_verify_greedy_rows_equal_reference():
    p, q, drafts, tgt = _verify_inputs()
    S, k = drafts.shape
    temps = np.zeros((S,), np.float32)
    temps[1::4] = 0.7  # sampled rows beside the greedy ones
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(S)])
    jt, jn, _ = jllm.rejection_verify(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(drafts),
        jnp.asarray(tgt), jnp.asarray(temps), jnp.asarray(keys, jnp.uint32))
    u = torch.from_numpy(np.random.default_rng(1).random(
        (S, 2 * k + 1)).astype(np.float32))
    tt, tn = tllm.rejection_verify(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafts),
        torch.from_numpy(tgt), torch.from_numpy(temps), u)
    greedy = temps <= 0
    np.testing.assert_array_equal(tt.numpy()[greedy], np.asarray(jt)[greedy])
    np.testing.assert_array_equal(tn.numpy()[greedy], np.asarray(jn)[greedy])
    # every acceptance length 0..k occurs among the greedy rows
    assert set(tn.numpy()[greedy].tolist()) == set(range(1, k + 2))
    # sampled rows: a valid emission of 1..k+1 tokens
    n = tn.numpy()[~greedy]
    assert ((n >= 1) & (n <= k + 1)).all()


#: chi-square quantile at 0.999 with 7 degrees of freedom (V = 8 classes)
CHI2_7_999 = 24.32


def _chi2(counts, p):
    n = counts.sum()
    return float((((counts - n * p) ** 2) / (n * p)).sum())


def test_rejection_verify_sampled_marginals_follow_p():
    """With a draft distribution q far from p, the emitted token at
    position 0 (an accepted draft or a residual resample) and the bonus
    token after an acceptance are p-distributed: chi-square below its
    0.999 quantile (24.32, 7 degrees of freedom), fixed seed."""
    V, k, N = 8, 1, 20000
    p = np.asarray([0.4, 0.2, 0.15, 0.1, 0.05, 0.05, 0.03, 0.02], np.float32)
    q = np.asarray([0.05, 0.05, 0.3, 0.3, 0.1, 0.1, 0.05, 0.05], np.float32)
    rng = np.random.default_rng(0)
    drafts = rng.choice(V, size=(N, k), p=q).astype(np.int64)
    u = torch.from_numpy(rng.random((N, 2 * k + 1)).astype(np.float32))
    tokens, n_emit = tllm.rejection_verify(
        torch.from_numpy(np.tile(p, (N, k + 1, 1))),
        torch.from_numpy(np.tile(q, (N, k, 1))), torch.from_numpy(drafts),
        torch.zeros((N, k + 1), dtype=torch.long), torch.ones(N), u)
    tokens, n_emit = tokens.numpy(), n_emit.numpy()
    assert _chi2(np.bincount(tokens[:, 0], minlength=V), p) < CHI2_7_999
    acc = n_emit == 2
    assert 0.2 * N < acc.sum() < 0.8 * N
    assert _chi2(np.bincount(tokens[acc, 1], minlength=V), p) < CHI2_7_999


def test_draw_never_picks_zero_mass():
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.0]] * 4)
    u = torch.tensor([0.0, 0.4999, 0.5, 1.0 - 2 ** -24])
    assert tllm._draw(probs, u).tolist() == [1, 1, 3, 3]


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------

@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_slab_spec_greedy_equals_reference_spec_and_plain(int8):
    ref = _ref("slab", int8)
    want = asyncio.run(_gather(ref))
    eng = _port("slab", int8)
    got = asyncio.run(_gather(eng))
    plain = _port("slab", int8, draft=None)
    base = asyncio.run(_gather(plain))
    assert got == want == base
    for ids, (p, n) in zip(got, REQS):
        assert ids == _ref_ids(p, n, int8).tolist()
    s = eng.spec_stats
    # partial acceptance: some drafts verify, some do not
    assert 0 < s["accepted"] < s["drafted"], s
    assert s["drafted"] == ref.spec_stats["drafted"]
    assert s["accepted"] == ref.spec_stats["accepted"]
    _drained(eng)
    for e in (eng, plain):
        e.close()


@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_paged_spec_greedy_equals_reference_spec_and_plain(int8):
    eng = _port("paged", int8)
    got = asyncio.run(_gather(eng))
    plain = _port("paged", int8, draft=None)
    base = asyncio.run(_gather(plain))
    assert got == base
    if int8 == "full":  # the main path's mode against the reference's paged
        assert got == asyncio.run(_gather(_ref("paged", int8)))
    else:
        assert got == asyncio.run(_gather(_ref("slab", int8)))
    assert 0 < eng.spec_stats["accepted"] < eng.spec_stats["drafted"]
    _drained(eng)
    eng.close()
    plain.close()


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_small_draft_rejects_and_stays_exact(kind):
    eng = _port(kind, draft="small")
    got = asyncio.run(_gather(eng))
    for ids, (p, n) in zip(got, REQS):
        assert ids == _ref_ids(p, n).tolist()
    assert eng.spec_stats["accepted"] < eng.spec_stats["drafted"] // 4
    _drained(eng)
    eng.close()


def test_stop_token_mid_chunk():
    g = _ref_ids(_prompt(5, 1), 14).tolist()
    stop = g[5 + 8]  # lands inside a speculative chunk
    want = g[:g.index(stop, 5) + 1]
    for kind in ("slab", "paged"):
        eng = _port(kind, draft="perfect")
        got = asyncio.run(eng.generate(_prompt(5, 1), 14,
                                       stop_tokens=[stop]))
        assert got[0].tolist() == want
        _drained(eng)
        eng.close()


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_perfect_draft_accepts_everything_greedy_and_sampled(kind):
    eng = _port(kind, draft="perfect", k_draft=3)
    pg, ps = _prompt(5, 1), _prompt(4, 2)

    async def run():
        return await asyncio.gather(
            eng.generate(pg, 14),
            eng.generate(ps, 9, temperature=1.0, seed=9))

    g, s = asyncio.run(run())
    assert g[0].tolist() == _ref_ids(pg, 14).tolist()
    assert s.shape == (1, 4 + 9)
    st = eng.spec_stats
    assert st["rounds"] > 0 and st["accepted"] == st["drafted"], st
    # 14 tokens at up to 4 a tick: the first from the prefill, then 4
    # ticks, not 13
    assert st["rounds"] <= 5
    _drained(eng)
    eng.close()


def test_no_draft_kv_holes_after_full_acceptance():
    """After a full acceptance the rewound position counts d_{k-1}'s row
    as valid: the draft's extra step must have written it.  Every draft
    row below the last tick's position is non-zero."""
    eng = _port("slab", draft="perfect", max_slots=1, k_draft=4)
    asyncio.run(eng.generate(_prompt(5, 1), 12))
    assert eng.spec_stats["accepted"] == eng.spec_stats["drafted"]
    # 1 token from the prefill, then ticks at positions 5, 10 and 15
    k = eng.draft_cache["k"].numpy()  # (layers, 1, T, Hkv, Dh)
    norms = np.abs(k[:, 0, :15]).sum(axis=(0, 2, 3))
    assert (norms > 0).all(), np.where(norms == 0)[0]
    eng.close()


def test_sampled_speculation_is_seed_deterministic_and_mixes_with_greedy():
    kw = dict(temperature=1.0, top_k=8, seed=13)

    async def run(eng):
        return await asyncio.gather(
            eng.generate(_prompt(4, 5), 10),
            eng.generate(_prompt(6, 3), 10, **kw))

    outs = []
    for _ in range(2):
        eng = _port("slab")
        outs.append([o[0].tolist() for o in asyncio.run(run(eng))])
        assert eng.spec_stats["rounds"] >= 1
        _drained(eng)
        eng.close()
    assert outs[0] == outs[1]
    assert outs[0][0] == _ref_ids(_prompt(4, 5), 10).tolist()
    assert all(0 <= t < 256 for t in outs[0][1])


def test_paged_sampled_equals_slab_sampled():
    """The same draws (one uniform block per slot per tick, from the same
    seeded generator) and the same math: the paged engine's sampled ids
    equal the slab engine's."""
    kw = dict(temperature=0.8, top_k=16, top_p=0.9, seed=5)
    outs = []
    for kind in ("slab", "paged"):
        eng = _port(kind)
        outs.append(asyncio.run(_gather(eng, REQS[:3], **kw)))
        eng.close()
    assert outs[0] == outs[1]


#: chi-square quantile at 0.999 with 9 degrees of freedom (10 bins)
CHI2_9_999 = 27.88


def test_sampled_second_token_follows_target_distribution():
    """The second generated token (the first from a speculative tick) over
    200 seeds, each against its exact conditional distribution given the
    first: the target's filtered distribution after prompt + first token.
    Each draw x maps to ``F(x - 1) + v * P(x)`` with a seeded uniform v,
    which is uniform on [0, 1) exactly when x follows P; 10 equal bins of
    it pass a chi-square test below its 0.999 quantile (27.88, 9 degrees
    of freedom)."""
    N, kw = 200, dict(temperature=1.0, top_k=8)
    p = _prompt(5, 1)
    eng = _port("slab")

    async def collect():
        return [(await eng.generate(p, 2, seed=s, **kw))[0, -2:].tolist()
                for s in range(N)]

    pairs = asyncio.run(collect())
    assert eng.spec_stats["rounds"] == N
    eng.close()
    _, tp = _params()
    cond = {}
    for t1 in {a for a, _ in pairs}:
        ids = torch.from_numpy(np.append(p, t1)).long()[None]
        logits, _ = ttf.prefill(tp, ids, TCFG, max_len=6, logit_pos=5)
        cond[t1] = tllm.filtered_probs(logits, torch.ones(1),
                                       torch.tensor([8]),
                                       torch.ones(1))[0].double().numpy()
    v = np.random.default_rng(0).random(N)
    pit = np.asarray([cond[a][:b].sum() + vi * cond[a][b]
                      for (a, b), vi in zip(pairs, v)])
    counts = np.bincount(np.minimum((pit * 10).astype(int), 9), minlength=10)
    assert _chi2(counts, np.full(10, 0.1)) < CHI2_9_999, counts


# ----------------------------------------------------------------------
# composition with slice 3a's features
# ----------------------------------------------------------------------

def _features_scenario(eng):
    pre = _prompt(12, 11)

    async def run():
        eng.register_prefix(pre)
        full = np.concatenate([pre, _prompt(5, 12)])
        auto = np.concatenate([_prompt(20, 13), _prompt(4, 14)])
        first = await eng.generate(auto, 6)
        again = np.concatenate([auto[:16], _prompt(6, 15)])
        outs = await asyncio.gather(eng.generate(full, 8),
                                    eng.generate(pre, 5),
                                    eng.generate(again, 7),
                                    eng.generate(_prompt(11, 16), 9))
        return [first] + list(outs), [auto, full, pre, again,
                                      _prompt(11, 16)], [6, 8, 5, 7, 9]

    return run()


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_spec_composes_with_prefixes_chunking_and_batching(kind):
    eng = _port(kind, chunk_prefill=8, auto_prefix_tokens=64,
                auto_prefix_granularity=8, batch_prefill_ms=2.0)
    outs, prompts, ns = asyncio.run(_features_scenario(eng))
    for o, p, n in zip(outs, prompts, ns):
        assert o[0].tolist() == _ref_ids(p, n).tolist()
    assert eng.prefix_stats["auto_hits"] >= 1
    if kind == "paged":
        assert eng.prefix_stats["alias_hits"] >= 1
    assert eng.spec_stats["accepted"] > 0
    eng.clear_prefixes()
    _drained(eng)
    eng.close()


def test_spec_batched_prefill_window_groups():
    eng = _port("paged", batch_prefill_ms=20.0)
    got = asyncio.run(_gather(eng))
    for ids, (p, n) in zip(got, REQS):
        assert ids == _ref_ids(p, n).tolist()
    assert eng.prefill_batch_stats["groups"] < len(REQS)
    _drained(eng)
    eng.close()


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_spec_preemption_resumes_greedy_and_sampled(kind):
    """A speculating low-class request is preempted by a priority-1
    arrival and resumes through the draft's prefill: greedy it emits the
    reference's ids, sampled the ids of its unpreempted run (its generator
    state is restored as of its last emitted token)."""
    extra = {"pages": (14, 4)} if kind == "paged" else {}
    p_low, p_high = _prompt(4, 1), _prompt(6, 5)
    for kw in ({}, dict(temperature=0.8, top_k=16, seed=3)):
        solo = _port(kind, max_slots=1, **extra)
        want = asyncio.run(solo.generate(p_low, 20, **kw))[0, 4:].tolist()
        solo.close()

        async def run(eng):
            gen = eng.stream(p_low, 20, **kw)
            low = [await gen.__anext__() for _ in range(3)]
            high = await eng.generate(p_high, 6, priority=1)
            assert eng.preempt_stats["preempted"] == 1
            low += [t async for t in gen]
            assert eng.preempt_stats["resumed"] == 1
            return low, high[0].tolist()

        eng = _port(kind, max_slots=1, **extra)
        low, high = asyncio.run(run(eng))
        assert low == want
        if not kw:
            assert low == _ref_ids(p_low, 20)[4:].tolist()
        assert high == _ref_ids(p_high, 6).tolist()
        _drained(eng)
        eng.close()


def test_paged_headroom_in_reservations_and_max_len_check():
    eng = _port("paged", k_draft=4, pages=(48, 4))
    # max_len 40 + 5 rows of headroom = 12 pages
    assert eng.max_pp == 12 and eng._headroom == 5
    assert eng.draft_cache["k"].shape[2] == 45

    async def run():
        gen = eng.stream(_prompt(5, 1), 10)
        await gen.__anext__()
        used = eng.paged_cfg.n_pages - 1 - eng.free_pages
        await gen.aclose()
        return used

    assert asyncio.run(run()) == 5  # ceil((5 + 10 + 5) / 4)
    _drained(eng)
    eng.close()
    with pytest.raises(ValueError, match="headroom"):
        _port("paged", pages=(11, 4))  # 10 usable < 12
    tllm.PagedLLMEngine(_params()[1], TCFG, tpaged.PagedConfig(11, 4),
                        max_len=40).close()  # no draft: 10 pages suffice


def test_slab_cache_headroom_and_pairing_check():
    eng = _port("slab", k_draft=3)
    assert eng.cache["k"].shape[2] == 40 + 4
    eng.close()
    with pytest.raises(ValueError, match="go together"):
        tllm.LLMEngine(_params()[1], TCFG, draft_params=TNOISY)
    with pytest.raises(ValueError, match="k_draft"):
        _port("slab", k_draft=0)


def test_component_reports_spec_accept_rate():
    from seldon_core_tpu_torch.messages import SeldonMessage

    eng = _port("paged")
    comp = tllm.LLMComponent(eng, n_new=6)
    out = asyncio.run(comp.predict(SeldonMessage(
        json_data={"prompt_ids": _prompt(5, 1).tolist(), "n_new": 8})))
    m = {x.key: x.value for x in out.meta.metrics}
    rate = eng.spec_stats["accepted"] / eng.spec_stats["drafted"]
    assert m["seldon_llm_spec_accept_rate"] == pytest.approx(rate)
    eng.close()


def test_from_checkpoint_loads_the_draft(tmp_path):
    from seldon_core_tpu_torch.runtime import checkpoint as tck

    _, tp = _params()
    tck.save_transformer(str(tmp_path / "target"), tp, TCFG)
    tck.save_transformer(str(tmp_path / "draft"), TNOISY, TCFG)
    eng = tllm.PagedLLMEngine.from_checkpoint(
        str(tmp_path / "target"), device="cpu",
        draft_path=str(tmp_path / "draft"), int8="full",
        paged=tpaged.PagedConfig(48, 4), max_slots=4, max_len=40)
    assert eng.draft_cfg == TCFG
    for name in ("embed", "lm_head"):
        assert torch.equal(eng.draft_params[name], TNOISY[name])
    got = asyncio.run(_gather(eng))
    for ids, (p, n) in zip(got, REQS):
        assert ids == _ref_ids(p, n, "full").tolist()
    assert eng.spec_stats["accepted"] > 0
    eng.close()


# ----------------------------------------------------------------------
# the one-request loops
# ----------------------------------------------------------------------

def test_generate_equals_reference():
    for int8 in ("none", "full"):
        jp, tp = _params(int8)
        p = _prompt(6, 3)
        got = ttf.generate(tp, torch.from_numpy(p).long()[None], 12, TCFG)
        assert got[0].tolist() == _ref_ids(p, 12, int8).tolist()
    # sampled: seed-deterministic, in the vocabulary
    g = [ttf.generate(tp, torch.from_numpy(p).long()[None], 8, TCFG,
                      temperature=0.9,
                      generator=torch.Generator().manual_seed(4))
         for _ in range(2)]
    assert torch.equal(g[0], g[1]) and int(g[0].max()) < 256


@pytest.mark.parametrize("draft", ["noisy", "small", "perfect"])
def test_speculative_generate_equals_reference(draft):
    """Ids equal the reference's (and the target's greedy decode), and so
    do ``rounds`` and ``accept_rate``: both drafts make k steps a round."""
    jd, td, jdc, tdc = {
        "noisy": (JNOISY, TNOISY, JCFG, TCFG),
        "small": (JSMALL, TSMALL, JDCFG, TDCFG),
        "perfect": (_BASE, _params()[1], JCFG, TCFG)}[draft]
    p = _prompt(6, 8)
    want, jstats = jtf.speculative_generate(_BASE, jd, jnp.asarray(p)[None],
                                            20, JCFG, jdc, k_draft=4)
    got, stats = ttf.speculative_generate(
        _params()[1], td, torch.from_numpy(p).long()[None], 20, TCFG, tdc,
        k_draft=4)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    assert got[0].tolist() == _ref_ids(p, 20).tolist()
    assert stats["rounds"] >= 1
    assert stats == jstats
