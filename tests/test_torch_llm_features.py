"""The port's engine features against the JAX reference on the CPU.

The reference engine and the port's engine run the same requests with the
same features on (the reference's weights converted); their greedy ids
must be EQUAL, and EQUAL to the reference's own ``generate``.  Covered:
the slab engine and ``decode_step`` (one token and K-token chunks),
registered prefixes, automatic prefix caching, chunked prefill, batched
admission prefill, the paged engine's shared-prefix page aliasing,
component metrics, ``DemoLLM``'s defaults, and that a kept prefix entry
owns its storage (the port writes caches in place).
"""

import asyncio
import time

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

JCFG = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=torch.float32)
_BASE = jtf.init_params(jax.random.PRNGKey(0), JCFG)
_CACHE: dict = {}


def _params(int8: str = "none"):
    if int8 not in _CACHE:
        p = _BASE
        if int8 in ("ffn", "full"):
            p = jtf.quantize_ffn_params(p)
        if int8 == "full":
            p = jtf.quantize_attn_params(p)
        _CACHE[int8] = (p, convert.params_from_jax(jax.tree.map(np.asarray,
                                                                 p)))
    return _CACHE[int8]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 64, size=n).astype(
        np.int32)


def _ref_ids(p, n, int8="none"):
    """The reference's own greedy decode (``models/transformer.generate``)."""
    jp, _ = _params(int8)
    return np.asarray(jtf.generate(jp, jnp.asarray(p)[None], n, JCFG))[0]


#: the reference engine's host mirrors that its tick programs take
_MIRRORS = ("_tokens", "_pos", "_temps", "_topk", "_topp", "_keys", "_tables")


def snapshot_dispatch(jeng):
    """Make the reference engine's ticks read a private copy of its host
    mirrors.  Its ``_dispatch_plain``/``_dispatch_spec`` hand the live
    arrays to a jitted tick; on the CPU, ``jnp.asarray`` of a 64-byte
    aligned numpy array is that array's buffer, not a copy, and the tick
    runs asynchronously, so an admission that maps a slot's shared pages
    while the tick waits to run changes what the tick reads (beside busy
    processes the reference's aliased slot then decoded ``[18, 40, 19,
    ...]`` where its own ``generate`` gives ``[18, 18, 18, ...]``:
    :func:`test_reference_tick_never_reads_a_later_alias_mapping`).  The
    copy is the snapshot the engine means to dispatch; the engine's code
    is unchanged."""
    def snap(dispatch):
        def run():
            live = {n: getattr(jeng, n) for n in _MIRRORS if hasattr(jeng, n)}
            for n, a in live.items():
                setattr(jeng, n, a.copy())
            try:
                return dispatch()
            finally:
                for n, a in live.items():
                    setattr(jeng, n, a)
        return run

    jeng._dispatch_plain = snap(jeng._dispatch_plain)
    jeng._dispatch_spec = snap(jeng._dispatch_spec)
    return jeng


def _engines(kind="slab", int8="none", paged=(33, 4), **kw):
    """A reference engine (:func:`snapshot_dispatch`) and a port engine with
    the same knobs."""
    jp, tp = _params(int8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 32)
    if kind == "slab":
        return (snapshot_dispatch(jllm.LLMEngine(jp, JCFG, **kw)),
                tllm.LLMEngine(tp, TCFG, **kw))
    return (snapshot_dispatch(
        jllm.PagedLLMEngine(jp, JCFG, jpaged.PagedConfig(*paged), **kw)),
            tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(*paged), **kw))


def _both(scenario, kind="slab", int8="none", **kw):
    """Run ``scenario(engine)`` (a coroutine function returning a list of
    id arrays) on both engines; assert the ids EQUAL; return the port
    engine (closed) and its ids."""
    jeng, teng = _engines(kind, int8, **kw)
    want = asyncio.run(scenario(jeng))
    got = asyncio.run(scenario(teng))
    teng.close()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).reshape(-1),
                                      np.asarray(w).reshape(-1))
    return teng, got


def _ids(x):
    return np.asarray(x).reshape(-1)


def _count_jobs(eng, name):
    """Count calls of one of the engine's device jobs."""
    calls = []
    real = getattr(eng, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    setattr(eng, name, spy)
    return calls


# ---- the slab cache and decode_step ---------------------------------------

@pytest.mark.parametrize("int8", ["none", "full"])
def test_decode_step_single_and_chunk_match_reference(int8):
    """One token per row and a K-token chunk per row against a slab cache
    at different positions: logits within 1e-5 of the reference's, and the
    cache rows written at ``pos`` equal."""
    jp, tp = _params(int8)
    rng = np.random.default_rng(3)
    B, T = 3, 24
    k0 = rng.normal(size=(2, B, T, 2, 8)).astype(np.float32)
    v0 = rng.normal(size=(2, B, T, 2, 8)).astype(np.float32)
    pos = np.asarray([0, 5, 13], np.int32)
    for toks in (rng.integers(0, 64, (B,)), rng.integers(0, 64, (B, 6))):
        toks = toks.astype(np.int32)
        jl, jc = jtf.decode_step(
            jp, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                 "pos": jnp.asarray(pos)}, jnp.asarray(toks), JCFG)
        tcache = {"k": torch.from_numpy(k0.copy()),
                  "v": torch.from_numpy(v0.copy()),
                  "pos": torch.from_numpy(pos)}
        tl, tc = ttf.decode_step(tp, tcache, torch.from_numpy(toks).long(),
                                 TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        assert tc["k"] is tcache["k"]  # written in place


@pytest.mark.parametrize("int8", ["none", "full"])
def test_slab_engine_matches_reference_slab_engine(int8):
    reqs = [(_prompt(4, 0), 6), (_prompt(7, 2), 4), (_prompt(13, 3), 9),
            (_prompt(1, 4), 5), (_prompt(9, 5), 7)]

    async def run(eng):
        return await asyncio.gather(*(eng.generate(p, n) for p, n in reqs))

    teng, got = _both(run, "slab", int8)
    for (p, n), g in zip(reqs, got):
        np.testing.assert_array_equal(_ids(g), _ref_ids(p, n, int8))
    assert sorted(teng._free) == [0, 1, 2, 3] and not teng._slots


def test_slab_engine_equals_paged_engine_sampled_and_stop():
    """The two caches serve the same ids within the port, greedy, sampled
    (one seed per request) and with a stop token."""
    _, tp = _params("full")
    reqs = [(_prompt(5, s), 8) for s in range(4)]

    async def run(eng):
        g = await asyncio.gather(*(eng.generate(p, n) for p, n in reqs))
        s = await asyncio.gather(*(
            eng.generate(p, n, temperature=0.9, top_k=12, seed=7 + i)
            for i, (p, n) in enumerate(reqs)))
        stop = int(g[0][0, 7])
        t = await eng.generate(reqs[0][0], 8, stop_tokens=(stop,))
        return g + s + [t]

    slab = tllm.LLMEngine(tp, TCFG, max_slots=3, max_len=32)
    paged = tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(17, 4),
                                max_slots=3, max_len=32)
    a, b = asyncio.run(run(slab)), asyncio.run(run(paged))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a[-1].shape[1] <= 5 + 8
    slab.close()
    paged.close()
    assert paged.free_pages == 16


# ---- registered prefixes ----------------------------------------------------

@pytest.mark.parametrize("kind", ["slab", "paged"])
@pytest.mark.parametrize("int8", ["none", "full"])
def test_registered_prefix_suffix_matches_reference(kind, int8):
    p = _prompt(16, 3)

    async def run(eng):
        eng.register_prefix(p[:12])
        return [await eng.generate(p, 6)]

    teng, got = _both(run, kind, int8, max_len=48)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(p, 6, int8))


def test_registered_exact_match_runs_zero_model_work():
    p = _prompt(12, 4)

    async def run(eng):
        eng.register_prefix(p)
        if isinstance(eng, tllm.LLMEngine):
            calls = [_count_jobs(eng, "_prefill_rows"),
                     _count_jobs(eng, "_extend_job")]
            out = await eng.generate(p, 5)
            assert calls == [[], []], calls  # no prefill, no extend
            return [out]
        return [await eng.generate(p, 5)]

    _both(run, "slab", max_len=48)


def test_longest_registered_prefix_wins():
    p = _prompt(16, 5)

    async def run(eng):
        eng.register_prefix(p[:4])
        eng.register_prefix(p[:10])
        ids = tuple(int(t) for t in p)
        assert eng._match_prefix(ids)["len"] == 10
        assert eng._match_prefix(ids[:3]) is None
        return [await eng.generate(p, 5)]

    _, got = _both(run, "slab", max_len=48)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(p, 5))


def test_register_prefix_validation_and_clear():
    _, tp = _params()
    eng = tllm.LLMEngine(tp, TCFG, max_slots=2, max_len=16)
    with pytest.raises(ValueError, match="empty"):
        eng.register_prefix([])
    with pytest.raises(ValueError, match="max_len"):
        eng.register_prefix(list(range(16)))
    eng.register_prefix([1, 2, 3])
    assert eng._prefixes
    eng.clear_prefixes()
    assert not eng._prefixes
    eng.close()


# ---- automatic prefix caching ------------------------------------------------

def test_auto_prefix_partial_overlap_matches_reference():
    """B shares the first 20 tokens of A: reuse rounds down to 16 (the
    granularity), and the ids equal the reference's."""
    a = _prompt(28, 40)
    b = np.concatenate([a[:20], _prompt(9, 41)])

    async def run(eng):
        x = await eng.generate(a, 3)
        y = await eng.generate(b, 3)
        return [x, y]

    teng, got = _both(run, "slab", max_len=48, auto_prefix_tokens=256)
    assert teng.prefix_stats["auto_hits"] == 1
    assert teng.prefix_stats["auto_tokens_reused"] == 16
    np.testing.assert_array_equal(_ids(got[1]), _ref_ids(b, 3))


def test_auto_prefix_eviction_budget_matches_reference():
    prompts = [_prompt(20, 50 + s) for s in range(5)]

    async def run(eng):
        out = [await eng.generate(p, 2) for p in prompts]
        stats = dict(eng.prefix_stats)
        lens = [e["len"] for e in eng._auto_entries]
        return out + [np.asarray([stats[k] for k in sorted(stats)
                                  if k.startswith("auto")]),
                      np.asarray(lens)]

    teng, _ = _both(run, "slab", max_len=32, auto_prefix_tokens=48,
                    auto_prefix_granularity=8)
    assert sum(e["len"] for e in teng._auto_entries) <= 48
    assert teng.prefix_stats["auto_evicted"] == 3


def test_registered_prefix_preferred_over_auto_at_equal_length():
    """A registered prefix and an automatic entry cover the same 16
    tokens: the registered one serves (the automatic one wins only when
    strictly longer)."""
    pre = _prompt(16, 70)
    full = np.concatenate([pre, _prompt(1, 71)])

    async def run(eng):
        await eng.generate(np.concatenate([pre, _prompt(3, 72)]), 2)
        eng.register_prefix(pre)
        hits = eng.prefix_stats["auto_hits"]
        out = await eng.generate(full, 3)
        assert eng.prefix_stats["auto_hits"] == hits  # the auto one lost
        return [out]

    _, got = _both(run, "slab", max_len=48, auto_prefix_tokens=256)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(full, 3))


def test_auto_prefix_lru_touch_with_equal_length_entries():
    """Two equal-length entries: a hit on the second is removed and
    re-appended by identity (no comparison of entries), and a later hit
    on the first moves it behind the second."""
    a, b = _prompt(16, 80), _prompt(16, 81)
    b2 = np.concatenate([b, _prompt(4, 82)])
    a2 = np.concatenate([a, _prompt(4, 83)])

    async def run(eng):
        await eng.generate(a, 2)
        await eng.generate(b, 2)
        out = [await eng.generate(b2, 2), await eng.generate(a2, 2)]
        order = [e["ids"] for e in eng._auto_entries]
        for got, want in zip(order, (b, b2, a, a2)):
            assert np.array_equal(got, want)
        return out

    teng, got = _both(run, "slab", max_len=32, auto_prefix_tokens=256)
    assert teng.prefix_stats["auto_hits"] == 2
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(b2, 2))
    np.testing.assert_array_equal(_ids(got[1]), _ref_ids(a2, 2))


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_prefix_entries_own_their_storage(kind):
    """Kept prefix K/V are not views of anything the engine writes later:
    after the slot that stored an automatic entry decodes further, is
    recycled and re-filled, and after a registered prefix serves two
    extends and a whole-prompt hit, both entries' bytes are unchanged."""
    _, tp = _params()
    kw = dict(max_slots=1, max_len=48, auto_prefix_tokens=256)
    eng = (tllm.LLMEngine(tp, TCFG, **kw) if kind == "slab" else
           tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(17, 4), **kw))
    a, pre = _prompt(16, 90), _prompt(12, 93)

    async def run():
        await eng.generate(a, 1)
        # the insert job has run
        await eng._on_device(lambda: None, rec=eng._job("test"))
        e = eng._auto_entries[0]
        eng.register_prefix(pre)
        # the prefix's prefill has run
        await eng._on_device(lambda: None, rec=eng._job("test"))
        r = eng._prefixes[tuple(int(t) for t in pre)]
        before = [x.clone() for x in (e["k"], e["v"], r["k"], r["v"])]
        # the same slot decodes on, then is recycled and re-filled
        await eng.generate(_prompt(16, 91), 20)
        await eng.generate(_prompt(30, 92), 10)
        for suffix in (_prompt(5, 94), _prompt(9, 95)):
            await eng.generate(np.concatenate([pre, suffix]), 6)
        await eng.generate(pre, 6)
        await eng._on_device(lambda: None, rec=eng._job("test"))
        return e, r, before

    e, r, before = asyncio.run(run())
    eng.close()
    for x, x0 in zip((e["k"], e["v"], r["k"], r["v"]), before):
        assert torch.equal(x, x0)
    assert e["k"].untyped_storage().data_ptr() != \
        eng.cache["k"].untyped_storage().data_ptr()
    assert e["k"].shape[2] == 16  # exactly the prompt's rows


# ---- chunked prefill ---------------------------------------------------------

def test_chunked_prefill_multi_chunk_matches_reference():
    lens = (9, 16, 20, 24)

    async def run(eng):
        return [await eng.generate(_prompt(L, L), 6) for L in lens]

    teng, got = _both(run, "slab", max_len=48, chunk_prefill=8)
    for L, g in zip(lens, got):
        np.testing.assert_array_equal(_ids(g), _ref_ids(_prompt(L, L), 6))


def test_long_suffix_after_prefix_hit_is_chunked():
    p = _prompt(36, 4)

    async def run(eng):
        eng.register_prefix(p[:10])
        if isinstance(eng, tllm.LLMEngine):
            prefills = _count_jobs(eng, "_prefill_rows")
            extends = _count_jobs(eng, "_extend_job")
            out = await eng.generate(p, 5)
            assert not prefills and len(extends) == 4  # 26 tokens at C=8
            return [out]
        return [await eng.generate(p, 5)]

    _, got = _both(run, "slab", max_len=64, chunk_prefill=8)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(p, 5))


def test_decode_interleaves_with_chunked_admission():
    """Decode ticks run on the device worker BETWEEN the chunks of a
    chunked admission (each chunk is its own job)."""
    _, tp = _params()
    eng = tllm.LLMEngine(tp, TCFG, max_slots=2, max_len=64, chunk_prefill=8)
    order = []
    for name, tag in (("_tick_device", "tick"), ("_extend_job", "extend")):
        real = getattr(eng, name)

        def spy(*a, _real=real, _tag=tag, **k):
            order.append(_tag)
            return _real(*a, **k)

        setattr(eng, name, spy)

    async def run():
        agen = eng.stream(_prompt(4, 1), 32)
        first = [await agen.__anext__()]

        async def rest():
            return first + [t async for t in agen]

        consumer = asyncio.create_task(rest())
        out = await eng.generate(_prompt(40, 2), 4)  # 5 chunks
        return out, await consumer

    out, a = asyncio.run(run())
    eng.close()
    np.testing.assert_array_equal(_ids(out), _ref_ids(_prompt(40, 2), 4))
    np.testing.assert_array_equal(np.asarray(a), _ref_ids(_prompt(4, 1),
                                                          32)[4:])
    ext = [i for i, x in enumerate(order) if x == "extend"]
    assert len(ext) == 4, order
    assert any("tick" in order[i + 1:j] for i, j in zip(ext, ext[1:])), order


# ---- batched admission prefill ------------------------------------------------

@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_batched_prefill_mixed_lengths_matches_reference(kind):
    reqs = [(_prompt(3, 2), 6), (_prompt(5, 3), 4), (_prompt(9, 4), 5),
            (_prompt(4, 5), 3), (_prompt(17, 6), 4)]

    async def run(eng):
        return await asyncio.gather(*(eng.generate(p, n) for p, n in reqs))

    teng, got = _both(run, kind, max_slots=8, batch_prefill_ms=50.0)
    for (p, n), g in zip(reqs, got):
        np.testing.assert_array_equal(_ids(g), _ref_ids(p, n))
    st = teng.prefill_batch_stats
    assert st["requests"] == len(reqs) and st["groups"] < len(reqs)


def test_batched_prefill_chunk_budget_partition():
    """``chunk_prefill`` bounds a group's padded tokens: 5 rows of bucket 8
    under 16 tokens make at least 3 groups; ids equal the reference's."""
    reqs = [(_prompt(5, s), 3) for s in range(2, 7)]

    async def run(eng):
        return await asyncio.gather(*(eng.generate(p, n) for p, n in reqs))

    teng, got = _both(run, "slab", max_slots=6, chunk_prefill=16,
                      batch_prefill_ms=40.0)
    assert teng.prefill_batch_stats["requests"] == 5
    assert teng.prefill_batch_stats["groups"] >= 3
    part = teng._pf_partition([(None, L, None, None) for L in (5, 5, 9, 3, 20)])
    assert [[x[1] for x in g] for g in part] == [[5, 5], [9], [3], [20]]


def test_batched_prefill_abandoned_waiter_does_not_poison_group():
    async def run(eng):
        t1 = asyncio.create_task(eng.generate(_prompt(4, 2), 5))
        t2 = asyncio.create_task(eng.generate(_prompt(6, 3), 4))
        await asyncio.sleep(0.01)  # both join the window
        t1.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t1
        out = await t2
        assert sorted(eng._free) == [0, 1, 2, 3]
        return [out]

    _, got = _both(run, "slab", batch_prefill_ms=100.0)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(_prompt(6, 3), 4))


def test_batched_prefill_full_group_flushes_early():
    """With every slot's holder in the window the group cannot grow: it
    dispatches at once, not after the 8 s window."""
    async def run(eng):
        t0 = time.perf_counter()
        outs = await asyncio.gather(eng.generate(_prompt(4, 2), 3),
                                    eng.generate(_prompt(5, 3), 3))
        assert time.perf_counter() - t0 < 6.0
        assert eng.prefill_batch_stats["groups"] == 1
        return outs

    _, got = _both(run, "slab", max_slots=2, batch_prefill_ms=8000.0)
    np.testing.assert_array_equal(_ids(got[1]), _ref_ids(_prompt(5, 3), 3))


def test_batched_prefill_high_priority_flushes_window_and_preempts():
    """Window members hold pages while invisible to preemption: a higher
    class flushes the 3 s window at once, the members register, one is
    preempted and resumes (through the window again, as the reference's
    does); every answer equals the reference's."""
    _, tp = _params()
    eng = tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(9, 4),
                              max_slots=4, max_len=32, batch_prefill_ms=3000.0)

    async def run():
        lows = [asyncio.create_task(eng.generate(_prompt(4, s), 10))
                for s in (2, 3)]
        while len(eng._pf_queue) < 2:
            await asyncio.sleep(0.01)
        assert eng.free_pages == 0
        t0 = time.perf_counter()
        high = await eng.generate(_prompt(4, 5), 4, priority=1)
        elapsed = time.perf_counter() - t0
        return high, elapsed, await asyncio.gather(*lows)

    high, elapsed, lows = asyncio.run(run())
    eng.close()
    assert elapsed < 2.5  # never waited out the window
    assert eng.preempt_stats["preempted"] >= 1
    assert eng.preempt_stats["resumed"] == eng.preempt_stats["preempted"]
    assert eng.free_pages == 8
    np.testing.assert_array_equal(_ids(high), _ref_ids(_prompt(4, 5), 4))
    for s, out in zip((2, 3), lows):
        np.testing.assert_array_equal(_ids(out), _ref_ids(_prompt(4, s), 10))


def test_batched_prefill_composes_with_prefix_cache():
    pre = _prompt(8, 9)
    with_prefix = np.concatenate([pre, _prompt(3, 10)])

    async def run(eng):
        eng.register_prefix(pre)
        return await asyncio.gather(eng.generate(with_prefix, 4),
                                    eng.generate(_prompt(5, 11), 4))

    _, got = _both(run, "slab", max_len=48, batch_prefill_ms=30.0)
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(with_prefix, 4))


# ---- paged shared-prefix aliasing -----------------------------------------------

def test_aliased_requests_share_pages_and_stay_exact():
    pre, suf = _prompt(16, 11), _prompt(5, 12)
    full = np.concatenate([pre, suf])
    seen = []

    async def run(eng):
        base = eng.free_pages
        eng.register_prefix(pre)
        assert eng.free_pages == base - 4  # pinned once

        async def one():
            agen = eng.stream(full, 5)
            toks = [await agen.__anext__()]
            if isinstance(eng, tllm.PagedLLMEngine):
                seen.append(eng._tables.copy())
            return np.concatenate([full, toks + [t async for t in agen]])

        outs = await asyncio.gather(*(one() for _ in range(3)))
        assert eng.free_pages == base - 4
        eng.clear_prefixes()
        assert eng.free_pages == base
        return outs

    teng, got = _both(run, "paged")
    for g in got:
        np.testing.assert_array_equal(g, _ref_ids(full, 5))
    shared = {tuple(row[:4]) for t in seen for row in t if row[0] != 0}
    assert len(shared) == 1  # every slot maps the same 4 pages
    assert teng.prefix_stats["alias_hits"] == 3


def test_aliased_partial_page_copies_remainder():
    pre, suf = _prompt(18, 13), _prompt(3, 14)  # 4 full pages + 2 rows
    full = np.concatenate([pre, suf])

    async def run(eng):
        base = eng.free_pages
        eng.register_prefix(pre)
        assert eng.free_pages == base - 4
        out = await eng.generate(full, 4)
        assert eng.free_pages == base - 4
        return [out]

    _, got = _both(run, "paged")
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(full, 4))


def test_clear_prefixes_mid_flight_defers_until_release():
    pre, suf = _prompt(16, 15), _prompt(4, 16)
    full = np.concatenate([pre, suf])

    async def run(eng):
        base = eng.free_pages
        eng.register_prefix(pre)
        agen = eng.stream(full, 6)
        toks = [await agen.__anext__()]
        eng.clear_prefixes()  # in flight: deferred
        assert eng.free_pages == base - 4 - 3
        toks += [t async for t in agen]
        assert eng.free_pages == base
        return [np.asarray(toks)]

    _, got = _both(run, "paged")
    np.testing.assert_array_equal(got[0], _ref_ids(full, 6)[20:])


def test_alias_shrinks_admission_demand():
    pre = _prompt(16, 21)
    fa = np.concatenate([pre, _prompt(4, 22)])
    fb = np.concatenate([pre, _prompt(4, 23)])

    async def run(eng):
        eng.register_prefix(pre)
        a, b = eng.stream(fa, 12), eng.stream(fb, 12)
        # both admitted at once: 4 shared + 2 x 4 owned pages = all 12
        first = await asyncio.gather(a.__anext__(), b.__anext__())
        ta, tb = [first[0]], [first[1]]
        assert len(eng._slots) == 2 and eng.free_pages == 0
        ta += [t async for t in a]
        tb += [t async for t in b]
        return [np.asarray(ta), np.asarray(tb)]

    _, got = _both(run, "paged", paged=(13, 4))
    np.testing.assert_array_equal(got[0], _ref_ids(fa, 12)[20:])
    np.testing.assert_array_equal(got[1], _ref_ids(fb, 12)[20:])


def _aligned_copy(a):
    """``a`` copied into a 64-byte aligned buffer."""
    raw = np.zeros(a.nbytes + 64, np.uint8)
    off = (-raw.ctypes.data) % 64
    out = raw[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_reference_tick_never_reads_a_later_alias_mapping():
    """The flake of ``test_alias_shrinks_admission_demand``, made
    deterministic.  The reference's paged dispatch hands its jitted tick
    ``jnp.asarray(self._tables)``, which on the CPU is the live array itself
    when that is 64-byte aligned, and the tick runs asynchronously: an
    admission's alias mapping made after the dispatch reached the tick, and
    its pos-0 write for the admitting slot landed in the SHARED prefix page.
    A stand-in for the jitted tick keeps what it was handed; a mapping made
    after the dispatch must not reach it (it does without
    :func:`snapshot_dispatch`)."""
    jeng, teng = _engines("paged")
    teng.close()
    jeng._tables = _aligned_copy(jeng._tables)
    handed = {}

    def tick(params, cache, tables, pos, *rest):
        handed["tables"], handed["pos"] = tables, pos
        return None, None, cache

    jeng._step_paged = tick
    jeng._dispatch_plain()
    jeng._tables[1, :4] = [5, 6, 7, 8]  # an admission's alias mapping
    jeng._pos[1] = 20
    assert np.asarray(handed["tables"])[1, :4].tolist() == [0, 0, 0, 0]
    assert int(np.asarray(handed["pos"])[1]) == 0


def test_reregistration_does_not_leak_pinned_pages():
    pre = _prompt(16, 24)

    async def run(eng):
        base = eng.free_pages
        eng.register_prefix(pre)
        eng.register_prefix(pre)
        assert eng.free_pages == base - 4
        eng.clear_prefixes()
        assert eng.free_pages == base
        return [np.asarray([eng.free_pages])]

    _both(run, "paged")


def test_pinning_never_starves_max_len_admissions():
    pre, long = _prompt(16, 25), _prompt(24, 26)

    async def run(eng):
        base = eng.free_pages
        eng.register_prefix(pre)
        assert eng.free_pages == base  # refused: copies instead
        assert not eng._prefixes[tuple(int(t) for t in pre)].get(
            "shared_pages")
        return [await eng.generate(long, 8)]

    _, got = _both(run, "paged", paged=(9, 4))
    np.testing.assert_array_equal(_ids(got[0]), _ref_ids(long, 8))


# ---- component and DemoLLM ---------------------------------------------------------

def test_component_metrics_carry_prefix_page_and_preemption_gauges():
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM

    comp = DemoLLM(d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                   vocab_size=64, max_seq=64, paged_pages=17, page_size=4,
                   auto_prefix_tokens=256, max_slots=1, device="cpu")

    async def run():
        m1 = await comp.predict(SeldonMessage(
            json_data={"prompt_ids": list(range(1, 20)), "n_new": 2}))
        low = comp.engine.stream(np.arange(1, 5, dtype=np.int32), 12)
        await low.__anext__()
        m2 = await comp.predict(SeldonMessage(json_data={
            "prompt_ids": list(range(1, 20)) + [33], "n_new": 2,
            "priority": 1}))
        rest = [t async for t in low]
        return m1, m2, rest

    m1, m2, rest = asyncio.run(run())
    comp.engine.close()
    got = {m.key: m.value for m in m2.meta.metrics}
    assert got["seldon_llm_prefix_hit_rate"] > 0
    assert "seldon_llm_kv_pages_used_ratio" in got
    for k in ("seldon_llm_preempted", "seldon_llm_preempted_total"):
        assert got[k] == 1.0
    assert got["seldon_llm_admission_shed"] == 0.0
    assert len(rest) == 11


def test_demo_llm_defaults_are_the_reference_defaults():
    """``paged_pages`` 0 serves the slab engine, ``auto_prefix_tokens`` -1
    means 4 x max_seq, ``ring_prefill`` is accepted at tp = 1, and the
    served ids equal the paged engine's."""
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM

    kw = dict(d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=64, max_seq=64, seed=3, device="cpu", n_new=6)
    slab = DemoLLM(ring_prefill=16, chunk_prefill=8, batch_prefill_ms=2.0,
                   **kw)
    paged = DemoLLM(paged_pages=33, page_size=4, **kw)
    assert type(slab.engine) is tllm.LLMEngine
    assert type(paged.engine) is tllm.PagedLLMEngine
    assert slab.engine._auto_budget == paged.engine._auto_budget == 256
    assert DemoLLM(auto_prefix_tokens=0, **kw).engine._auto_budget == 0
    with pytest.raises(ValueError, match="int8='full'"):
        DemoLLM(tp=2, int8="full", **kw)
    msg = SeldonMessage(json_data={"prompt_ids": list(range(3, 23))})

    async def both():
        return ((await slab.predict(msg)).json_data["ids"],
                (await paged.predict(msg)).json_data["ids"])

    a, b = asyncio.run(both())
    slab.engine.close()
    paged.engine.close()
    assert a == b and len(a) == 26
