"""The port's priority preemption and resume against the JAX reference on
the CPU.

A higher-class admission preempts the lowest-class, most recent active
request under slot or page pressure; the victim resumes by re-prefilling
its prompt and generated tokens.  Greedy ids equal the reference engine's
in the same scenario and the reference's ``generate``.  A SAMPLED victim
emits exactly the ids of its unpreempted run in the port (its generator's
state after its latest emitted token is kept; the port's draws cannot
replay the reference's threefry keys).
"""

import asyncio
import random

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
JP = jtf.init_params(jax.random.PRNGKey(0), JCFG)
TP = convert.params_from_jax(jax.tree.map(np.asarray, JP))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 64, size=n).astype(
        np.int32)


def _ref_ids(p, n):
    return np.asarray(jtf.generate(JP, jnp.asarray(p)[None], n, JCFG))[0]


def _slab(ref=False, **kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_len", 32)
    if ref:
        return jllm.LLMEngine(JP, JCFG, **kw)
    return tllm.LLMEngine(TP, TCFG, **kw)


def _paged(ref=False, pages=9, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 32)
    if ref:
        return jllm.PagedLLMEngine(JP, JCFG, jpaged.PagedConfig(pages, 4),
                                   **kw)
    return tllm.PagedLLMEngine(TP, TCFG, tpaged.PagedConfig(pages, 4), **kw)


def _close(eng):
    if isinstance(eng, tllm.LLMEngine):
        eng.close()


def test_slot_pressure_sampled_resume_equals_unpreempted_run():
    """A sampled low-class request is preempted after 3 tokens by a
    priority-1 arrival, resumes, and emits exactly the ids of its
    unpreempted port run; the high request's greedy ids equal the
    reference's."""
    low_kw = dict(temperature=0.8, top_k=16, top_p=0.9, seed=3)
    p_low, p_high = _prompt(4, 1), _prompt(6, 5)

    async def solo():
        eng = _slab()
        out = await eng.generate(p_low, 10, **low_kw)
        _close(eng)
        return out[0, 4:].tolist()

    async def run():
        eng = _slab()
        gen = eng.stream(p_low, 10, **low_kw)
        low = [await gen.__anext__() for _ in range(3)]
        high = await eng.generate(p_high, 4, priority=1)
        assert eng.preempt_stats["preempted"] == 1
        low += [t async for t in gen]
        assert eng.preempt_stats["resumed"] == 1
        assert not eng._slots and eng._free == [0]
        _close(eng)
        return low, high

    want_low = asyncio.run(solo())
    low, high = asyncio.run(run())
    assert low == want_low
    np.testing.assert_array_equal(high[0].numpy(), _ref_ids(p_high, 4))


def test_paged_sampled_resume_mid_tick_equals_unpreempted_run():
    """Preempted while its tick is in flight: the tick's draw is dropped and
    redone from the kept generator state after the resume."""
    kw = dict(temperature=1.1, top_k=0, top_p=0.95, seed=21)
    p_low = _prompt(5, 7)

    async def solo():
        eng = _paged(pages=17)
        out = await eng.generate(p_low, 12, **kw)
        _close(eng)
        return out[0, 5:].tolist()

    async def run():
        eng = _paged(pages=17, max_slots=1)
        gen = eng.stream(p_low, 12, **kw)
        low = [await gen.__anext__() for _ in range(2)]
        # the next tick is queued before the high request preempts
        high = asyncio.create_task(eng.generate(_prompt(3, 8), 3,
                                                priority=2))
        low += [t async for t in gen]
        await high
        assert eng.preempt_stats["preempted"] == 1
        assert eng.preempt_stats["resumed"] == 1
        assert eng.free_pages == 16
        _close(eng)
        return low

    assert asyncio.run(run()) == asyncio.run(solo())


def test_page_pressure_preempts_and_resumes_like_the_reference():
    p_low, p_high = _prompt(4, 1), _prompt(4, 2)

    async def run(eng):
        gen = eng.stream(p_low, 24)  # 7 of 8 usable pages
        low = [await gen.__anext__() for _ in range(3)]
        assert eng.free_pages == 1
        high = await eng.generate(p_high, 8, priority=1)
        assert eng.preempt_stats["preempted"] == 1
        low += [t async for t in gen]
        assert eng.preempt_stats["resumed"] == 1
        assert eng.free_pages == 8
        _close(eng)
        return np.asarray(low), np.asarray(high).reshape(-1)

    want = asyncio.run(run(_paged(ref=True)))
    got = asyncio.run(run(_paged()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], _ref_ids(p_low, 24)[4:])
    np.testing.assert_array_equal(got[1], _ref_ids(p_high, 8))


def test_resume_reuses_auto_prefix():
    p_low = _prompt(8, 1)

    async def run(eng):
        gen = eng.stream(p_low, 10)
        low = [await gen.__anext__() for _ in range(2)]
        hits = eng.prefix_stats["auto_hits"]
        await eng.generate(_prompt(6, 5), 4, priority=1)
        low += [t async for t in gen]
        assert eng.prefix_stats["auto_hits"] > hits
        _close(eng)
        return np.asarray(low)

    kw = dict(max_len=48, auto_prefix_tokens=256, auto_prefix_granularity=4)
    want = asyncio.run(run(_slab(ref=True, **kw)))
    got = asyncio.run(run(_slab(**kw)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_ids(p_low, 10)[8:])


def test_expired_deadline_sheds_without_preempting():
    async def run():
        eng = _slab()
        gen = eng.stream(_prompt(4), 12)
        await gen.__anext__()
        with pytest.raises(tllm.AdmissionDeadlineError):
            await eng.generate(_prompt(6, 5), 4, priority=1,
                               admit_timeout=0.0)
        assert eng.preempt_stats == {"preempted": 0, "resumed": 0,
                                     "shed": 1}
        await gen.aclose()
        _close(eng)

    asyncio.run(run())


def test_abandon_while_preempted_cancels_resume():
    async def run():
        eng = _slab()
        gen = eng.stream(_prompt(4), 20)
        await gen.__anext__()
        task = asyncio.create_task(eng.generate(_prompt(6, 5), 20,
                                                priority=1))
        while eng.preempt_stats["preempted"] == 0:
            await asyncio.sleep(0)
        await gen.aclose()  # the consumer walks away while preempted
        out = await task
        for _ in range(20):
            await asyncio.sleep(0.01)
        assert eng.preempt_stats["resumed"] == 0
        assert not eng._slots and eng._free == [0]
        _close(eng)
        return out

    np.testing.assert_array_equal(asyncio.run(run())[0].numpy(),
                                  _ref_ids(_prompt(6, 5), 20))


def test_higher_class_admitted_first_and_equal_class_never_preempts():
    order = []

    async def tracked(eng, name, p, prio):
        await eng.generate(p, 3, priority=prio)
        order.append(name)

    async def run():
        eng = _slab()
        gen = eng.stream(_prompt(4), 24, priority=5)  # outranks both
        await gen.__anext__()
        ta = asyncio.create_task(tracked(eng, "low", _prompt(5, 2), 0))
        while len(eng._slot_waiters) < 1:
            await asyncio.sleep(0)
        tb = asyncio.create_task(tracked(eng, "high", _prompt(6, 3), 1))
        while len(eng._slot_waiters) < 2:
            await asyncio.sleep(0)
        assert eng._slots  # both queued while the blocker decodes
        async for _ in gen:
            pass
        await asyncio.gather(ta, tb)
        outs = await asyncio.gather(eng.generate(_prompt(4), 6, priority=3),
                                    eng.generate(_prompt(5, 2), 6,
                                                 priority=3))
        assert eng.preempt_stats["preempted"] == 0
        _close(eng)
        return outs

    outs = asyncio.run(run())
    assert order == ["high", "low"]
    np.testing.assert_array_equal(outs[0][0].numpy(), _ref_ids(_prompt(4), 6))


def test_max_priority_caps_request_override():
    from seldon_core_tpu_torch.messages import SeldonMessage

    async def run():
        eng = _slab()
        comp = tllm.LLMComponent(eng, n_new=2, max_priority=0)
        gen = eng.stream(_prompt(4), 16)
        await gen.__anext__()
        task = asyncio.create_task(comp.predict(SeldonMessage(
            json_data={"prompt_ids": [1, 2, 3], "priority": 999999})))
        await asyncio.sleep(0.1)
        assert eng.preempt_stats["preempted"] == 0  # clamped to 0
        async for _ in gen:
            pass
        out = await task
        _close(eng)
        return out

    assert len(asyncio.run(run()).json_data["ids"]) == 5


@pytest.mark.parametrize("chaos_seed", [7, 23])
def test_randomized_mixed_class_traffic_drains_clean(chaos_seed):
    """Seeded storm over the paged engine with automatic prefixes: random
    priorities, deadlines, lengths, sampling and mid-stream abandons.
    Every request ends as done, shed or abandoned; afterwards every slot,
    page, queue, alias and resume task is back, and each completed greedy
    request's ids equal the reference's."""
    rng = random.Random(chaos_seed)
    eng = _paged(max_slots=3, max_len=24, auto_prefix_tokens=64,
                 auto_prefix_granularity=4)
    shared = _prompt(4, 99)
    greedy = {}

    async def one(i: int) -> str:
        L0 = rng.randint(2, 6)
        p = (np.concatenate([shared, _prompt(L0, i)]) if rng.random() < 0.5
             else _prompt(L0, i))
        n_new = rng.randint(2, 10)
        kw = dict(priority=rng.choice([0, 0, 0, 1, 2]), seed=i)
        if rng.random() < 0.4:
            kw["admit_timeout"] = rng.choice([0.0, 0.05, 0.5])
        if rng.random() < 0.5:
            kw["temperature"] = 0.8
        abandon = rng.randint(1, n_new) if rng.random() < 0.25 else None
        toks = []
        try:
            async for t in eng.stream(p, n_new, **kw):
                toks.append(t)
                if abandon is not None and len(toks) >= abandon:
                    return "abandoned"
            assert 1 <= len(toks) <= n_new
            if "temperature" not in kw:
                greedy[i] = (p, toks)
            return "done"
        except tllm.AdmissionDeadlineError:
            assert not toks  # shedding happens only at admission
            return "shed"

    async def run():
        outcomes = await asyncio.gather(*(one(i) for i in range(40)))
        for _ in range(50):
            if not eng._slots and not eng._resume_tasks:
                break
            await asyncio.sleep(0.05)
        return outcomes

    outcomes = asyncio.run(run())
    eng.close()
    assert set(outcomes) <= {"done", "shed", "abandoned"}
    assert outcomes.count("done") > 0
    st = eng.preempt_stats
    assert st["preempted"] - st["resumed"] <= outcomes.count("abandoned")
    assert not eng._slots and sorted(eng._free) == [0, 1, 2]
    assert eng.free_pages == 8
    assert not (eng._slot_waiters or eng._page_waiters or eng._reserved
                or eng._alias_used or eng._resume_tasks)
    for p, toks in greedy.values():
        np.testing.assert_array_equal(
            toks, _ref_ids(p, len(toks))[len(p):])
