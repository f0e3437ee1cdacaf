"""Port serving engine against the JAX reference on the CPU.

- Greedy ids of concurrent ``PagedLLMEngine.generate`` calls EQUAL the
  reference engine's, for int8 "none", "ffn" and "full", and every page
  comes back.
- ``admit_timeout`` sheds with a 504 while waiting for a slot or for pages.
- Sampling: the port's filtered distribution equals the reference's
  ``filtered_probs`` (atol 1e-6, float32), and draws from a seeded
  generator follow it (total-variation bound, as tests/test_llm.py holds
  the reference's own sampling).
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

JCFG = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=torch.float32)
_BASE = jtf.init_params(jax.random.PRNGKey(0), JCFG)


def _params(int8: str):
    p = _BASE
    if int8 in ("ffn", "full"):
        p = jtf.quantize_ffn_params(p)
    if int8 == "full":
        p = jtf.quantize_attn_params(p)
    return p, convert.params_from_jax(jax.tree.map(np.asarray, p))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 64, size=n).astype(
        np.int32)


def _engines(int8="none", n_pages=17, max_slots=6):
    jp, tp = _params(int8)
    jeng = jllm.PagedLLMEngine(jp, JCFG, jpaged.PagedConfig(n_pages, 4),
                               max_slots=max_slots, max_len=32)
    teng = tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(n_pages, 4),
                               max_slots=max_slots, max_len=32)
    return jeng, teng


REQS = [(_prompt(4, 0), 6), (_prompt(7, 2), 4), (_prompt(13, 3), 9),
        (_prompt(1, 4), 5)]


@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_concurrent_greedy_ids_equal_reference(int8):
    jeng, teng = _engines(int8)

    async def run(eng):
        return await asyncio.gather(*(eng.generate(p, n) for p, n in REQS))

    jouts = asyncio.run(run(jeng))
    touts = asyncio.run(run(teng))
    teng.close()
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert teng.free_pages == 16  # every page returned
    assert len(teng._free) == 6 and not teng._slots


def test_stream_and_stop_tokens_match_reference():
    jeng, teng = _engines("full")
    p = _prompt(5, 9)

    async def ref():
        return np.asarray(await jeng.generate(p, 8))

    full = asyncio.run(ref())[0, 5:]
    stop = int(full[3])

    async def run(eng):
        return [int(t) async for t in eng.stream(p, 8, stop_tokens=(stop,))]

    got = asyncio.run(run(teng))
    teng.close()
    assert got == [int(t) for t in full[: list(full).index(stop) + 1]]
    assert teng.free_pages == 16


async def test_admit_timeout_sheds_504_waiting_for_slot():
    _, teng = _engines("none", max_slots=1)
    first = asyncio.create_task(teng.generate(_prompt(4), 24))
    while teng._free:  # the first request holds the only slot
        await asyncio.sleep(0.001)
    with pytest.raises(tllm.AdmissionDeadlineError) as e:
        await teng.generate(_prompt(3), 4, admit_timeout=0.001)
    assert e.value.status_code == 504
    assert e.value.reason == "DEADLINE_EXCEEDED"
    out = await first
    assert out.shape == (1, 28)
    assert teng.preempt_stats["shed"] == 1
    assert teng.free_pages == 16 and teng._free == [0]
    teng.close()


async def test_admit_timeout_sheds_504_waiting_for_pages():
    # 5 usable pages of 4 rows: the first request (16 rows) holds 4 of
    # them, so a 2-page request must wait for pages, and sheds
    teng = tllm.PagedLLMEngine(_params("none")[1], TCFG,
                               tpaged.PagedConfig(6, 4), max_slots=2,
                               max_len=16)
    first = asyncio.create_task(teng.generate(_prompt(4), 12))
    while teng.free_pages > 1:
        await asyncio.sleep(0.001)
    with pytest.raises(tllm.AdmissionDeadlineError) as e:
        await teng.generate(_prompt(4), 4, admit_timeout=0.001)
    assert e.value.status_code == 504
    await first
    assert teng.free_pages == 5 and sorted(teng._free) == [0, 1]
    teng.close()


@pytest.mark.parametrize("temp,top_k,top_p", [(0.9, 0, 1.0), (1.3, 5, 1.0),
                                              (0.7, 0, 0.8), (1.0, 6, 0.7)])
def test_filtered_probs_equal_reference(temp, top_k, top_p):
    logits = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)
    logits[1, 4] = logits[1, 9]  # a tie: the stable sort keeps vocab order
    args = (np.full(3, temp, np.float32), np.full(3, top_k, np.int32),
            np.full(3, top_p, np.float32))
    ref = jllm.filtered_probs(jnp.asarray(logits),
                              *(jnp.asarray(a) for a in args))
    out = tllm.filtered_probs(torch.from_numpy(logits),
                              *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("temp,top_k,top_p", [(0.9, 0, 1.0), (1.0, 6, 0.7)])
def test_sampled_distribution_matches_reference(temp, top_k, top_p):
    """4000 draws from one seeded generator against the reference's exact
    filtered distribution: total variation < 0.06 (the sampling noise at
    this N over <= 16 outcomes is about 0.03)."""
    logits = np.random.default_rng(6).normal(size=(1, 16)).astype(np.float32)
    ref = np.asarray(jllm.filtered_probs(
        jnp.asarray(logits), jnp.full((1,), temp), jnp.full((1,), top_k),
        jnp.full((1,), top_p)))[0]
    n = 4000
    gen = torch.Generator().manual_seed(0)
    toks = tllm.sample_tokens(
        torch.from_numpy(np.repeat(logits, n, 0)), torch.full((n,), temp),
        torch.full((n,), top_k), torch.full((n,), top_p), [gen] * n)
    emp = np.bincount(toks.numpy(), minlength=16) / n
    assert np.all(emp[ref == 0] == 0)  # filtered tokens are never drawn
    tv = np.abs(emp - ref).sum() / 2
    assert tv < 0.06, f"TV distance {tv}"


def test_greedy_rows_take_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 1.0, 3.0, 0.0]])
    toks = tllm.sample_tokens(logits, torch.zeros(2), torch.zeros(2),
                              torch.ones(2), [None, None])
    ref = jllm.sample_tokens(jnp.asarray(logits.numpy()), jnp.zeros(2),
                             jnp.zeros(2, jnp.int32), jnp.ones(2),
                             jnp.zeros((2, 2), jnp.uint32))[0]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))


def test_seeded_sampling_is_reproducible_and_in_vocab():
    _, teng = _engines("full")

    async def run(seed):
        return await asyncio.gather(*(
            teng.generate(_prompt(5, s), 6, temperature=0.8, top_k=10,
                          seed=seed + s) for s in range(3)))

    a = asyncio.run(run(1))
    b = asyncio.run(run(1))
    teng.close()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        assert x.shape == (1, 11)
        assert ((x >= 0) & (x < 64)).all()


def test_later_slice_knobs_raise():
    _, tp = _params("none")
    paged = tpaged.PagedConfig(17, 4)
    for kw in ({"chunk_prefill": 8}, {"auto_prefix_tokens": 64},
               {"ring_prefill": 16}, {"batch_prefill_ms": 2.0}):
        with pytest.raises(NotImplementedError, match="slice 3"):
            tllm.PagedLLMEngine(tp, TCFG, paged, max_len=32, **kw)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tllm.LLMEngine(tp, TCFG, max_len=32)
