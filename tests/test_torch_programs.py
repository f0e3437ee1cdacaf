"""The port's device programs (``runtime/programs.py``) on the CPU.

On the card every piece of the LLM engines' device work is a program
replayed as one CUDA graph per shape; here the same programs stage their
host snapshot into static inputs and run the plain path.  Covered against
the JAX reference (its weights converted, 2 layers at d 64, JAX on the
CPU as the other tests run it):

- ``prefill`` with ``logit_pos`` a (B,) tensor, as the prefill program
  passes it, is bitwise equal to the integer path and within 1e-5 of the
  reference's logits (float32 on both sides; the port's existing
  tolerance), int8 none, ffn and full;
- ``_extend_job`` through its program (``last`` a device index) is
  bitwise equal to the extend written out by hand, and within 1e-5 of the
  reference's prefill logits at that position;
- a host mirror changed after a tick is submitted does not reach that
  tick's static inputs (a gated device worker), slab and paged;
- ``programs.eager()`` nests and restores; an engine on the CPU never
  captures, and its programs' counters say so;
- a program over its byte budget drops its least recently used keys
  (capture and replay stood in for on the CPU), and the engines give the
  budget to their programs of many keys;
- the paged engine's shared-prefix aliasing in forced orders of the
  prefix page write, the admissions and the first ticks (a gated worker):
  the ids EQUAL the reference's ``generate``.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seldon_core_tpu.models import transformer as jtf
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime import paged as tpaged
from seldon_core_tpu_torch.runtime import programs

_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **_KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **_KW)
_BASE = jtf.init_params(jax.random.PRNGKey(0), JCFG)
_CACHE: dict = {}
ATOL = 1e-5


def _params(int8: str = "none"):
    if int8 not in _CACHE:
        p = _BASE
        if int8 in ("ffn", "full"):
            p = jtf.quantize_ffn_params(p)
        if int8 == "full":
            p = jtf.quantize_attn_params(p)
        _CACHE[int8] = (p, convert.params_from_jax(
            jax.tree.map(np.asarray, p)))
    return _CACHE[int8]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 64, size=n).astype(
        np.int32)


def _bits_equal(a, b):
    return programs.bitwise_equal(a.contiguous(), b.contiguous())


# ---- prefill and extend through their programs -----------------------------

@pytest.mark.parametrize("int8", ["none", "ffn", "full"])
def test_prefill_tensor_logit_pos_is_the_int_path_and_the_reference(int8):
    jp, tp = _params(int8)
    ids = np.stack([_prompt(16, 1), _prompt(16, 2)])
    ids[1, 11:] = 0  # a right-padded row
    t_ids = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        by_int, c_int = ttf.prefill(tp, t_ids, TCFG, max_len=16, logit_pos=10)
        by_tensor, c_tensor = ttf.prefill(
            tp, t_ids, TCFG, max_len=16, logit_pos=torch.tensor([10, 10]))
        per_row, _ = ttf.prefill(tp, t_ids, TCFG, max_len=16,
                                 logit_pos=torch.tensor([15, 10]))
    assert _bits_equal(by_int, by_tensor)
    assert _bits_equal(c_int["k"], c_tensor["k"])
    jl, _ = jtf.prefill(jp, jnp.asarray(ids), JCFG, max_len=16)
    jl = np.asarray(jl)
    np.testing.assert_allclose(by_tensor.numpy(), jl[:, 10], atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(per_row.numpy(), jl[[0, 1], [15, 10]],
                               atol=ATOL, rtol=ATOL)


def _engine(kind="slab", int8="none", **kw):
    _, tp = _params(int8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 32)
    if kind == "slab":
        return tllm.LLMEngine(tp, TCFG, **kw)
    return tllm.PagedLLMEngine(tp, TCFG, tpaged.PagedConfig(33, 4), **kw)


@pytest.mark.parametrize("int8", ["none", "full"])
def test_extend_job_with_a_tensor_last_is_unchanged(int8):
    """The extend program (prefix padded inside it, ``done`` and ``last``
    device indices) against the extend written out as before: bitwise;
    and the logits within 1e-5 of the reference's prefill at that row."""
    jp, tp = _params(int8)
    eng = _engine(int8=int8)
    try:
        full = _prompt(21, 3)
        pre = np.zeros((1, 16), np.int64)
        pre[0, :13] = full[:13]
        suffix = np.zeros((1, 8), np.int64)
        suffix[0, :8] = full[13:21]
        logits0, small = eng._prefill_rows(pre, 12)
        got, grown = eng._extend_job(small, suffix, 13, 5)
        assert eng._programs["extend"]._static[(16, 8)] is not None
        with torch.no_grad():
            cache = {"k": F.pad(small["k"], (0, 0, 0, 0, 0, 8)),
                     "v": F.pad(small["v"], (0, 0, 0, 0, 0, 8)),
                     "pos": torch.full((1,), 13, dtype=torch.int32)}
            want, cache = ttf.decode_step(tp, cache, torch.from_numpy(suffix),
                                          TCFG)
        assert _bits_equal(got, want[:, 5])
        assert _bits_equal(grown["k"], cache["k"])
        jl, _ = jtf.prefill(jp, jnp.asarray(full[None]), JCFG, max_len=21)
        np.testing.assert_allclose(got.numpy()[0], np.asarray(jl)[0, 18],
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(logits0.numpy()[0], np.asarray(jl)[0, 12],
                                   atol=ATOL, rtol=ATOL)
    finally:
        eng.close()


# ---- staging ----------------------------------------------------------------

def _gate(eng):
    """Hold the engine's device worker until the returned event is set."""
    ev = threading.Event()
    eng._device_job(lambda: ev.wait(30), "test gate")
    return ev


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_a_mirror_changed_after_submission_misses_the_ticks_inputs(kind):
    eng = _engine(kind)

    async def run():
        eng._pos[1], eng._tokens[1] = 5, 7
        if kind == "paged":
            eng._tables[1, :2] = [3, 4]
        gate = _gate(eng)
        tick = asyncio.get_running_loop().create_task(eng._plain_tick())
        await asyncio.sleep(0)  # snapshot taken, job queued behind the gate
        eng._pos[1], eng._tokens[1] = 9, 11
        if kind == "paged":
            eng._tables[1, :2] = [5, 6]
        gate.set()
        await tick

    try:
        asyncio.run(run())
        static = eng._programs["tick"]._static[eng.max_slots]
        tokens, pos = static[0], static[1]
        assert (int(tokens[1]), int(pos[1])) == (7, 5)
        if kind == "paged":
            assert static[2][1, :2].tolist() == [3, 4]
        # and the next tick stages the mirrors as they are now
        eng._tick_device(eng._tick_state({}))
        assert (int(static[0][1]), int(static[1][1])) == (11, 9)
    finally:
        eng.close()


def test_program_stages_each_key_into_buffers_of_its_own():
    calls = []

    def fn(key, a, b):
        calls.append(key)
        return a * 2 + b.float()

    prog = programs.Program("p", fn, "cpu", lambda: None)
    x = np.arange(4, dtype=np.float32)
    y1 = prog(4, x, torch.ones(4, dtype=torch.int64))
    x[:] = 100  # the host array after the call: the staged copy stays
    a4 = prog._static[4][0]
    assert a4.tolist() == [0, 1, 2, 3] and y1.tolist() == [1, 3, 5, 7]
    prog(2, np.ones(2, np.float32), torch.zeros(2, dtype=torch.int64))
    assert prog._static[4][0] is a4  # key 4's buffers untouched
    assert prog._static[2][0].tolist() == [1, 1]
    y3 = prog(4, np.full(4, 3, np.float32), torch.zeros(4, dtype=torch.int64))
    assert prog._static[4][0] is a4 and y3.tolist() == [6] * 4
    assert calls == [4, 2, 4] and prog.eager_runs == 3
    assert prog.replays == 0 and prog.capture_s == {}


class _FakeGraph:
    """A captured graph's stand-in on the CPU: a replay runs the function
    again into the outputs of the capture."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        self.out.copy_(self.fn(*self.inputs))


def test_a_program_over_its_budget_drops_its_least_recently_used_keys(
        monkeypatch):
    """With a budget of two keys' buffers, a third key's capture drops the
    key used least recently (graph, static inputs and outputs), and that
    key captures again at its next call; answers stay right throughout."""
    captured = []

    def fake_capture(fn, inputs, pool, what, key_desc, select=None):
        captured.append(key_desc)
        out = fn(*inputs)
        return programs.Captured(_FakeGraph(fn, inputs, out), inputs, out,
                                 programs.launches.Recording())

    monkeypatch.setattr(programs, "graphs_on", lambda device: True)
    monkeypatch.setattr(programs, "capture", fake_capture)
    # a key of n float32 holds 8n bytes: its input and its output
    prog = programs.Program("p", lambda key, x: x * 2, "cpu", lambda: None,
                            retain_bytes=8 * (4 + 8))

    def call(n, v):
        out = prog(n, np.full(n, v, np.float32))
        assert out.tolist() == [2.0 * v] * n
        return out

    call(4, 1)
    call(8, 2)
    assert prog.retained_bytes() == 96 and prog.evicted == 0
    call(4, 3)       # a replay: key 4 is now the most recently used
    call(2, 4)       # over budget: key 8 goes, key 4 stays
    assert list(prog._graphs) == [4, 2] and set(prog._static) == {4, 2}
    assert prog.evicted == 1 and prog.retained_bytes() == 48
    call(8, 5)       # captures again; key 4 goes, then 80 bytes fit
    assert list(prog._graphs) == [2, 8] and prog.evicted == 2
    assert prog.retained_bytes() == 80
    call(16, 6)      # alone over the budget: kept, keys 2 and 8 go
    assert list(prog._graphs) == [16] and prog.retained_bytes() == 128
    assert captured == ["key 4", "key 8", "key 2", "key 8", "key 16"]
    assert prog.captures == 5 and prog.replays == 6 and prog.evicted == 4
    assert prog.eager_runs == 0


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_the_engines_many_key_programs_have_the_budget(kind):
    """Prefill, draft prefill and extend (a key per shape) keep at most
    ``GRAPH_RETAIN_BYTES`` captured; the tick (one key) and the
    speculative round (two) have no budget."""
    _, tp = _params()
    eng = _engine(kind, draft_params=tp, draft_cfg=TCFG, k_draft=2)
    builders = {
        "prefill": lambda: eng._prefill_program("prefill", eng.params,
                                                eng.cfg),
        "draft_prefill": lambda: eng._prefill_program(
            "draft_prefill", eng.draft_params, eng.draft_cfg),
        "extend": eng._extend_program,
        "tick": eng._tick_program,
        "spec": eng._spec_program,
    }
    try:
        budgets = {name: eng._program(name, build).retain_bytes
                   for name, build in builders.items()}
    finally:
        eng.close()
    budget = tllm.GRAPH_RETAIN_BYTES
    assert budgets == {"prefill": budget, "draft_prefill": budget,
                       "extend": budget, "tick": None, "spec": None}


# ---- eager mode and the CPU ------------------------------------------------

def test_eager_nests_and_restores():
    assert programs.graphs_on("cuda") and not programs.graphs_on("cpu")
    with programs.eager():
        assert not programs.graphs_on("cuda")
        with programs.eager():
            assert not programs.graphs_on("cuda")
        assert not programs.graphs_on("cuda")
        with pytest.raises(KeyError):
            with programs.eager():
                raise KeyError("x")
        assert not programs.graphs_on("cuda")
    assert programs.graphs_on("cuda")


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_an_engine_on_the_cpu_never_captures(kind, monkeypatch):
    def no_capture(*a, **k):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(programs, "capture", no_capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_capture)
    _, tp = _params()
    eng = _engine(kind, draft_params=tp, draft_cfg=TCFG, k_draft=2)
    pre = _prompt(9, 4)

    async def run():
        eng.register_prefix(pre)
        outs = await asyncio.gather(
            eng.generate(np.concatenate([pre, _prompt(3, 5)]), 4),
            eng.generate(_prompt(6, 6), 4, temperature=0.8, seed=3))
        return outs

    try:
        asyncio.run(run())
    finally:
        eng.close()
    stats = eng.program_stats()
    assert set(stats["programs"]) == {"prefill", "draft_prefill", "extend",
                                      "spec"}
    for name, st in stats["programs"].items():
        assert st["eager_runs"] > 0 and st["replays"] == 0, name
        assert st["capture_s"] == {}, name
    assert stats["pool_bytes"] == 0 and eng._graph_pool is None


def test_rebinding_the_weights_drops_the_programs():
    eng = _engine()
    try:
        eng._prefill_rows(np.ones((1, 8), np.int64), 3)
        first = eng._programs["prefill"]
        eng._prefill_rows(np.ones((1, 8), np.int64), 3)
        assert eng._programs["prefill"] is first
        eng.params = dict(eng.params)
        eng._prefill_rows(np.ones((1, 8), np.int64), 3)
        assert eng._programs["prefill"] is not first
    finally:
        eng.close()


# ---- shared-prefix aliasing in forced orders --------------------------------

def _ref_ids(p, n):
    jp, _ = _params()
    return np.asarray(jtf.generate(jp, jnp.asarray(p)[None], n, JCFG))[0]


_PRE = _prompt(16, 21)
_FA = np.concatenate([_PRE, _prompt(4, 22)])
_FB = np.concatenate([_PRE, _prompt(4, 23)])


async def _settle(n=20):
    for _ in range(n):
        await asyncio.sleep(0)


@pytest.mark.parametrize("order", [
    "prefix_write_behind_both_reservations",
    "ticks_in_flight_while_b_admits",
    "b_admits_between_a_insert_and_first_tick",
    "b_reserves_while_a_prefills",
])
def test_aliased_admissions_in_forced_orders_equal_the_reference(order):
    """The paged engine's device worker is held (a gate job) at one moment
    of two aliased admissions and released after the event loop has run
    everything it can: the prefix page write queued behind both
    reservations; a tick snapshotted before the second admission's alias
    mapping and insert (and run after them); the second admission's alias
    mapping between the first one's insert and its first tick; the second
    reservation made while the first admission's extend waits.  Every
    order gives the reference's greedy ids."""
    eng = tllm.PagedLLMEngine(_params()[1], TCFG, tpaged.PagedConfig(13, 4),
                              max_slots=4, max_len=32)

    async def run():
        a = b = None
        if order == "prefix_write_behind_both_reservations":
            gate = _gate(eng)
            eng.register_prefix(_PRE)
            a, b = eng.stream(_FA, 12), eng.stream(_FB, 12)
            fa = asyncio.ensure_future(a.__anext__())
            fb = asyncio.ensure_future(b.__anext__())
            await _settle()
            assert len(eng._reserved) == 2 and not eng._slots
            gate.set()
            first = [await fa, await fb]
        elif order == "ticks_in_flight_while_b_admits":
            eng.register_prefix(_PRE)
            a = eng.stream(_FA, 12)
            first = [await a.__anext__()]
            gate = _gate(eng)  # a's next tick queues behind this
            b = eng.stream(_FB, 12)
            fb = asyncio.ensure_future(b.__anext__())
            await _settle()
            assert list(eng._slots) != [] and len(eng._reserved) == 2
            gate.set()
            first.append(await fb)
        elif order == "b_admits_between_a_insert_and_first_tick":
            eng.register_prefix(_PRE)
            await eng._on_device(lambda: None)  # prefix written
            a, b = eng.stream(_FA, 12), eng.stream(_FB, 12)
            fa = asyncio.ensure_future(a.__anext__())
            fb = asyncio.ensure_future(b.__anext__())
            first = [await fa]
            gate = _gate(eng)
            await _settle()
            gate.set()
            first.append(await fb)
        else:
            gate = _gate(eng)
            eng.register_prefix(_PRE)
            a = eng.stream(_FA, 12)
            fa = asyncio.ensure_future(a.__anext__())
            await _settle()
            b = eng.stream(_FB, 12)
            fb = asyncio.ensure_future(b.__anext__())
            await _settle()
            gate.set()
            first = [await fa, await fb]
        assert eng.prefix_stats["alias_hits"] == 2
        ta = [first[0]] + [t async for t in a]
        tb = [first[1]] + [t async for t in b]
        return np.asarray(ta), np.asarray(tb)

    try:
        ga, gb = asyncio.run(run())
    finally:
        eng.close()
    np.testing.assert_array_equal(ga, _ref_ids(_FA, 12)[20:])
    np.testing.assert_array_equal(gb, _ref_ids(_FB, 12)[20:])
    assert eng.free_pages == 12 - 4  # the prefix's pinned pages stay
