"""The port's tensor-parallel engines (``runtime/llm.py`` ``LLMEngine`` and
``PagedLLMEngine`` with ``mesh=``), ring prefill, checkpoints and
``DemoLLM(tp=2)`` against the reference at tp = 2 on the CPU.

The reference serves on 2 of conftest's virtual devices, the port on a
2-rank mesh of the CPU device, both from the reference's params (through
``convert.py``).  Counterparts of ``tests/test_llm.py`` TestMeshEngine
(:1175-1300), the paged tp tests (:1726, :1747) and TestRingPrefill
(:1842-1900); ``tests/test_checkpoint.py`` :188 and :230; and the
``__graft_entry__.py`` serving dryruns ``_dryrun_engine_tp`` and
``_dryrun_paged_spec_tp`` (their bodies rebuilt here).

The greedy reference ids of every scenario come from ONE reference tp = 2
engine serving all of them at once (its ids are independent of what else
it serves: the reference's own exactness tests); ids are EQUAL.  Sampled
draws come from the port's own generators, which cannot replay the
reference's: a seeded port request is held to itself (two runs) and the
paged tp speculative engine to the slab single-device one."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as J
from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu.runtime import checkpoint as jckpt
from seldon_core_tpu.runtime import llm as JL
from seldon_core_tpu.runtime.paged import PagedConfig as JPaged
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import transformer as T
from seldon_core_tpu_torch.parallel.mesh import make_mesh
from seldon_core_tpu_torch.runtime import checkpoint as tckpt
from seldon_core_tpu_torch.runtime import llm as TL
from seldon_core_tpu_torch.runtime.paged import PagedConfig as TPaged

GQA = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=128)
DRAFT = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=4, n_kv_heads=2,
             d_ff=32, max_seq=128)
JCFG = J.TransformerConfig(**GQA, dtype=jnp.float32)
TCFG = T.TransformerConfig(**GQA, dtype=torch.float32)
JDRAFT = J.TransformerConfig(**DRAFT, dtype=jnp.float32)
TDRAFT = T.TransformerConfig(**DRAFT, dtype=torch.float32)
JP = J.init_params(jax.random.PRNGKey(0), JCFG)
JDP = J.init_params(jax.random.PRNGKey(9), JDRAFT)
JMESH = jmake_mesh(n_devices=2, tp=2, pp=1)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _mesh():
    return make_mesh(n_devices=2, tp=2, device="cpu")


def _placed(params=JP, cfg=TCFG, mesh=None):
    return params_from_jax(_host(params), mesh=mesh or _mesh(), cfg=cfg)


def prompt(n, seed=0):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (1, n), 0,
                                         64)).reshape(-1)


PRE, SUF = prompt(12, 11), prompt(5, 12)
RING_PRE, RING_SUF = prompt(40, 23), prompt(6, 24)
#: every greedy (prompt, n_new) the tests below serve
SCENARIOS = {
    "p4n6": (prompt(4), 6), "p4n8": (prompt(4), 8),
    "p3n6": (prompt(3, 2), 6), "p5n4": (prompt(5, 3), 4),
    "p9n2": (prompt(9, 4), 2), "p7n4": (prompt(7, 2), 4),
    "prefix": (np.concatenate([PRE, SUF]), 5),
    "ring48": (prompt(48, 21), 6), "short": (prompt(5, 22), 4),
    "ring_prefix": (np.concatenate([RING_PRE, RING_SUF]), 5),
    "ring48b": (prompt(48, 25), 6),
}


async def _serve(engine, reqs, **kw):
    return await asyncio.gather(*(engine.generate(p, n, **kw)
                                  for p, n in reqs))


@pytest.fixture(scope="module")
def ref_ids():
    """The reference tp = 2 engine's greedy ids of every scenario."""
    eng = JL.LLMEngine(J.shard_params(JP, JMESH, JCFG), JCFG,
                       max_slots=len(SCENARIOS), max_len=80, mesh=JMESH)
    outs = asyncio.run(_serve(eng, SCENARIOS.values()))
    return {name: np.asarray(o) for name, o in zip(SCENARIOS, outs)}


def _same(out, want):
    np.testing.assert_array_equal(out.numpy(), want)


def _run(engine, names, **kw):
    try:
        return asyncio.run(_serve(engine, [SCENARIOS[n] for n in names],
                                  **kw))
    finally:
        engine.close()


# ---- the slab engine (TestMeshEngine) --------------------------------------

class TestMeshEngine:
    def _engine(self, **kw):
        return TL.LLMEngine(_placed(), TCFG, max_slots=4, max_len=32,
                            mesh=_mesh(), **kw)

    def test_tp2_matches_the_reference_exactly(self, ref_ids):
        eng = self._engine()
        (out,) = _run(eng, ["p4n6"])
        _same(out, ref_ids["p4n6"])
        span = eng.tp_span()
        assert span["meshSlice"] == "tp=2" and span["cudaGraphs"]
        assert 0 < span["shardedParamBytes"] < span["paramBytes"]
        assert eng.program_stats()["graphs"]

    def test_tp2_concurrent_mixed_lengths(self, ref_ids):
        names = ["p3n6", "p5n4", "p9n2"]
        for name, out in zip(names, _run(self._engine(), names)):
            _same(out, ref_ids[name])

    def test_tp2_sampling_seed_deterministic(self):
        kw = dict(temperature=0.8, top_k=16, top_p=0.9, seed=7)
        a = _run(self._engine(), ["p4n8"], **kw)[0]
        b = _run(self._engine(), ["p4n8"], **kw)[0]
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_tp2_int8_ffn(self):
        """int8 FFN placed tensor-parallel (K1 per rank, psum of w2's
        partials) through the engine: the reference's single-chip int8
        ids, as its own test holds its tp engine (the tp = 2 int8 engine
        against the reference's is test_engine_tp_dryrun_as_the_reference)."""
        jq = J.quantize_ffn_params(J.shard_params(JP, JMESH, JCFG),
                                   mesh=JMESH)
        p, n = SCENARIOS["p4n6"]
        want = np.asarray(J.generate(J.quantize_ffn_params(JP),
                                     jnp.asarray(p)[None], n, JCFG))
        eng = TL.LLMEngine(_placed(jq), TCFG, max_slots=4, max_len=32,
                           mesh=_mesh())
        _same(_run(eng, ["p4n6"])[0], want)

    def test_tp2_prefix_cache_and_chunked_prefill(self, ref_ids):
        eng = self._engine(chunk_prefill=4)
        eng.register_prefix(PRE)
        _same(_run(eng, ["prefix"])[0], ref_ids["prefix"])

    def test_tp2_speculative(self, ref_ids):
        eng = TL.LLMEngine(_placed(), TCFG, max_slots=4, max_len=32,
                           mesh=_mesh(), draft_params=_placed(JDP, TDRAFT),
                           draft_cfg=TDRAFT, k_draft=3)
        _same(_run(eng, ["p4n8"])[0], ref_ids["p4n8"])
        assert eng.spec_stats["rounds"] >= 1


# ---- the paged engine ------------------------------------------------------

def _paged(spec=False, **kw):
    if spec:
        kw.update(draft_params=_placed(JDP, TDRAFT), draft_cfg=TDRAFT,
                  k_draft=3)
    kw.setdefault("max_slots", 6)
    kw.setdefault("max_len", 32)
    return TL.PagedLLMEngine(_placed(), TCFG, TPaged(n_pages=33, page_size=4),
                             mesh=_mesh(), **kw)


def test_paged_tp2_exact(ref_ids):
    eng = _paged()
    for name, out in zip(("p4n6", "p7n4"), _run(eng, ["p4n6", "p7n4"])):
        _same(out, ref_ids[name])
    assert eng.free_pages == 32
    assert len(eng._arrivals or []) in (0, 2)  # per rank on the card


def test_paged_tp2_speculative_all_three_compose(ref_ids):
    """The paged pool split over tp = 2, speculative rounds verifying
    against pages: the greedy request is the reference's, the sampled one
    equals the single-device slab speculative engine's, every page
    returns."""
    eng = _paged(spec=True)
    kw = dict(temperature=0.8, top_k=16, top_p=0.9, seed=5)
    p3 = prompt(3, 3)

    async def both():
        return await asyncio.gather(eng.generate(*SCENARIOS["p4n8"]),
                                    eng.generate(p3, 8, **kw))

    try:
        greedy, sampled = asyncio.run(both())
    finally:
        eng.close()
    _same(greedy, ref_ids["p4n8"])
    slab = TL.LLMEngine(params_from_jax(_host(JP)), TCFG, max_slots=4,
                        max_len=32, draft_params=params_from_jax(_host(JDP)),
                        draft_cfg=TDRAFT, k_draft=3)
    try:
        want = asyncio.run(slab.generate(p3, 8, **kw))
    finally:
        slab.close()
    np.testing.assert_array_equal(sampled.numpy(), want.numpy())
    assert eng.spec_stats["rounds"] >= 1
    assert eng.free_pages == 32


# ---- ring prefill (TestRingPrefill) ----------------------------------------

class TestRingPrefill:
    def _engine(self, **kw):
        kw.setdefault("max_slots", 2)
        kw.setdefault("max_len", 80)
        kw.setdefault("ring_prefill", 32)
        return TL.LLMEngine(_placed(), TCFG, mesh=_mesh(), **kw)

    def test_long_prompt_ring_prefill_exact(self, ref_ids):
        eng = self._engine()
        assert eng._ring_eligible(64)
        _same(_run(eng, ["ring48"])[0], ref_ids["ring48"])
        assert "ring_prefill" in eng.program_stats()["programs"]

    def test_short_prompt_stays_dense(self, ref_ids):
        eng = self._engine()
        assert not eng._ring_eligible(8)
        _same(_run(eng, ["short"])[0], ref_ids["short"])
        assert "ring_prefill" not in eng.program_stats()["programs"]

    def test_ring_composes_with_prefix_cache(self, ref_ids):
        eng = self._engine()
        eng.register_prefix(RING_PRE)
        _same(_run(eng, ["ring_prefix"])[0], ref_ids["ring_prefix"])

    def test_all_four_compose_paged_tp_spec_ring(self, ref_ids):
        eng = TL.PagedLLMEngine(
            _placed(), TCFG, TPaged(n_pages=33, page_size=4), max_slots=2,
            max_len=64, mesh=_mesh(), ring_prefill=32,
            draft_params=_placed(JDP, TDRAFT), draft_cfg=TDRAFT, k_draft=3)
        assert eng._ring_eligible(64)
        _same(_run(eng, ["ring48b"])[0], ref_ids["ring48b"])
        assert eng.free_pages == 32
        assert "ring_draft_prefill" in eng.program_stats()["programs"]


# ---- the reference's serving dryruns ---------------------------------------

DRY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128)


def _dry_prompt(L, seed):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (1, L), 0,
                                         128))


def test_engine_tp_dryrun_as_the_reference():
    """``_dryrun_engine_tp``: an int8-FFN tp = 2 engine serving two
    concurrent requests; the port's ids equal the reference's tp engine's
    and its own single-device engine's."""
    jc = J.TransformerConfig(**DRY, max_seq=64, dtype=jnp.float32)
    tc = T.TransformerConfig(**DRY, max_seq=64, dtype=torch.float32)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    jq = J.quantize_ffn_params(J.shard_params(params, JMESH, jc), mesh=JMESH)
    reqs = [(_dry_prompt(4, 1), 6), (_dry_prompt(9, 2), 4)]
    ref = asyncio.run(_serve(JL.LLMEngine(jq, jc, max_slots=4, max_len=32,
                                          mesh=JMESH), reqs))
    eng_tp = TL.LLMEngine(params_from_jax(_host(jq), mesh=_mesh(), cfg=tc),
                          tc, max_slots=4, max_len=32, mesh=_mesh())
    eng_1 = TL.LLMEngine(T.quantize_ffn_params(params_from_jax(
        _host(params))), tc, max_slots=4, max_len=32)
    try:
        outs = asyncio.run(_serve(eng_tp, reqs))
        ones = asyncio.run(_serve(eng_1, reqs))
    finally:
        eng_tp.close()
        eng_1.close()
    for out, one, r in zip(outs, ones, ref):
        np.testing.assert_array_equal(out.numpy(), np.asarray(r))
        np.testing.assert_array_equal(out.numpy(), one.numpy())


def test_paged_spec_tp_dryrun_as_the_reference():
    """``_dryrun_paged_spec_tp``: paged KV over tp = 2, speculation (k=3)
    and ring prefill of a 48-token prompt in one engine; the ids equal the
    reference engine's, and every page returns."""
    jc = J.TransformerConfig(**DRY, max_seq=128, dtype=jnp.float32)
    tc = T.TransformerConfig(**DRY, max_seq=128, dtype=torch.float32)
    dkw = dict(DRY, d_model=32, n_layers=1, d_ff=64, max_seq=128)
    jd = J.TransformerConfig(**dkw, dtype=jnp.float32)
    td = T.TransformerConfig(**dkw, dtype=torch.float32)
    params = J.init_params(jax.random.PRNGKey(0), jc)
    dparams = J.init_params(jax.random.PRNGKey(9), jd)
    kw = dict(max_slots=4, max_len=60, k_draft=3, ring_prefill=32)
    reqs = [(_dry_prompt(4, 1), 6), (_dry_prompt(48, 2), 4)]
    jeng = JL.PagedLLMEngine(J.shard_params(params, JMESH, jc), jc,
                             JPaged(n_pages=33, page_size=4), mesh=JMESH,
                             draft_params=J.shard_params(dparams, JMESH, jd),
                             draft_cfg=jd, **kw)
    ref = asyncio.run(_serve(jeng, reqs))
    teng = TL.PagedLLMEngine(
        params_from_jax(_host(params), mesh=_mesh(), cfg=tc), tc,
        TPaged(n_pages=33, page_size=4), mesh=_mesh(),
        draft_params=params_from_jax(_host(dparams), mesh=_mesh(), cfg=td),
        draft_cfg=td, **kw)
    assert teng._ring_eligible(64)
    try:
        outs = asyncio.run(_serve(teng, reqs))
    finally:
        teng.close()
    for out, r in zip(outs, ref):
        np.testing.assert_array_equal(out.numpy(), np.asarray(r))
    assert teng.free_pages == jeng.free_pages == 32
    assert teng.spec_stats["rounds"] >= 1


# ---- checkpoints -----------------------------------------------------------

def test_quantized_tree_cannot_be_resharded(tmp_path):
    jckpt.save_transformer(str(tmp_path / "j"), J.quantize_ffn_params(JP),
                           JCFG)
    tckpt.save_transformer(str(tmp_path / "t"), T.quantize_ffn_params(
        params_from_jax(_host(JP))), TCFG)
    with pytest.raises(ValueError, match="already-quantized"):
        jckpt.load_transformer(str(tmp_path / "j"), mesh=JMESH)
    for path in ("j", "t"):
        with pytest.raises(ValueError, match="already-quantized"):
            tckpt.load_transformer(str(tmp_path / path), mesh=_mesh())
    # a canonical tree re-targets tp, but not with int8 attention
    jckpt.save_transformer(str(tmp_path / "c"), JP, JCFG)
    with pytest.raises(ValueError, match="int8='full'") as je:
        jckpt.load_transformer(str(tmp_path / "c"), int8="full", mesh=JMESH)
    with pytest.raises(ValueError, match="int8='full'") as te:
        tckpt.load_transformer(str(tmp_path / "c"), int8="full",
                               mesh=_mesh())
    assert str(te.value) == str(je.value)


def test_tp_sharded_restore_matches(tmp_path, ref_ids):
    """A reference checkpoint restored tensor-parallel (placed at load):
    the restored tp engine serves the seeded tp engine's ids, which are
    the reference's."""
    jckpt.save_transformer(str(tmp_path / "ck"), JP, JCFG)
    restored = TL.LLMEngine.from_checkpoint(str(tmp_path / "ck"),
                                            mesh=_mesh(), max_slots=2,
                                            max_len=32)
    assert restored.mesh is not None
    assert restored.tp_span()["meshSlice"] == "tp=2"
    # a tp engine exports its global weights: a single-device restore of
    # them serves the same ids
    restored.save_checkpoint(str(tmp_path / "tp"))
    one = TL.LLMEngine.from_checkpoint(str(tmp_path / "tp"), device="cpu",
                                       max_slots=2, max_len=32)
    _same(_run(restored, ["p4n6"])[0], ref_ids["p4n6"])
    _same(_run(one, ["p4n6"])[0], ref_ids["p4n6"])
    q = TL.PagedLLMEngine.from_checkpoint(
        str(tmp_path / "ck"), mesh=_mesh(), int8="ffn",
        paged=TPaged(n_pages=17, page_size=4), max_slots=2, max_len=32)
    (out,) = _run(q, ["p4n6"])
    mesh = _mesh()
    seeded = TL.LLMEngine(T.quantize_ffn_params(_placed(mesh=mesh),
                                                mesh=mesh), TCFG,
                          max_slots=2, max_len=32, mesh=mesh)
    np.testing.assert_array_equal(out.numpy(),
                                  _run(seeded, ["p4n6"])[0].numpy())


# ---- DemoLLM(tp=2) ---------------------------------------------------------

DEMO = dict(d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
            max_seq=64, seed=3)


def test_demo_llm_tp2_int8_ffn_serves_through_the_local_runner():
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.serving.client import HttpSession

    params = [{"name": "model_class", "type": "STRING",
               "value": "seldon_core_tpu_torch.models.llm_demo:DemoLLM"},
              {"name": "tp", "value": "2", "type": "INT"},
              {"name": "int8", "value": "ffn", "type": "STRING"},
              {"name": "paged_pages", "value": "33", "type": "INT"},
              {"name": "page_size", "value": "4", "type": "INT"},
              {"name": "n_new", "value": "6", "type": "INT"}]
    params += [{"name": k, "value": str(v), "type": "INT"}
               for k, v in DEMO.items()]
    graph = {"spec": {"name": "llm-tp", "annotations": {
        "seldon.io/batching": "false"}, "predictors": [{
            "name": "main", "graph": {"name": "llm", "type": "MODEL",
                                      "parameters": params}}]}}
    ids = [int(t) for t in prompt(7, 5)]

    async def go():
        server, local = await serve(graph, port=0, host="127.0.0.1",
                                    device="cpu")
        http = HttpSession()
        try:
            st, _, body = await http.request(
                "POST", f"http://127.0.0.1:{server.port}/api/v0.1/predictions",
                ('{"jsonData": {"prompt_ids": %s}}' % ids).encode(),
                {"Content-Type": "application/json"})
            return st, body
        finally:
            await http.close()
            await server.stop()
            await local.aclose()

    import json

    st, body = asyncio.run(asyncio.wait_for(go(), 120))
    assert st == 200, body
    got = json.loads(body)["jsonData"]["ids"]
    # the same seeded model, in process: its tp = 2 engine's own decode
    demo = DemoLLM(tp=2, int8="ffn", device="cpu", **DEMO)
    eng = demo.engine
    try:
        assert eng.mesh.shape["tp"] == 2 and eng.tp_span() is not None
        want = T.generate(eng.params, torch.tensor([ids]), 6, eng.cfg,
                          mesh=eng.mesh)
    finally:
        eng.close()
    assert got == want[0].tolist()


def test_demo_llm_int8_full_with_tp_refused_as_the_reference():
    from seldon_core_tpu.models.llm_demo import DemoLLM as JDemo
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM

    with pytest.raises(ValueError) as je:
        JDemo(tp=2, int8="full", **DEMO)
    with pytest.raises(ValueError) as te:
        DemoLLM(tp=2, int8="full", device="cpu", **DEMO)
    assert str(te.value) == str(je.value)
