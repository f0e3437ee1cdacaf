"""The port's prediction cache (``seldon_core_tpu_torch/caching``) and the
engine's walk and segment caching against the JAX package's.

The same request sequences as ``tests/test_prediction_cache.py``'s key,
store, single-flight, walk, fused, batcher and QoS classes go through the
reference and the port; the port must give the SAME counters (hits,
misses, evictions, coalesced, entries, bytes), the same model-call counts,
and ``message_key`` / ``array_key`` / ``raw_key`` digests EQUAL to the
reference's for the same payload (numpy or torch).  Within the port a hit
or a coalesced answer is byte-identical to a cache-free engine's.
"""

import asyncio
import json
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu import caching as jc
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.compile import (
    prediction_cache_config as j_cache_config,
)
from seldon_core_tpu.operator.local import LocalDeployment as JLocal
from seldon_core_tpu.operator.local import resolve_component as jresolve
from seldon_core_tpu.operator.spec import (
    DeploymentValidationError as JDeploymentValidationError,
)
from seldon_core_tpu.operator.spec import SeldonDeployment
from seldon_core_tpu.qos import EngineQos as JEngineQos
from seldon_core_tpu.qos import QosConfig as JQosConfig
from seldon_core_tpu.runtime.batcher import BatcherConfig as JBatcherConfig
from seldon_core_tpu.runtime.batcher import DynamicBatcher as JDynamicBatcher
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import caching as tc
from seldon_core_tpu_torch.graph import spec as tspec
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import LocalDeployment as TLocal
from seldon_core_tpu_torch.operator.local import resolve_component as tresolve
from seldon_core_tpu_torch.qos.policy import EngineQos as TEngineQos
from seldon_core_tpu_torch.qos.policy import QosConfig as TQosConfig
from seldon_core_tpu_torch.runtime.batcher import BatcherConfig as TBatcherConfig
from seldon_core_tpu_torch.runtime.batcher import DynamicBatcher as TDynamicBatcher
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

ROOT = Path(__file__).resolve().parents[1]
PORT_GRAPHS = ROOT / "seldon_core_tpu_torch" / "examples"
NO_BATCH = {"seldon.io/batching": "false"}


def run(coro):
    return asyncio.run(coro)


def mlp_node(name, seed=0, hidden=32, pkg="seldon_core_tpu"):
    return {"name": name, "type": "MODEL", "parameters": [
        {"name": "model_class", "value": f"{pkg}.models.mlp:MNISTMLP",
         "type": "STRING"},
        {"name": "seed", "value": str(seed), "type": "INT"},
        {"name": "hidden", "value": str(hidden), "type": "INT"}]}


def _to_port(tree):
    return json.loads(json.dumps(tree).replace('"seldon_core_tpu.',
                                               '"seldon_core_tpu_torch.'))


def pinned(cls, x, names=()):
    msg = cls.from_ndarray(np.asarray(x), names)
    msg.meta.puid = "cache-pinned"
    return msg


def count_calls_ref(eng) -> list:
    """The reference test's hook: every node's compiled callable counted."""
    counter = [0]
    for node in eng._nodes.values():
        handle = getattr(node.impl, "handle", node.impl)
        fn = getattr(handle, "_compiled", None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, **kw):
            counter[0] += 1
            return _fn(*a, **kw)

        handle._compiled = counted
    return counter


def count_calls_port(eng) -> list:
    """The same hook on the port: every handle's pure function counted."""
    counter = [0]
    for node in eng._nodes.values():
        handle = getattr(node.impl, "handle", node.impl)
        fn = getattr(handle, "_fn", None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, **kw):
            counter[0] += 1
            return _fn(*a, **kw)

        handle._fn = counted
    return counter


def cached_engines(spec, max_bytes=1 << 20, ttl_s=0.0, ann=NO_BATCH, **kw):
    jcache = jc.PredictionCache(jc.CacheConfig(name="t", max_bytes=max_bytes,
                                               ttl_s=ttl_s))
    tcache = tc.PredictionCache(tc.CacheConfig(name="t", max_bytes=max_bytes,
                                               ttl_s=ttl_s))
    jeng = JEngine(spec, resolver=lambda u: jresolve(u, ann), name="p",
                   cache=jcache, **kw)
    teng = TEngine(_to_port(spec),
                   resolver=lambda u: tresolve(u, ann, "cpu"),
                   name="p", cache=tcache, **kw)
    return (jeng, jcache), (teng, tcache)


# ---- keys -----------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(2, 3)).astype(np.float32)
    return {
        "float32_2d": (f32, f32),
        "float32_flat": (f32.ravel(), f32.ravel()),
        "float32_torch": (f32, torch.from_numpy(f32)),
        "float64": (f32.astype(np.float64), f32.astype(np.float64)),
        "int32_zeros": (np.zeros(4, np.int32), np.zeros(4, np.int32)),
        "int64_torch": (np.arange(6).reshape(2, 3),
                        torch.arange(6).reshape(2, 3)),
        "bool": (f32 > 0, torch.from_numpy(f32 > 0)),
        "bfloat16": (np.asarray(jnp.asarray(f32, jnp.bfloat16)),
                     torch.from_numpy(f32).to(torch.bfloat16)),
        "scalar": (np.float32(3.5), np.float32(3.5)),
    }


@pytest.mark.parametrize("name", list(_payloads()))
@pytest.mark.parametrize("names", [(), ("a", "b", "c")])
def test_array_and_message_keys_equal_the_reference(name, names):
    jx, tx = _payloads()[name]
    for node, graph, version in (("", "", ""), ("n", "g", "v1"),
                                 ("seg+a", "p", "hash")):
        assert tc.array_key(tx, names, node=node, graph=graph,
                            version=version) == jc.array_key(
            jx, names, node=node, graph=graph, version=version)
        jm = JMessage(data=jx, names=list(names))
        tm = TMessage(data=tx, names=list(names))
        tm.meta.puid, tm.meta.tags["t"] = "other", 1  # meta is excluded
        assert tc.message_key(tm, node=node, graph=graph,
                              version=version) == jc.message_key(
            jm, node=node, graph=graph, version=version) is not None


@pytest.mark.parametrize("kw", [
    {"json_data": {"b": 1, "a": [2.5, "x"]}}, {"str_data": "hello"},
    {"bin_data": b"\x00\x01raw"}, {}, {"json_data": {"x": object()}}],
    ids=["json", "str", "bin", "empty", "unserializable-json"])
def test_non_tensor_message_keys_equal_the_reference(kw):
    assert tc.message_key(TMessage(**kw), node="n") == \
        jc.message_key(JMessage(**kw), node="n")


def test_key_partitions_like_the_reference():
    m = pinned(TMessage, np.ones((1, 2), np.float32))
    base = tc.message_key(m, node="n", graph="g", version="v1")
    assert base == tc.message_key(m, node="n", graph="g", version="v1")
    assert base != tc.message_key(m, node="n2", graph="g", version="v1")
    assert base != tc.message_key(m, node="n", graph="g2", version="v1")
    assert base != tc.message_key(m, node="n", graph="g", version="v2")
    assert tc.message_key(pinned(TMessage, np.zeros(4, np.float32))) != \
        tc.message_key(pinned(TMessage, np.zeros(4, np.int32)))
    assert tc.message_key(TMessage(data=np.array([object()], dtype=object))) \
        is None
    assert tc.raw_key("dep", "/p", b"body") == jc.raw_key("dep", "/p",
                                                          b"body")
    assert tc.raw_key("dep", "/p", b"body") != tc.raw_key("dep", "/p",
                                                          b"body2")


# ---- store, single-flight ---------------------------------------------------

def _store_script(pkg, sleep):
    """The reference TestStore's sequences on one package's store; returns
    everything they observe."""
    seen = []
    c = pkg.PredictionCache(pkg.CacheConfig(max_bytes=100))
    c.put("a", 1, 60)
    c.put("b", 2, 30)
    seen += [c.get("a"), c.put("c", 3, 60), c.get("b"), c.get("c"), c.stats]
    c = pkg.PredictionCache(pkg.CacheConfig(max_bytes=10))
    seen += [c.put("k", 1, 11), c.get("k"), c.stats]
    c = pkg.PredictionCache(pkg.CacheConfig(ttl_s=0.03))
    c.put("k", 1, 1)
    seen.append(c.get("k"))
    sleep(0.05)
    seen += [c.get("k"), c.stats, len(c)]
    c.clear()
    seen.append(c.stats)
    return seen


def test_store_sequences_equal_the_reference():
    assert _store_script(tc, time.sleep) == _store_script(jc, time.sleep)


def test_store_metrics_render_like_the_reference():
    out = []
    for pkg, reg in ((jc, JRegistry()), (tc, TRegistry())):
        c = pkg.PredictionCache(pkg.CacheConfig(name="t"), metrics=reg)
        c.put("k", 1, 5)
        c.get("k")
        c.get("nope")
        c.note_coalesced(3)
        text = reg.render()
        out.append([ln for ln in text.splitlines()
                    if ln.startswith(("seldon_cache", "seldon_coalesced"))])
    assert out[1] == out[0]
    assert 'seldon_cache_hits_total{cache="t"} 1' in "\n".join(out[1])


@pytest.mark.parametrize("ann", [
    {}, {"seldon.io/prediction-cache": "true"},
    {"seldon.io/prediction-cache": " YES ",
     "seldon.io/prediction-cache-bytes": "1024",
     "seldon.io/prediction-cache-ttl-ms": "250"},
    {"seldon.io/prediction-cache": "maybe"},
    {"seldon.io/prediction-cache": "true",
     "seldon.io/prediction-cache-bytes": "-1"},
    {"seldon.io/prediction-cache": "true",
     "seldon.io/prediction-cache-bytes": "lots"},
    {"seldon.io/prediction-cache": "true",
     "seldon.io/prediction-cache-ttl-ms": "soon"},
    {"seldon.io/prediction-cache": "true",
     "seldon.io/prediction-cache-ttl-ms": "-5"},
], ids=["off", "on", "sized", "bad-flag", "bad-bytes", "nan-bytes",
        "bad-ttl", "negative-ttl"])
def test_config_from_annotations_and_load_like_the_reference(ann):
    """The same configs, and the same message where the reference's
    admission rejects; the port's loader raises it (it accepted anything
    before)."""
    dep = {"metadata": {"name": "d"}, "spec": {"annotations": ann,
           "predictors": [{"name": "main", "graph": {
               "name": "m", "implementation": "SIMPLE_MODEL"}}]}}
    jdep = SeldonDeployment.from_dict(dep)
    try:
        want = j_cache_config(jdep, jdep.predictors[0])
    except JDeploymentValidationError as e:
        with pytest.raises(tspec.DeploymentValidationError) as te:
            tspec.load_deployment(dep)
        assert str(te.value) == str(e)
        with pytest.raises(ValueError) as tv:
            tc.config_from_annotations(ann, "d/main")
        assert str(tv.value) == str(e)
        return
    got = tspec.prediction_cache_config(
        tspec.load_deployment(dep).annotations, "d/main")
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.name, got.max_bytes, got.ttl_s) == (
            want.name, want.max_bytes, want.ttl_s)


@pytest.mark.parametrize("pkg", [jc, tc], ids=["reference", "port"])
def test_single_flight_coalesces_and_clears_on_error(pkg):
    sf = pkg.SingleFlight()
    calls = [0]

    async def compute():
        calls[0] += 1
        await asyncio.sleep(0.02)
        return "v"

    async def boom():
        await asyncio.sleep(0.01)
        raise RuntimeError("nope")

    async def drive():
        ok = await asyncio.gather(*(sf.run("k", compute) for _ in range(8)))
        bad = await asyncio.gather(*(sf.run("k", boom) for _ in range(3)),
                                   return_exceptions=True)
        return ok, bad

    ok, bad = run(drive())
    assert calls[0] == 1
    assert sum(c for _, c in ok) == 7 and all(v == "v" for v, _ in ok)
    assert all(isinstance(o, RuntimeError) for o in bad)
    assert sf.leader_count() == 0


# ---- the engine, walk mode ----------------------------------------------------

def test_walk_hit_skips_the_model_and_is_byte_identical():
    spec = mlp_node("m")
    (jeng, jcache), (teng, tcache) = cached_engines(spec)
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    x = np.random.default_rng(0).normal(size=(1, 784)).astype(np.float32)
    _walk_script(jeng, teng, [x, x])
    assert tcalls[0] == jcalls[0] == 1  # the second never reached the model
    assert tcache.stats == jcache.stats and tcache.stats["hits"] == 1
    cold = TEngine(_to_port(spec), resolver=lambda u: teng.node_impl(u.name),
                   name="p")
    ref = run(cold.predict(pinned(TMessage, x)))
    hit = run(teng.predict(pinned(TMessage, x)))
    assert hit.to_dict() == ref.to_dict()


class _JTagged:
    class_names = ["a", "b"]

    def predict_fn(self, X):
        return jnp.asarray(X) * 2.0

    def tags(self):
        return {"version": "v7"}

    def metrics(self):
        return [{"key": "hits", "type": "COUNTER", "value": 1}]


class _TTagged(_JTagged):
    def predict_fn(self, X):
        return X * 2.0


_JTagged.__name__ = _TTagged.__name__ = "Tagged"


def test_walk_hit_replays_tags_and_custom_metrics():
    jeng = JEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: JHandle(_JTagged(), name="m"),
                   cache=jc.PredictionCache(jc.CacheConfig()))
    teng = TEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: THandle(_TTagged(), name="m"),
                   cache=tc.PredictionCache(tc.CacheConfig()))
    cold = TEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: THandle(_TTagged(), name="m"))
    x = np.ones((1, 2), np.float32)
    ref = run(cold.predict(pinned(TMessage, x)))
    outs = []
    for eng, cls in ((jeng, JMessage), (teng, TMessage)):
        run(eng.predict(pinned(cls, x)))
        outs.append(run(eng.predict(pinned(cls, x))))
    jhit, thit = outs
    assert thit.to_dict() == ref.to_dict() == jhit.to_dict()
    assert thit.meta.tags == {"version": "v7"}
    assert [m.key for m in thit.meta.metrics] == ["hits"]
    assert teng.cache.stats == jeng.cache.stats


def _walk_script(jeng, teng, xs):
    """Each payload through both engines in turn."""
    for x in xs:
        run(jeng.predict(pinned(JMessage, x)))
        run(teng.predict(pinned(TMessage, x)))


def test_walk_distinct_payloads_distinct_entries():
    (jeng, jcache), (teng, tcache) = cached_engines(mlp_node("m"))
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    _walk_script(jeng, teng, [np.zeros((1, 784), np.float32),
                              np.ones((1, 784), np.float32)])
    assert tcalls[0] == jcalls[0] == 2
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 2


def test_walk_ttl_expiry_reinvokes_the_model():
    (jeng, _), (teng, tcache) = cached_engines(mlp_node("m"), ttl_s=0.03)
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    x = np.zeros((1, 784), np.float32)
    seen = []
    # each engine's requests back to back: the TTL is 30 ms
    for eng, cls, calls in ((jeng, JMessage, jcalls),
                            (teng, TMessage, tcalls)):
        run(eng.predict(pinned(cls, x)))
        run(eng.predict(pinned(cls, x)))
        seen.append(calls[0])
        time.sleep(0.05)
        run(eng.predict(pinned(cls, x)))
        seen.append(calls[0])
    assert seen == [1, 2, 1, 2]
    assert tcache.stats == jeng.cache.stats


def test_walk_eviction_under_a_byte_budget_reinvokes():
    a = np.zeros((1, 784), np.float32)
    b = np.ones((1, 784), np.float32)
    (jprobe, jpc), (tprobe, tpc) = cached_engines(mlp_node("m"))
    _walk_script(jprobe, tprobe, [a])
    assert tpc.stats["bytes"] == jpc.stats["bytes"] > 0  # one entry's charge
    budget = int(jpc.stats["bytes"] * 1.5)
    (jeng, jcache), (teng, tcache) = cached_engines(mlp_node("m"),
                                                    max_bytes=budget)
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    _walk_script(jeng, teng, [a, b, a])
    assert tcalls[0] == jcalls[0] == 3
    assert tcache.stats == jcache.stats and tcache.stats["evictions"] >= 1


def test_walk_rng_router_bypasses_but_branches_cache():
    """A RANDOM_ABTEST (seeded alike in both) re-runs per request; each
    branch's model computes once."""
    spec = {"name": "ab", "implementation": "RANDOM_ABTEST",
            "parameters": [{"name": "seed", "value": "4", "type": "INT"}],
            "children": [mlp_node("a", seed=0), mlp_node("b", seed=1)]}
    (jeng, jcache), (teng, tcache) = cached_engines(spec)
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    x = np.zeros((1, 784), np.float32)
    jr, tr = [], []
    for _ in range(40):
        jr.append(run(jeng.predict(pinned(JMessage, x))).meta.routing["ab"])
        tr.append(run(teng.predict(pinned(TMessage, x))).meta.routing["ab"])
    assert tr == jr and set(tr) == {0, 1}
    assert tcalls[0] == jcalls[0] == 2
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 2


def _example(name: str, ann: dict, port: bool) -> dict:
    d = json.loads((PORT_GRAPHS / f"{name}.json").read_text())
    d["spec"]["annotations"].update(ann)
    for p in d["spec"]["predictors"]:
        if p["graph"].get("implementation") in ("EPSILON_GREEDY",
                                                "RANDOM_ABTEST"):
            p["graph"].setdefault("parameters", []).append(
                {"name": "seed", "value": "0", "type": "INT"})
    if not port:
        d = json.loads(json.dumps(d).replace('"seldon_core_tpu_torch.',
                                             '"seldon_core_tpu.'))
    return d


def test_walk_stateful_outlier_never_cached():
    ann = {"seldon.io/prediction-cache": "true"}
    jlocal = JLocal(SeldonDeployment.from_dict(
        _example("iris-with-outlier", ann, port=False)), seed=0)
    tlocal = TLocal(tspec.load_deployment(
        _example("iris-with-outlier", ann, port=True)), device="cpu", seed=0)
    x = np.array([[5.1, 3.5, 1.4, 0.2]], np.float32)
    for eng, cls in ((jlocal.predictors[0].engine, JMessage),
                     (tlocal.engine, TMessage)):
        a = run(eng.predict(pinned(cls, x)))
        b = run(eng.predict(pinned(cls, x)))
        assert (a.meta.tags["observed"], b.meta.tags["observed"]) == (1, 2)
    assert tlocal.engine.cache.stats == jlocal.predictors[0].engine.cache.stats
    assert tlocal.engine.cache.stats["hits"] == 1


def test_unkeyable_payloads_take_the_cold_path_and_are_counted():
    (jeng, jcache), (teng, tcache) = cached_engines(mlp_node("m"))
    body = {"jsonData": {"rows": [[0.0] * 784]}}
    j = run(jeng.predict(JMessage.from_dict(body)))
    t = run(teng.predict(TMessage.from_dict(body)))
    assert (t.status.status, t.status.code) == (j.status.status,
                                                j.status.code)
    # an object array reaches the cache root but cannot be keyed
    obj = TMessage(data=np.array([[object()]], dtype=object))
    run(teng.predict(obj))
    run(jeng.predict(JMessage(data=np.array([[object()]], dtype=object))))
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 0
    assert tcache.bypassed == 1


# ---- cache and batcher -----------------------------------------------------------

BATCHED = {"seldon.io/batching": "true", "seldon.io/batch-max-size": "8",
           "seldon.io/batch-max-delay-ms": "5.0",
           "seldon.io/batch-max-queue-rows": "0"}


def _batched_engines():
    (jeng, jcache), (teng, tcache) = cached_engines(mlp_node("m"),
                                                    ann=BATCHED)
    rows = {"j": [], "t": []}
    for eng, k in ((jeng, "j"), (teng, "t")):
        batcher = next(iter(eng._nodes.values())).impl._batcher
        orig = batcher._run_batch

        def counted(items, nrows, _orig=orig, _k=k):
            rows[_k].append(nrows)
            return _orig(items, nrows)

        batcher._run_batch = counted
    return (jeng, jcache), (teng, tcache), rows


def test_n_identical_requests_one_call_one_batch_row():
    (jeng, jcache), (teng, tcache), rows = _batched_engines()
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    x = np.zeros((1, 784), np.float32)

    async def storm(eng, cls):
        return await asyncio.gather(*(eng.predict(pinned(cls, x))
                                      for _ in range(16)))

    run(storm(jeng, JMessage))
    outs = run(storm(teng, TMessage))
    assert tcalls[0] == jcalls[0] == 1
    assert rows["t"] == rows["j"] == [1]
    assert tcache.stats == jcache.stats and tcache.stats["coalesced"] == 15
    ref = outs[0].to_dict()
    assert all(o.to_dict() == ref for o in outs)


def test_distinct_payloads_still_batch_together():
    (jeng, jcache), (teng, tcache), rows = _batched_engines()
    xs = [np.full((1, 784), float(i), np.float32) for i in range(4)]

    async def storm(eng, cls):
        return await asyncio.gather(*(eng.predict(pinned(cls, x))
                                      for x in xs))

    run(storm(jeng, JMessage))
    run(storm(teng, TMessage))
    assert sum(rows["t"]) == 4 and len(rows["t"]) < 4
    assert rows["t"] == rows["j"]
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 4


# ---- the engine, fused plan mode -------------------------------------------

def test_segment_hit_skips_the_whole_call():
    spec = {"name": "ens", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [mlp_node(f"m{i}", seed=i) for i in range(3)]}
    (jeng, jcache), (teng, tcache) = cached_engines(spec, plan_mode="fused")
    cold = TEngine(_to_port(spec), resolver=lambda u: teng.node_impl(u.name),
                   name="p")
    jseg, tseg = jeng.plan.segments[0], teng.plan.segments[0]
    assert tseg.cacheable and jseg.cacheable
    x = np.random.default_rng(1).normal(size=(2, 784)).astype(np.float32)
    ref = run(cold.predict(pinned(TMessage, x)))
    _walk_script(jeng, teng, [x])
    first = run(teng.predict(pinned(TMessage, x)))  # a hit already
    run(jeng.predict(pinned(JMessage, x)))
    assert tseg.n_calls == jseg.n_calls == 1  # the hit: no call
    assert first.to_dict() == ref.to_dict()
    assert tcache.stats == jcache.stats


def test_coalesced_segment_is_one_call():
    (jeng, jcache), (teng, tcache) = cached_engines(mlp_node("m"),
                                                    plan_mode="fused")
    jseg, tseg = jeng.plan.segments[0], teng.plan.segments[0]
    jseg.batcher = JDynamicBatcher(
        jseg, JBatcherConfig(max_batch_size=8, max_delay_ms=5.0))
    tseg.batcher = TDynamicBatcher(
        tseg._batched, TBatcherConfig(max_batch_size=8, max_delay_ms=5.0))
    x = np.zeros((1, 784), np.float32)

    async def storm(eng, cls):
        return await asyncio.gather(*(eng.predict(pinned(cls, x))
                                      for _ in range(10)))

    run(storm(jeng, JMessage))
    outs = run(storm(teng, TMessage))
    assert tseg.n_calls == jseg.n_calls == 1
    assert tcache.stats == jcache.stats and tcache.stats["coalesced"] == 9
    ref = outs[0].to_dict()
    assert all(o.to_dict() == ref for o in outs)


def test_an_opted_out_segment_never_caches():
    spec = mlp_node("m")
    spec["parameters"].append({"name": "cacheable", "value": "false",
                               "type": "BOOL"})
    (jeng, jcache), (teng, tcache) = cached_engines(spec, plan_mode="fused")
    assert not teng.plan.segments[0].cacheable
    x = np.zeros((1, 784), np.float32)
    _walk_script(jeng, teng, [x, x])
    assert teng.plan.segments[0].n_calls == jeng.plan.segments[0].n_calls == 2
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 0


# ---- example graphs: cached = cold in the port, counters = the reference's ---

FAST_EXAMPLES = [
    ("iris", np.array([[5.1, 3.5, 1.4, 0.2]], np.float32)),
    ("iris-with-outlier", np.array([[5.1, 3.5, 1.4, 0.2]], np.float32)),
    ("mnist", np.zeros((1, 784), np.float32)),
    ("ensemble", np.zeros((1, 784), np.float32)),
    ("epsilon-greedy-mab", np.zeros((1, 784), np.float32)),
]


@pytest.mark.parametrize("plan", ["walk", "fused"])
@pytest.mark.parametrize("name,x", FAST_EXAMPLES,
                         ids=[f[0] for f in FAST_EXAMPLES])
def test_example_graph_cache_parity(name, x, plan):
    on = {"seldon.io/graph-plan": plan, "seldon.io/prediction-cache": "true"}
    cold = TLocal(tspec.load_deployment(_example(
        name, {"seldon.io/graph-plan": plan}, port=True)), device="cpu",
        seed=0)
    cached = TLocal(tspec.load_deployment(_example(name, on, port=True)),
                    device="cpu", seed=0)
    jcached = JLocal(SeldonDeployment.from_dict(_example(name, on,
                                                         port=False)),
                     seed=0)
    assert cached.engine.cache is not None
    # the miss, then the hit; stateful nodes advance in step
    for _ in range(2):
        a = run(cold.predict(pinned(TMessage, x)))
        b = run(cached.predict(pinned(TMessage, x)))
        assert a.status.status == "SUCCESS", a.status
        assert a.to_dict() == b.to_dict(), (name, plan)
        run(jcached.predictors[0].engine.predict(pinned(JMessage, x)))
    assert cached.engine.cache.stats == jcached.predictors[0].engine \
        .cache.stats


def test_the_cache_annotation_is_honoured():
    """The fault repaired: the port served uncached whatever
    ``seldon.io/prediction-cache`` said."""
    dep = {"metadata": {"name": "d"}, "spec": {"annotations": {
        "seldon.io/prediction-cache": "true",
        "seldon.io/prediction-cache-bytes": "4096",
        "seldon.io/spec-hash": "abc", "seldon.io/batching": "false"},
        "predictors": [{"name": "main", "graph": _to_port(mlp_node("m"))}]}}
    local = TLocal(tspec.load_deployment(dep), device="cpu")
    eng = local.engine
    assert eng.cache is not None and eng.cache.config.max_bytes == 4096
    assert eng.cache.config.name == "d/main" and eng.cache_version == "abc"
    calls = count_calls_port(eng)
    x = np.zeros((1, 784), np.float32)
    a = run(local.predict(pinned(TMessage, x)))
    b = run(local.predict(pinned(TMessage, x)))
    assert calls[0] == 1 and eng.cache.stats["hits"] == 1
    assert a.to_dict() == b.to_dict()


# ---- cache and QoS ---------------------------------------------------------

def test_a_request_shed_by_qos_never_poisons_the_walk_cache():
    jqos = JEngineQos(JQosConfig(name="p", slo_p95_ms=50))
    tqos = TEngineQos(TQosConfig(name="p", slo_p95_ms=50))
    jcache = jc.PredictionCache(jc.CacheConfig(name="t"))
    tcache = tc.PredictionCache(tc.CacheConfig(name="t"))
    jeng = JEngine(mlp_node("m"), resolver=lambda u: jresolve(u, NO_BATCH),
                   name="p", cache=jcache, qos=jqos)
    teng = TEngine(_to_port(mlp_node("m")),
                   resolver=lambda u: tresolve(u, NO_BATCH, "cpu"),
                   name="p", cache=tcache, qos=tqos)
    jcalls, tcalls = count_calls_ref(jeng), count_calls_port(teng)
    x = np.zeros((1, 784), np.float32)
    for q in (jqos, tqos):
        q.admission.config.min_limit = 0
        q.admission.limit = 0
    jout = run(jeng.predict(pinned(JMessage, x)))
    tout = run(teng.predict(pinned(TMessage, x)))
    assert tout.status.code == jout.status.code == 429
    assert tcalls[0] == jcalls[0] == 0
    assert tcache.stats == jcache.stats and tcache.stats["entries"] == 0
    assert teng._flight.leader_count() == 0
    for q in (jqos, tqos):
        q.admission.limit = 8
    _walk_script(jeng, teng, [x, x])
    assert tcalls[0] == jcalls[0] == 1  # cold once, then the cache
    assert tcache.stats == jcache.stats
