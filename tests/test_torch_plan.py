"""The port's graph-plan compiler (``graph/plan.py``) and the engine's plan
mode against the JAX package's.

- Partition: ``compile_plan``'s segments, members and boundary report
  EQUAL the reference's for every example graph and for the cases of the
  reference's own plan tests (chain, combiner fan-in, chain above a
  boundary, router root, duck graphs, tags and metrics, segment batching).
- Within the port, walk and fused answers are byte-identical
  (``to_dict()`` with the puid pinned), and a fused segment is one call per
  request.
- Port fused against reference fused, on the reference's weights converted
  by ``convert.py``: ids, routing, names and meta EQUAL; probabilities
  within the per-dtype tolerance of ``tests/test_torch_models.py``: float32
  atol 1e-5 (the two frameworks sum the same terms in another order),
  bfloat16 atol 2e-2 with equal top-1 ids.
- A bad ``seldon.io/graph-plan`` raises at load as the reference's
  admission does; a good one is honoured (the port ignored both before).
- The launch-counter helper that a capture uses (``ops/launches.py``).

On the CPU a segment runs its stages eagerly; its CUDA graphs are checked on
the card by ``chip_smoke.py`` (``plan_resnet50``, ``plan_graphs``).
"""

import asyncio
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import plan as jplan
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.compile import graph_plan_mode as j_plan_mode
from seldon_core_tpu.operator.local import resolve_component as jresolve
from seldon_core_tpu.operator.spec import (
    DeploymentValidationError as JDeploymentValidationError,
)
from seldon_core_tpu.operator.spec import SeldonDeployment
from seldon_core_tpu.runtime.batcher import BatcherConfig as JBatcherConfig
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph import plan as tplan
from seldon_core_tpu_torch.graph import spec as tspec
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.models import resnet as tresnet
from seldon_core_tpu_torch.operator.local import LocalDeployment
from seldon_core_tpu_torch.operator.local import resolve_component as tresolve
from seldon_core_tpu_torch.ops import launches
from seldon_core_tpu_torch.runtime.batcher import BatcherConfig as TBatcherConfig
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from tests.test_torch_models import CLASSES, SIZE, _resnets

ROOT = Path(__file__).resolve().parents[1]
PORT_GRAPHS = ROOT / "seldon_core_tpu_torch" / "examples"
NO_BATCH = {"seldon.io/batching": "false"}
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def run(coro):
    return asyncio.run(coro)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def mlp_node(name, seed=0, hidden=32):
    return {"name": name, "type": "MODEL", "parameters": [
        {"name": "model_class", "value": "seldon_core_tpu.models.mlp:MNISTMLP",
         "type": "STRING"},
        {"name": "seed", "value": str(seed), "type": "INT"},
        {"name": "hidden", "value": str(hidden), "type": "INT"}]}


def _to_port(tree):
    """A graph (or deployment) with the reference's model classes mapped to
    the port's."""
    out = copy.deepcopy(tree)

    def walk(node):
        for p in node.get("parameters", []) or []:
            if p["name"] == "model_class":
                p["value"] = p["value"].replace("seldon_core_tpu.",
                                                "seldon_core_tpu_torch.")
        for c in node.get("children", []) or []:
            walk(c)

    walk(out)
    return out


def _to_ref(tree):
    out = copy.deepcopy(tree)

    def walk(node):
        for p in node.get("parameters", []) or []:
            if p["name"] == "model_class":
                p["value"] = p["value"].replace("seldon_core_tpu_torch.",
                                                "seldon_core_tpu.")
        for c in node.get("children", []) or []:
            walk(c)

    walk(out)
    return out


def _port_resolver(jeng, ann):
    """The port's resolver on the CPU, every component given the reference
    component's weights (before the plan compiles)."""
    def resolve(unit):
        impl = tresolve(unit, ann, "cpu")
        th = getattr(impl, "handle", impl)
        j = jeng.node_impl(unit.name)
        jh = getattr(j, "handle", j)
        if hasattr(th.user, "params") and hasattr(jh.user, "params") \
                and isinstance(th.user.params, (list, dict)):
            th.user.params = convert.params_from_jax(_host(jh.user.params))
        return impl
    return resolve


def _engines(spec, ann=NO_BATCH, plan_mode="fused", jresolver=None,
             tresolver=None, jkw=None, tkw=None):
    """The reference engine over ``spec`` and the port's over its port copy
    on the reference's weights."""
    jeng = JEngine(spec, resolver=jresolver or (lambda u: jresolve(u, ann)),
                   name="p", plan_mode=plan_mode, **(jkw or {}))
    teng = TEngine(_to_port(spec),
                   resolver=tresolver or _port_resolver(jeng, ann),
                   name="p", plan_mode=plan_mode, **(tkw or {}))
    return jeng, teng


def _describe(eng):
    return None if eng.plan is None else eng.plan.describe()


def pinned(cls, x, names=()):
    msg = cls.from_ndarray(np.asarray(x), names)
    msg.meta.puid = "parity-pinned"
    return msg


def assert_walk_fused_parity(fused: TEngine, x, n=2):
    """Within the port: a walk engine over the same components answers
    byte-identically to the fused one."""
    walk = TEngine(fused.spec, resolver=lambda u: fused.node_impl(u.name),
                   name=fused.name)
    for _ in range(n):
        a = run(walk.predict(pinned(TMessage, x)))
        b = run(fused.predict(pinned(TMessage, x)))
        assert a.status.status == "SUCCESS", a.status.info
        assert a.to_dict() == b.to_dict()
    return walk


def assert_port_matches_reference(jeng, teng, x, dtype="float32"):
    j = run(jeng.predict(pinned(JMessage, x))).to_dict()
    t = run(teng.predict(pinned(TMessage, x))).to_dict()
    jd, td = j.pop("data"), t.pop("data")
    assert t == j  # meta (requestPath, routing, tags, metrics), status
    assert td["names"] == jd["names"]
    jv, tv = np.asarray(jd["ndarray"]), np.asarray(td["ndarray"])
    assert tv.shape == jv.shape
    if jv.dtype.kind in "iub":
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, atol=ATOL[dtype])
        if tv.ndim == 2:
            np.testing.assert_array_equal(tv.argmax(-1), jv.argmax(-1))


# ---- the launch-counter helper ---------------------------------------------

def test_launch_recording_undoes_the_capture_and_counts_replays():
    def fake_kernel():
        launches.note(fake_kernel)

    other = launches.register("test_other_kernel", lambda: None)
    launches.register("test_fake_kernel", fake_kernel)
    fake_kernel()  # one eager launch
    with launches.Recording() as rec:
        for _ in range(3):
            fake_kernel()
    assert rec.counts == {"test_fake_kernel": 3}
    assert fake_kernel.launches == 4
    rec.undo()  # a capture launches nothing
    assert fake_kernel.launches == 1
    rec.replayed()
    rec.replayed(5)
    assert fake_kernel.launches == 1 + 3 * 6
    assert other.launches == 0
    with launches.Recording():
        with pytest.raises(RuntimeError, match="already open"):
            launches.Recording().__enter__()


def test_a_failed_capture_leaves_the_launch_counters_as_they_were(
        monkeypatch):
    """A capture cut part way launched nothing: its notes come off the
    counters although it raised (torch.cuda's capture calls are stood in
    for on the CPU; the capture fails as it closes)."""
    import contextlib

    def kernel():
        launches.note(kernel)

    launches.register("test_capture_kernel", kernel)

    class Noting:
        def predict_fn(self, X):
            kernel()
            return X * 2.0

    teng = TEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: THandle(Noting(), name="m"),
                   plan_mode="fused")
    seg = teng.plan.segments[0]

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(*args, **kwargs):
        yield
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    x = torch.ones((1, 2))
    with pytest.raises(RuntimeError, match=r"segment 'm': capture of bucket"):
        seg._capture(seg.bucket_key(x), x)
    assert kernel.launches == 1  # the eager run's; the capture's undone
    assert seg.capture_s == {}


def test_launch_recording_is_per_thread():
    import threading

    def k():
        launches.note(k)

    launches.register("test_thread_kernel", k)
    with launches.Recording() as rec:
        t = threading.Thread(target=lambda: [k() for _ in range(4)])
        t.start()
        t.join()
        k()
    assert rec.counts == {"test_thread_kernel": 1}  # the other thread's 4
    assert k.launches == 5                          # are counted, not recorded


def test_kernel_wrappers_are_registered():
    from seldon_core_tpu_torch.ops import attention, quant
    from seldon_core_tpu_torch.runtime import paged

    names = {quant.int8_matmul_cuda.kernel_name,
             paged.paged_attention_cuda.kernel_name,
             attention.flash_attention_cuda.kernel_name}
    assert names == {"int8_matmul", "paged_attention", "flash_attention"}


# ---- partition: every example graph ----------------------------------------

def _example_engines(path):
    d = json.loads(path.read_text())
    ann = {**d.get("metadata", {}).get("annotations", {}),
           **d["spec"].get("annotations", {})}
    graph = d["spec"]["predictors"][0]["graph"]
    jeng = JEngine(_to_ref(graph), resolver=lambda u: jresolve(u, ann))
    teng = TEngine(graph, resolver=lambda u: tresolve(u, ann, "cpu"))
    return jeng, teng


def _close_llms(teng):
    for node in teng._nodes.values():
        user = getattr(getattr(node.impl, "handle", node.impl), "user", None)
        eng = getattr(user, "engine", None)
        if eng is not None and hasattr(eng, "close"):
            eng.close()


EXAMPLES = ["iris", "iris-with-outlier", "mnist", "ensemble",
            "epsilon-greedy-mab", "llm", "llm-slab", "resnet50",
            "resnet50-int8"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_partition_of_every_example_graph_equals_the_reference(name):
    """Segments, members and the boundary report, with their reasons.
    (``llm-checkpoint.json`` needs a checkpoint on disk and partitions as
    ``llm.json``: one message-level node.)"""
    jeng, teng = _example_engines(PORT_GRAPHS / f"{name}.json")
    try:
        jd = jplan.compile_plan(jeng.root).describe()
        td = tplan.compile_plan(teng.root).describe()
        assert td == jd
        assert (jplan.compile_plan(jeng.root).fully_fused
                == tplan.compile_plan(teng.root).fully_fused)
    finally:
        _close_llms(teng)


# ---- the reference's plan cases, both packages -----------------------------

class _JSquare:
    """The reference plan test's ``Square`` (its requestPath label)."""

    def __init__(self, seed=0):
        from seldon_core_tpu.models.mlp import init_mlp_params

        self.params = init_mlp_params(jax.random.PRNGKey(seed), (16, 16, 16))

    def predict_fn(self, params, X):
        from seldon_core_tpu.models.mlp import mlp_apply

        return mlp_apply(params, X)


class _TSquare:
    """``Square`` of the port, on given reference weights."""

    def __init__(self, params):
        self.params = convert.params_from_jax(_host(params))

    def predict_fn(self, params, X):
        from seldon_core_tpu_torch.models.mlp import mlp_apply

        return mlp_apply(params, X)


def test_linear_chain_fuses_to_one_segment_one_call():
    spec = {"name": "m1", "type": "MODEL", "children": [{
        "name": "m2", "type": "MODEL",
        "children": [{"name": "m3", "type": "MODEL"}]}]}
    jobjs = {n: _JSquare(seed=ord(n[-1])) for n in ("m1", "m2", "m3")}
    jeng, teng = _engines(
        spec,
        jresolver=lambda u: JHandle(jobjs[u.name], name=u.name),
        tresolver=lambda u: THandle(_TSquare(jobjs[u.name].params),
                                    name=u.name))
    assert _describe(teng) == _describe(jeng)
    assert teng.plan.fully_fused
    seg = teng.plan.segments[0]
    assert [s.name for s in seg.members] == ["m1", "m2", "m3"]
    x = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    n0 = seg.n_calls
    out = run(teng.predict(pinned(TMessage, x)))
    assert seg.n_calls - n0 == 1  # ONE call for three nodes
    assert list(out.meta.request_path) == ["m1", "m2", "m3"]
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x)


def test_combiner_fan_in_is_one_segment():
    spec = {"name": "ens", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [mlp_node(f"m{i}", seed=i) for i in range(3)]}
    jeng, teng = _engines(spec)
    assert _describe(teng) == _describe(jeng)
    assert teng.plan.fully_fused and len(teng.plan.segments[0].members) == 4
    x = np.random.default_rng(1).normal(size=(2, 784)).astype(np.float32)
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x)


class _DuckNegate:
    def predict(self, X, names):
        return -np.asarray(X)


def test_chain_segment_above_an_interpreter_boundary():
    spec = mlp_node("top", seed=3)
    spec["children"] = [{"name": "duck", "type": "MODEL"}]

    def jres(u):
        if u.name == "duck":
            return JHandle(_DuckNegate(), name="duck")
        return jresolve(u, NO_BATCH)

    jeng = JEngine(spec, resolver=jres, name="p", plan_mode="fused")

    def tres(u):
        if u.name == "duck":
            return THandle(_DuckNegate(), name="duck")
        return _port_resolver(jeng, NO_BATCH)(u)

    teng = TEngine(_to_port(spec), resolver=tres, name="p",
                   plan_mode="fused")
    assert _describe(teng) == _describe(jeng)
    assert not teng.plan.fully_fused
    assert [s.name for s in teng.plan.segments[0].members] == ["top"]
    assert dict(teng.plan.boundaries) == dict(jeng.plan.boundaries)
    x = np.random.default_rng(2).normal(size=(1, 784)).astype(np.float32)
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x)


def test_router_root_keeps_its_branches_fused():
    spec = {"name": "r", "implementation": "SIMPLE_ROUTER",
            "children": [mlp_node("a", seed=0), mlp_node("b", seed=1)]}
    jeng, teng = _engines(spec)
    assert _describe(teng) == _describe(jeng)
    assert {s.name for s in teng.plan.segments} == {"a", "b"}
    assert "r" in dict(teng.plan.boundaries)
    x = np.zeros((1, 784), np.float32)
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x)
    assert run(teng.predict(pinned(TMessage, x))).meta.routing == {"r": 0}


class _Duck:
    def predict(self, X, names):
        return np.asarray(X) + 1.0


def test_all_duck_graph_disables_the_plan():
    spec = {"name": "m", "type": "MODEL"}
    jeng, teng = _engines(
        spec, jresolver=lambda u: JHandle(_Duck(), name="m"),
        tresolver=lambda u: THandle(_Duck(), name="m"))
    assert jeng.plan is None and teng.plan is None
    out = run(teng.predict(pinned(TMessage, np.zeros((1, 2)))))
    np.testing.assert_array_equal(out.host_data(), [[1.0, 1.0]])


def test_non_tensor_payload_walks_beneath_the_segment():
    jeng, teng = _engines(mlp_node("m"))
    assert teng.plan is not None
    body = {"jsonData": {"rows": [[0.0] * 784]}}
    j = run(jeng.predict(JMessage.from_dict(body)))
    t = run(teng.predict(TMessage.from_dict(body)))
    walk = TEngine(_to_port(mlp_node("m")),
                   resolver=lambda u: tresolve(u, NO_BATCH, "cpu"))
    w = run(walk.predict(TMessage.from_dict(body)))
    assert (t.status.status, t.status.code) == (w.status.status,
                                                w.status.code)
    assert (t.status.status, t.status.code) == (j.status.status,
                                                j.status.code)


def test_unknown_plan_mode_is_rejected():
    with pytest.raises(ValueError):
        JEngine(mlp_node("m"), resolver=lambda u: jresolve(u, NO_BATCH),
                plan_mode="turbo")
    with pytest.raises(tspec.DeploymentValidationError,
                       match="must be 'walk' or 'fused', got 'turbo'"):
        TEngine(_to_port(mlp_node("m")),
                resolver=lambda u: tresolve(u, NO_BATCH, "cpu"),
                plan_mode="turbo")


class _JTagged:
    """The reference plan test's ``Tagged``."""

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


# the walk stamps a component's class name into requestPath: both packages'
# components go by the reference test's names
for _cls, _name in ((_JSquare, "Square"), (_TSquare, "Square"),
                    (_JTagged, "Tagged"), (_TTagged, "Tagged")):
    _cls.__name__ = _name


def test_tags_and_custom_metrics_identical_in_fused_mode():
    spec = {"name": "m", "type": "MODEL"}
    jeng, teng = _engines(spec,
                          jresolver=lambda u: JHandle(_JTagged(), name="m"),
                          tresolver=lambda u: THandle(_TTagged(), name="m"))
    assert _describe(teng) == _describe(jeng)
    x = np.ones((1, 2), np.float32)
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x)
    b = run(teng.predict(pinned(TMessage, x)))
    assert b.meta.tags == {"version": "v7"}
    assert [m.key for m in b.meta.metrics] == ["hits"]
    assert b.names == ["a", "b"]


def test_a_fused_segment_batches_end_to_end():
    spec = {"name": "ens", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [mlp_node(f"m{i}", seed=i) for i in range(2)]}
    jeng, teng = _engines(
        spec,
        jkw={"plan_batcher": JBatcherConfig(max_batch_size=8,
                                            max_delay_ms=5.0)},
        tkw={"plan_batcher": TBatcherConfig(max_batch_size=8,
                                            max_delay_ms=5.0)})
    seg = teng.plan.segments[0]
    assert seg.batcher is not None
    assert seg.batcher.config.name == jeng.plan.segments[0].batcher.config.name
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(1, 784)).astype(np.float32) for _ in range(6)]

    async def drive(eng, cls):
        return await asyncio.gather(*(eng.predict(pinned(cls, x))
                                      for x in xs))

    n0 = seg.n_calls
    touts = run(drive(teng, TMessage))
    assert seg.n_calls - n0 < len(xs)  # 6 concurrent requests, fewer calls
    assert seg.n_calls - n0 == seg.batcher.stats["batches"]
    jouts = run(drive(jeng, JMessage))
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.host_data(), np.asarray(j.host_data()),
                                   atol=ATOL["float32"])
        assert t.meta.request_path == j.meta.request_path


# ---- example graphs: walk = fused in the port, fused vs the reference --------

FAST_EXAMPLES = [
    ("iris", np.array([[5.1, 3.5, 1.4, 0.2]], np.float32)),
    ("iris-with-outlier", np.array([[5.1, 3.5, 1.4, 0.2]], np.float32)),
    ("mnist", np.random.default_rng(3).normal(size=(2, 784))),
    ("ensemble", np.random.default_rng(4).normal(size=(1, 784))
     .astype(np.float32)),
    ("epsilon-greedy-mab", np.random.default_rng(5).normal(size=(1, 784))),
]


def _seeded(d: dict) -> dict:
    d = copy.deepcopy(d)
    for p in d["spec"]["predictors"]:
        g = p["graph"]
        if g.get("implementation") in ("EPSILON_GREEDY", "RANDOM_ABTEST"):
            g.setdefault("parameters", []).append(
                {"name": "seed", "value": "0", "type": "INT"})
    return d


@pytest.mark.parametrize("name,x", FAST_EXAMPLES,
                         ids=[f[0] for f in FAST_EXAMPLES])
def test_example_graph_fused_equals_walk_and_the_reference(name, x):
    d = _seeded(json.loads((PORT_GRAPHS / f"{name}.json").read_text()))
    ann = {**d["spec"].get("annotations", {})}
    graph = d["spec"]["predictors"][0]["graph"]
    jeng, teng = _engines(_to_ref(graph), ann=ann)
    assert _describe(teng) == _describe(jeng)
    # the port: a fresh walk engine (its own stateful router/detector) over
    # the same weights answers byte-identically, request for request
    walk = TEngine(graph, resolver=_port_resolver(jeng, ann), name="p")
    for _ in range(2):
        a = run(walk.predict(pinned(TMessage, x)))
        b = run(teng.predict(pinned(TMessage, x)))
        assert a.status.status == "SUCCESS", a.status.info
        assert a.to_dict() == b.to_dict()
    # one call per request through each segment on the request's path
    assert sum(s.n_calls for s in teng.plan.segments) == 2
    # the reference's fused engine: its stateful nodes advance in step
    jwarm = run(jeng.predict(pinned(JMessage, x)))
    assert jwarm.status.status == "SUCCESS"
    run(jeng.predict(pinned(JMessage, x)))
    assert_port_matches_reference(jeng, teng, x)


# ---- a 2-stage ResNet, fused -------------------------------------------------

class _JSmallResNet:
    """The reference's 2-stage ResNet (random BatchNorm, the serving cast)
    served through its flax module, with ResNet50Model's names and tags."""

    def __init__(self, module, variables):
        self.module = module
        self.params = variables
        self.class_names = [f"class:{i}" for i in range(CLASSES)]

    def predict_fn(self, params, X):
        return self.module.apply(params, jnp.asarray(X, jnp.float32))

    def tags(self):
        return {"model": "resnet50", "image_size": SIZE}


_JSmallResNet.__name__ = "ResNet50Model"  # the port component's label


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_small_resnet_fused_equals_walk_and_the_reference(dtype_name):
    module, variables, tmod = _resnets(dtype_name)
    jm = _JSmallResNet(module, variables)
    tm = tresnet.ResNet50Model(module=tmod, image_size=SIZE, device="cpu")
    spec = {"name": "resnet", "type": "MODEL"}
    jeng, teng = _engines(
        spec, jresolver=lambda u: JHandle(jm, name="resnet"),
        tresolver=lambda u: THandle(tm, name="resnet"))
    assert _describe(teng) == _describe(jeng)
    x = np.random.default_rng(1).uniform(0, 255, (3, SIZE, SIZE, 3)).astype(
        np.float32)
    assert_walk_fused_parity(teng, x)
    assert_port_matches_reference(jeng, teng, x, dtype=dtype_name)


# ---- the annotations: rejected when bad, honoured when good ------------------

def _dep(ann: dict) -> dict:
    return {"metadata": {"name": "d"}, "spec": {
        "annotations": ann, "predictors": [{
            "name": "main", "graph": _to_port(mlp_node("m"))}]}}


@pytest.mark.parametrize("value", ["warp", "FUSEDX", "1"])
def test_a_bad_graph_plan_annotation_raises_at_load_like_the_reference(value):
    jdep = SeldonDeployment.from_dict(_to_ref(_dep(
        {"seldon.io/graph-plan": value})))
    with pytest.raises(JDeploymentValidationError) as je:
        j_plan_mode(jdep, jdep.predictors[0])
    with pytest.raises(tspec.DeploymentValidationError) as te:
        tspec.load_deployment(_dep({"seldon.io/graph-plan": value}))
    assert str(te.value) == str(je.value)


def test_the_graph_plan_annotation_is_honoured():
    """The fault repaired: the port served every deployment by the walk,
    whatever ``seldon.io/graph-plan`` said."""
    fused = LocalDeployment(tspec.load_deployment(
        _dep({"seldon.io/graph-plan": " Fused ",
              "seldon.io/batching": "false"})), device="cpu")
    walk = LocalDeployment(tspec.load_deployment(
        _dep({"seldon.io/batching": "false"})), device="cpu")
    assert walk.engine.plan is None
    assert fused.engine.plan is not None and fused.engine.plan.fully_fused
    seg = fused.engine.plan.segments[0]
    x = np.zeros((1, 784), np.float32)
    out = run(fused.predict(pinned(TMessage, x)))
    assert seg.n_calls == 1 and out.status.status == "SUCCESS"


def test_plan_batcher_and_warmup_from_the_annotations():
    dep = _dep({"seldon.io/graph-plan": "fused",
                "seldon.io/graph-plan-warmup": "true",
                "seldon.io/batch-max-size": "4"})
    local = LocalDeployment(tspec.load_deployment(dep), device="cpu")
    seg = local.engine.plan.segments[0]
    assert seg.batcher is not None and seg.batcher.config.name == "plan:m"
    assert seg.batcher.buckets == [1, 2, 4]
    # the MNIST MLP's registered signature gives the warm-up row
    assert seg.n_calls == 3
