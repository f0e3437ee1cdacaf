"""The port's GL18xx residency verification (``seldon_core_tpu_torch/``
``analysis/planlint.py``) against the reference's, and the live plan's
``GraphPlan.residency_map``, which now answers from the same
:func:`plan_edges`.

- ``plan_edges`` gives EQUAL edges (src, dst, unit path, tier,
  partition, ownership, remote, fused) for every example spec under
  every device-plane and mesh posture;
- each GL18xx rule's planted defect and its fixed twin give EQUAL
  findings, with the port's ``TRANSFER_GBPS``/``HOP_OVERHEAD_MS`` (the
  card's, measured by ``chip_smoke.py`` phase ``lint``) set to the
  reference's v5e figures, since GL1804 prices with them; a last case
  prices with the port's own figures;
- the port's fused ``GraphPlan.residency_map`` is the reference's under
  plain, mesh, plane, cache and shm postures.
"""

import glob
import json
import os

import pytest

from seldon_core_tpu.analysis import lint_graph as ref_lint_graph
from seldon_core_tpu.analysis import planlint as jplanlint
from seldon_core_tpu.graph.spec import PredictiveUnit as JUnit
from seldon_core_tpu_torch.analysis import lint_graph, planlint
from seldon_core_tpu_torch.graph.spec import PredictiveUnit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "seldon_core_tpu.models", "seldon_core_tpu_torch.models"

EXAMPLES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "examples", "graphs", "*.json"))
    + glob.glob(os.path.join(ROOT, "seldon_core_tpu_torch", "examples",
                             "*.json")))

POSTURES = {
    "none": {},
    "plane-on": {"seldon.io/device-plane": "true"},
    "plane-off": {"seldon.io/device-plane": "false"},
    "shm-fused": {"seldon.io/device-plane": "true",
                  "seldon.io/device-plane-remote": "shm",
                  "seldon.io/graph-plan": "fused"},
    "mesh-dp-fused": {"seldon.io/mesh": "dp=2",
                      "seldon.io/graph-plan": "fused"},
    "mesh-dp-tp-fused-plane": {"seldon.io/mesh": "dp=2,tp=2",
                               "seldon.io/graph-plan": "fused",
                               "seldon.io/device-plane": "true"},
    "bad-plane": {"seldon.io/device-plane": "maybe",
                  "seldon.io/mesh": "dp=nope"},
}


def _to(ns, obj):
    text = json.dumps(obj)
    text = (text.replace(PORT + ".", REF + ".") if ns == REF
            else text.replace(REF + ".", PORT + "."))
    return json.loads(text)


def _edge(e):
    return (e.src, e.dst, e.path, e.state.tier, e.state.partition,
            e.state.ownership, e.remote, e.fused)


@pytest.mark.parametrize("posture", sorted(POSTURES))
@pytest.mark.parametrize("rel", EXAMPLES)
def test_plan_edges_equal_the_references(rel, posture):
    with open(os.path.join(ROOT, rel)) as f:
        dep = json.load(f)
    graph = dep["spec"]["predictors"][0]["graph"]
    ann = {**dep["spec"].get("annotations", {}), **POSTURES[posture]}
    port = planlint.plan_edges(
        PredictiveUnit.from_dict(_to(PORT, graph)), ann, "main")
    ref = jplanlint.plan_edges(JUnit.from_dict(_to(REF, graph)), ann, "main")
    assert [_edge(e) for e in port] == [_edge(e) for e in ref]


# ---- each rule, planted and fixed ------------------------------------------

IRIS, MLP, RESNET = ("iris:IrisClassifier", "mlp:MNISTMLP",
                     "resnet:ResNet50Model")
ON = {"seldon.io/device-plane": "true"}
OFF = {"seldon.io/device-plane": "false"}
REMOTE_OFF = {**ON, "seldon.io/device-plane-remote": "off"}
MESH = {"seldon.io/graph-plan": "fused", "seldon.io/mesh": "dp=2,tp=2"}


def _model(ns, name, cls, params=(), children=()):
    return {"name": name, "type": "MODEL", "parameters": [
        {"name": "model_class", "value": f"{ns}.{cls}", "type": "STRING"},
        *params], "children": list(children)}


def _remote(name, transport, params=(), children=()):
    return {"name": name, "type": "MODEL", "parameters": list(params),
            "endpoint": {"service_host": f"{name}.default.svc",
                         "service_port": 9000, "type": transport},
            "children": list(children)}


def _t(ms):
    return {"name": "timeout_ms", "value": str(ms), "type": "INT"}


def _gl1804(ns, deadline):
    graph = _model(ns, "top", RESNET, [_t(4)], children=[_remote(
        "tail", "REST", [{"name": "model_class",
                          "value": f"{ns}.{RESNET}", "type": "STRING"},
                         _t(4)])])
    return graph, {**REMOTE_OFF,
                   "seldon.io/engine-walk-timeout-ms": str(deadline),
                   "seldon.io/batch-max-size": "256"}


def _fanout(ns, typ="COMBINER", impl="AVERAGE_COMBINER"):
    return {"name": "ens", "type": typ, "implementation": impl,
            "children": [_remote("left", "GRPC"), _remote("right", "GRPC")]}


#: id → (function of the package giving (graph, annotations), the GL18xx
#: codes it must raise beside the GL1805 map)
CASES = {
    "gl1801-rest": (lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "REST")]), ON), ["GL1801"]),
    "gl1801-fixed-grpc": (lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "GRPC")]), ON), []),
    "gl1801-fixed-remote-off": (lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "REST")]), REMOTE_OFF), []),
    "gl1801-plane-off": (lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "REST")]), OFF), []),
    "gl1802-fanout": (lambda ns: (_fanout(ns), ON), ["GL1802"]),
    "gl1802-router-quiet": (lambda ns: (_fanout(
        ns, "ROUTER", "RANDOM_ABTEST"), ON), []),
    "gl1802-shared-quiet": (lambda ns: (_fanout(ns), REMOTE_OFF), []),
    "gl1802-cache": (lambda ns: (_remote("big", "GRPC"), {
        **ON, "seldon.io/prediction-cache": "true"}), ["GL1802"]),
    "gl1802-cache-off": (lambda ns: (_remote("big", "GRPC"), ON), []),
    "gl1803": (lambda ns: (_model(ns, "mlp", MLP, children=[
        _model(ns, "iris", IRIS)]), {**ON, **MESH}), ["GL1803"]),
    "gl1803-no-tp": (lambda ns: (_model(ns, "mlp", MLP, children=[
        _model(ns, "iris", IRIS)]), {**ON, **MESH,
                                     "seldon.io/mesh": "dp=4,tp=1"}), []),
    "gl1803-walk": (lambda ns: (_model(ns, "mlp", MLP, children=[
        _model(ns, "iris", IRIS)]), {**ON, "seldon.io/mesh": "dp=2,tp=2"}),
        []),
    "gl1804": (lambda ns: _gl1804(ns, 8.5), ["GL1804"]),
    "gl1804-absorbed": (lambda ns: _gl1804(ns, 60), []),
    "gl1804-defers-to-gl301": (lambda ns: _gl1804(ns, 7), []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_findings_equal_the_references(monkeypatch, case):
    monkeypatch.setattr(planlint, "TRANSFER_GBPS", jplanlint.TRANSFER_GBPS)
    monkeypatch.setattr(planlint, "HOP_OVERHEAD_MS",
                        jplanlint.HOP_OVERHEAD_MS)
    make, want = CASES[case]
    graph, ann = make(PORT)
    rgraph, rann = make(REF)
    port = lint_graph(graph, annotations=ann)
    ref = ref_lint_graph(rgraph, annotations=rann)
    gl18 = [f.code for f in port if f.code.startswith("GL18")]
    assert gl18 == want + ["GL1805"]
    assert [(f.code, f.severity, f.path,
             f.message.replace(PORT + ".", REF + "."), f.related)
            for f in port] == [
        (f.code, f.severity, f.path, f.message, f.related) for f in ref]


def test_gl1804_prices_with_the_cards_figures():
    # the entry edge and the byte-capped remote edge each move 256 x 1000
    # float32 rows at host-bytes (four hops: d2h, serialize, parse, h2d)
    nbytes = 256 * 1000 * 4
    per_edge = 4 * (planlint.HOP_OVERHEAD_MS
                    + nbytes / (planlint.TRANSFER_GBPS * 1e9) * 1e3)
    # a deadline between the budgets alone (8 ms) and budgets + transitions
    graph, ann = _gl1804(PORT, 8 + per_edge)
    (f,) = [f for f in lint_graph(graph, annotations=ann)
            if f.code == "GL1804"]
    assert (f"({8 + 2 * per_edge:.2f}ms at {planlint.TRANSFER_GBPS:g} GB/s, "
            f"{planlint.HOP_OVERHEAD_MS:g}ms/hop)") in f.message


# ---- the live plan ---------------------------------------------------------

GRAPH = {"name": "t", "type": "TRANSFORMER", "parameters": [
    {"name": "model_class", "type": "STRING", "value": "PKG.mlp:MNISTMLP"}],
    "children": [{"name": "c", "type": "COMBINER",
                  "implementation": "AVERAGE_COMBINER",
                  "children": [{"name": "a", "type": "MODEL"},
                               {"name": "rem", "type": "MODEL",
                                "endpoint": {"service_host": "h",
                                             "service_port": 1,
                                             "type": "GRPC"}}]}]}


def _engines():
    from seldon_core_tpu.graph.engine import GraphEngine as JEngine
    from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    class Ident:
        def transform_input_fn(self, X):
            return X

        def predict_fn(self, X):
            return X

    class Remote:
        def predict(self, X, names):
            return X

    def resolver(handle_cls):
        def resolve(u):
            obj = Remote() if u.name == "rem" else Ident()
            return handle_cls(obj, name=u.name,
                              service_type=u.resolved_type)
        return resolve

    def spec(pkg):
        return json.loads(json.dumps(GRAPH).replace("PKG", pkg))

    return (GraphEngine(spec(PORT), resolver=resolver(ComponentHandle),
                        plan_mode="fused"),
            JEngine(spec(REF), resolver=resolver(JHandle),
                    plan_mode="fused"))


@pytest.mark.parametrize("ann", [
    {}, {"seldon.io/mesh": "dp=2"},
    {"seldon.io/mesh": "dp=2", "seldon.io/device-plane": "true"},
    {"seldon.io/device-plane": "true", "seldon.io/prediction-cache": "true"},
    {"seldon.io/device-plane": "true",
     "seldon.io/device-plane-remote": "shm"},
    {"seldon.io/mesh": "dp=2,tp=2", "seldon.io/device-plane": "true"},
], ids=["plain", "mesh", "mesh-plane", "plane-cache", "shm", "dp-tp-plane"])
def test_live_residency_map_is_plan_edges_and_the_references(ann):
    t, j = _engines()
    rows = t.plan.residency_map(ann)
    assert rows == j.plan.residency_map(ann)
    edges = planlint.plan_edges(t.plan.root.node.unit,
                                {**ann, "seldon.io/graph-plan": "fused"})
    assert [(r["src"], r["dst"], r["tier"], r["partition"],
             r["ownership"], r["fused"], r["remote"]) for r in rows] == [
        (e.src, e.dst, e.state.tier, e.state.partition, e.state.ownership,
         e.fused, e.remote) for e in edges]
