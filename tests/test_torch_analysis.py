"""The port's graph checker and CLI (``seldon_core_tpu_torch/analysis/``
``graphlint.py``, ``cli.py``) against the reference's, and the port's
conformance gate.

Findings must be EQUAL in code, severity, path, message and related
locations between reference and port:

- for every spec in ``examples/graphs/`` and
  ``seldon_core_tpu_torch/examples/`` under each posture of
  :data:`POSTURES` (plan, device plane, mesh, cache, QoS, tracing,
  health, profile, artifact, fleet, budgets);
- for each planted defect of :data:`PLANTED` (one case per code family
  member);
- for the CLI over planted files with every flag.

How the two are made comparable, with each allowed difference stated:

- a spec names its models by package, so the reference lints the spec
  with ``seldon_core_tpu.models`` and the port with
  ``seldon_core_tpu_torch.models``, and the reference's messages are read
  with the port's package name in their place (:func:`_ref_rows`);
- ``_visible_devices`` of both modules is pinned to 8: the test process
  has jax loaded, so the reference would count jax's 8 virtual CPU
  devices, and the port counts CUDA devices (none here);
- the port's ``HBM_PER_CHIP_GB`` (the card's memory) is set to the
  reference's 16.0 (a TPU v5e chip's) where GL3xx/GL12xx findings are
  compared, and planlint's ``TRANSFER_GBPS``/``HOP_OVERHEAD_MS``
  (measured on the card) to the reference's, since GL1804 prices with
  them;
- both GL16xx gates are open: the reference's when jax is imported, the
  port's when torch and ``models/traceable.py`` are (imported here).
  The quoted trace-error texts and the weak-type half of GL1602 differ
  by design; ``tests/test_torch_analysis_tracelint.py`` states both.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (opens the reference's GL16xx gate)
import pytest

import seldon_core_tpu_torch.models.traceable  # noqa: F401  (the port's)
from seldon_core_tpu.analysis import graphlint as jgraphlint
from seldon_core_tpu.analysis import lint_deployment as ref_lint_deployment
from seldon_core_tpu.analysis import lint_graph as ref_lint_graph
from seldon_core_tpu.analysis import planlint as jplanlint
from seldon_core_tpu.analysis.cli import main as ref_main
from seldon_core_tpu_torch.analysis import (
    GraphAnalysisError,
    errors,
    graphlint,
    lint_deployment,
    lint_graph,
    lint_paths,
    planlint,
)
from seldon_core_tpu_torch.analysis.cli import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "seldon_core_tpu.models"
PORT = "seldon_core_tpu_torch.models"

EXAMPLES = sorted(
    [os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "examples", "graphs", "*.json"))]
    + [os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "seldon_core_tpu_torch", "examples", "*.json"))])


def _to(ns: str, obj):
    """``obj`` (JSON-able) with model classes in package ``ns``."""
    text = json.dumps(obj)
    if ns == REF:
        text = text.replace(PORT + ".", REF + ".")
    else:
        text = text.replace(REF + ".", PORT + ".")
    return json.loads(text)


def _port_text(s: str) -> str:
    return s.replace(REF + ".", PORT + ".")


def _rows(findings):
    return [(f.code, f.severity, f.path, f.message, tuple(f.related))
            for f in findings]


def _ref_rows(findings):
    return [(f.code, f.severity, f.path, _port_text(f.message),
             tuple((p, _port_text(m)) for p, m in f.related))
            for f in findings]


@pytest.fixture
def pinned(monkeypatch):
    """The reference's budgets and an equal device count in both modules
    (module docstring)."""
    monkeypatch.setattr(jgraphlint, "_visible_devices", lambda: 8)
    monkeypatch.setattr(graphlint, "_visible_devices", lambda: 8)
    monkeypatch.setattr(graphlint, "HBM_PER_CHIP_GB",
                        jgraphlint.HBM_PER_CHIP_GB)
    monkeypatch.setattr(planlint, "TRANSFER_GBPS", jplanlint.TRANSFER_GBPS)
    monkeypatch.setattr(planlint, "HOP_OVERHEAD_MS",
                        jplanlint.HOP_OVERHEAD_MS)


def _names(graph: dict) -> list:
    out = [graph.get("name", "")]
    for c in graph.get("children", []) or []:
        out += _names(c)
    return out


def _qos(names: list) -> dict:
    # the last node as the fallback: unknown-free, the root when alone
    return {"seldon.io/slo-p95-ms": "5", "seldon.io/qos-fallback": names[-1],
            "seldon.io/qos-breaker-min-calls": "4"}


#: posture name → annotations, or a function of the graph's node names
POSTURES = {
    "bare": {},
    "plan": {"seldon.io/graph-plan": "fused"},
    "plan-walk": {"seldon.io/graph-plan": "walk"},
    "device-plane-on": {"seldon.io/device-plane": "true"},
    "device-plane-off": {"seldon.io/device-plane": "false"},
    "device-plane-shm-cache-fused": {
        "seldon.io/device-plane": "true",
        "seldon.io/device-plane-remote": "shm",
        "seldon.io/prediction-cache": "true",
        "seldon.io/graph-plan": "fused",
        "seldon.io/engine-walk-timeout-ms": "5000"},
    "mesh-dp": {"seldon.io/graph-plan": "fused", "seldon.io/mesh": "dp=2",
                "seldon.io/tpu-chips": "2"},
    "mesh-tp": {"seldon.io/graph-plan": "fused",
                "seldon.io/mesh": "dp=2,tp=3",
                "seldon.io/device-plane": "true",
                "seldon.io/tpu-hbm-gb": "0.2"},
    "mesh-pinned": lambda names: {"seldon.io/graph-plan": "fused",
                                  "seldon.io/mesh": "dp=4",
                                  "seldon.io/placement": f"{names[0]}=3"},
    "mesh-oversubscribed": {"seldon.io/mesh": "dp=16"},
    "cache": {"seldon.io/prediction-cache": "true",
              "seldon.io/prediction-cache-ttl-ms": "1000"},
    "qos": _qos,
    "tracing": {"seldon.io/tracing": "true", "seldon.io/trace-sample": "0.25",
                "seldon.io/trace-export": "/tmp/traces.jsonl"},
    "trace-knobs-only": {"seldon.io/trace-slow-ms": "50"},
    "health": {"seldon.io/slo-availability": "0.999",
               "seldon.io/health-sample-ms": "100"},
    "profile": {"seldon.io/profile": "true", "seldon.io/profile-hz": "97"},
    "artifact": {"seldon.io/artifact-store": "/tmp/store"},
    "artifact-fused": {"seldon.io/artifact-store": "/tmp/store",
                       "seldon.io/graph-plan": "fused",
                       "seldon.io/artifact-parity": "false"},
    "fleet": {"seldon.io/fleet-replicas": "3",
              "seldon.io/fleet-autoscale": "true",
              "seldon.io/fleet-obs-interval-ms": "500"},
    "budgets": {"seldon.io/tpu-hbm-gb": "0.06",
                "seldon.io/engine-walk-timeout-ms": "1"},
    "chips": {"seldon.io/tpu-chips": "1"},
}


def _example(rel: str, posture: str, ns: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        dep = json.load(f)
    ann = POSTURES[posture]
    if callable(ann):
        ann = ann(_names(dep["spec"]["predictors"][0]["graph"]))
    dep["spec"].setdefault("annotations", {}).update(ann)
    return _to(ns, dep)


@pytest.mark.parametrize("posture", sorted(POSTURES))
@pytest.mark.parametrize("rel", EXAMPLES)
def test_example_findings_equal_the_references(pinned, rel, posture):
    port = lint_deployment(_example(rel, posture, PORT))
    ref = ref_lint_deployment(_example(rel, posture, REF))
    assert _rows(port) == _ref_rows(ref)


# ---- planted defects ------------------------------------------------------

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


IRIS, MLP = "iris:IrisClassifier", "mlp:MNISTMLP"
LLM, RESNET = "llm_demo:DemoLLM", "resnet:ResNet50Model"
OUTLIER = "outlier:MahalanobisOutlier"
AVG = {"type": "COMBINER", "implementation": "AVERAGE_COMBINER"}


def _cycle(ns):
    node = {"name": "x", "type": "MODEL"}
    node["children"] = [node]
    return node


def _ens(ns, *children, name="ens"):
    return {"name": name, **AVG, "children": list(children)}


#: id → function of the package returning (graph, annotations)
PLANTED = {
    "gl001-type": lambda ns: ({"name": "x", "type": "NOPE"}, {}),
    "gl001-json": lambda ns: ("{not json", {}),
    "gl001-bool": lambda ns: ({"name": "r", "type": "MODEL", "parameters": [
        {"name": "verbose", "value": "maybe", "type": "BOOL"}]}, {}),
    "gl001-port": lambda ns: ({"name": "r", "type": "MODEL", "endpoint": {
        "service_host": "h", "service_port": "http"}}, {}),
    "gl001-int": lambda ns: ({"name": "m", "type": "MODEL", "parameters": [
        {"name": "seed", "value": "ten", "type": "INT"}]}, {}),
    "gl001-impl": lambda ns: ({"name": "m", "implementation": "NOPE"}, {}),
    "gl101": lambda ns: (_cycle(ns), {}),
    "gl102": lambda ns: (_model(ns, "a", IRIS, children=[
        _model(ns, "a", IRIS)]), {}),
    "gl103": lambda ns: (_ens(ns, _model(ns, "m", IRIS)), {}),
    "gl104": lambda ns: ({"name": "r", "type": "ROUTER"}, {}),
    "gl105": lambda ns: ({"name": "x", "type": "MODEL",
                          "implementation": "AVERAGE_COMBINER", "children": [
                              {"name": "a", "type": "MODEL"},
                              {"name": "b", "type": "MODEL"}]}, {}),
    "gl106": lambda ns: ({**_model(ns, "m", IRIS), "methods": ["route"]},
                         {}),
    "gl107-ab": lambda ns: ({"name": "ab", "implementation": "RANDOM_ABTEST",
                             "children": [{"name": c, "type": "MODEL"}
                                          for c in "abc"]}, {}),
    "gl107-eg": lambda ns: ({"name": "eg", "implementation": "EPSILON_GREEDY",
                             "parameters": [{"name": "n_branches",
                                             "value": "3", "type": "INT"}],
                             "children": [{"name": c, "type": "MODEL"}
                                          for c in "ab"]}, {}),
    "gl201": lambda ns: (_model(ns, "iris", IRIS, children=[
        _model(ns, "llm", LLM)]), {}),
    "gl201-passthrough": lambda ns: ({
        "name": "out", "type": "TRANSFORMER", "parameters": [
            {"name": "model_class", "value": f"{ns}.{OUTLIER}",
             "type": "STRING"}],
        "children": [_model(ns, "iris", IRIS, children=[
            _model(ns, "llm", LLM)])]}, {}),
    "gl202": lambda ns: (_model(ns, "mlp", MLP, children=[
        _model(ns, "iris", IRIS)]), {}),
    "gl203": lambda ns: (_model(ns, "m", "nowhere:Unknown"), {}),
    "gl204": lambda ns: (_ens(ns, _model(ns, "a", IRIS),
                              _model(ns, "b", MLP)), {}),
    "gl301": lambda ns: ({"name": "pre", "type": "TRANSFORMER",
                          "parameters": [_t(800)],
                          "children": [_model(ns, "m", IRIS, [_t(800)])]},
                         {"seldon.io/engine-walk-timeout-ms": "1000"}),
    "gl302": lambda ns: (_ens(ns, _model(ns, "r1", RESNET),
                              _model(ns, "r2", RESNET)),
                         {"seldon.io/tpu-hbm-gb": "0.05"}),
    "gl303": lambda ns: (_ens(ns, _model(ns, "r1", RESNET),
                              _model(ns, "r2", RESNET)),
                         {"seldon.io/tpu-hbm-gb": "0.11"}),
    "gl601-602": lambda ns: (_model(ns, "a", IRIS, children=[
        {"name": "r", "implementation": "SIMPLE_ROUTER", "children": [
            _model(ns, "b", IRIS), _remote("c", "REST")]}]),
        {"seldon.io/graph-plan": "fused"}),
    "gl603": lambda ns: ({"name": "m", "implementation": "SIMPLE_MODEL"},
                         {"seldon.io/graph-plan": "fused"}),
    "gl604": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/graph-plan": "eager"}),
    "gl701": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/prediction-cache": "sometimes"}),
    "gl702-705": lambda ns: ({"name": "ab", "implementation": "RANDOM_ABTEST",
                              "parameters": [{"name": "cacheable",
                                              "value": "true",
                                              "type": "BOOL"}],
                              "children": [_model(ns, "a", LLM),
                                           _model(ns, "b", OUTLIER)]},
                             {"seldon.io/prediction-cache": "true"}),
    "gl703-704": lambda ns: (_model(ns, "a", IRIS, children=[
        _model(ns, "b", IRIS), _remote("c", "GRPC")]),
        {"seldon.io/prediction-cache": "true"}),
    "gl801": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/slo-p95-ms": "fast"}),
    "gl802": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/slo-p95-ms": "50",
                          "seldon.io/qos-fallback": "ghost"}),
    "gl803": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/qos-fallback": "m"}),
    "gl804-805-806": lambda ns: ({"name": "r",
                                  "implementation": "SIMPLE_ROUTER",
                                  "children": [
                                      _model(ns, "primary", RESNET, [_t(90)]),
                                      _remote("cheap", "REST", [
                                          {"name": "model_class",
                                           "value": "nowhere:Cheap",
                                           "type": "STRING"}])]},
                                 {"seldon.io/slo-p95-ms": "20",
                                  "seldon.io/qos-fallback": "cheap"}),
    "gl901": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/tracing": "true",
                          "seldon.io/trace-sample": "2"}),
    "gl902": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/trace-sample": "0.5",
                          "seldon.io/trace-export": "/tmp/x"}),
    "gl903": lambda ns: (_model(ns, "m", IRIS),
                         {"seldon.io/tracing": "true",
                          "seldon.io/tracing-max": "64"}),
    "gl1001": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/slo-availability": "1.5"}),
    "gl1002": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/health": "false",
                           "seldon.io/health-sample-ms": "100"}),
    "gl1003": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/health": "true",
                           "seldon.io/slo-p95-ms": "40",
                           "seldon.io/health-flight-records": "32"}),
    "gl1101": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/profile": "true",
                           "seldon.io/profile-hz": "5000"}),
    "gl1102": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/profile-storm": "3"}),
    "gl1103": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/profile": "true",
                           "seldon.io/profile-window-s": "20"}),
    "gl1201": lambda ns: (_model(ns, "m", IRIS), {"seldon.io/mesh": "xp=2"}),
    "gl1202": lambda ns: (_model(ns, "m", IRIS), {"seldon.io/mesh": "dp=16"}),
    "gl1203": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/mesh": "dp=2",
                           "seldon.io/graph-plan": "fused",
                           "seldon.io/placement": "ghost=1"}),
    "gl1204": lambda ns: (_ens(ns, _model(ns, "r1", RESNET),
                              _model(ns, "r2", RESNET)),
                          {"seldon.io/mesh": "dp=2",
                           "seldon.io/graph-plan": "fused",
                           "seldon.io/tpu-hbm-gb": "0.1"}),
    "gl1205-tp-span": lambda ns: (_model(ns, "mlp", MLP),
                                  {"seldon.io/mesh": "tp=2",
                                   "seldon.io/graph-plan": "fused",
                                   "seldon.io/tpu-chips": "2"}),
    "gl1206": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/placement": "m=0"}),
    "gl1301": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/fleet-replicas": "zero"}),
    "gl1302": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/fleet-policy": "round-robin"}),
    "gl1303-1305": lambda ns: (_model(ns, "m", IRIS),
                               {"seldon.io/fleet-replicas": "2",
                                "seldon.io/fleet-autoscale": "true",
                                "seldon.io/fleet-max-replicas": "4"}),
    "gl1401": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/fleet-replicas": "2",
                           "seldon.io/fleet-obs-mad-k": "0"}),
    "gl1402-1403": lambda ns: (_model(ns, "m", IRIS),
                               {"seldon.io/fleet-obs-concurrency": "4"}),
    "gl1501": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/artifact-store": "/tmp/s",
                           "seldon.io/artifact-precompile": "maybe"}),
    "gl1502-1503": lambda ns: (_model(ns, "m", IRIS),
                               {"seldon.io/artifact-store": "/tmp/s"}),
    "gl1604-tp": lambda ns: (_model(ns, "mlp", MLP),
                             {"seldon.io/mesh": "tp=3"}),
    "gl1701": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/device-plane": "maybe"}),
    "gl1702": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/device-plane": "false",
                           "seldon.io/device-plane-remote": "shm"}),
    "gl1703": lambda ns: (_model(ns, "m", IRIS),
                          {"seldon.io/device-plane": "true",
                           "seldon.io/device-plane-remote": "loopback"}),
    "gl1801": lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "REST")]), {"seldon.io/device-plane": "true"}),
    "gl1802-fanout": lambda ns: (_ens(ns, _remote("left", "GRPC"),
                                      _remote("right", "GRPC")),
                                 {"seldon.io/device-plane": "true"}),
    "gl1802-cache": lambda ns: (_remote("big", "GRPC"),
                                {"seldon.io/device-plane": "true",
                                 "seldon.io/prediction-cache": "true"}),
    "gl1803": lambda ns: (_model(ns, "mlp", MLP, children=[
        _model(ns, "iris", IRIS)]),
        {"seldon.io/device-plane": "true", "seldon.io/graph-plan": "fused",
         "seldon.io/mesh": "dp=2,tp=2"}),
    "gl1804": lambda ns: (_model(ns, "top", RESNET, [_t(4)], children=[
        _remote("tail", "REST", [
            {"name": "model_class", "value": f"{ns}.{RESNET}",
             "type": "STRING"}, _t(4)])]),
        {"seldon.io/device-plane": "true",
         "seldon.io/device-plane-remote": "off",
         "seldon.io/engine-walk-timeout-ms": "8.5",
         "seldon.io/batch-max-size": "256"}),
    "gl1805-off": lambda ns: (_model(ns, "iris", IRIS, children=[
        _remote("post", "GRPC")]), {"seldon.io/device-plane": "false"}),
}

#: the code each planted case must raise (beside any others)
PLANTED_CODE = {k: "GL" + k[2:].split("-")[0] for k in PLANTED}
PLANTED_CODE.update({"gl601-602": "GL601", "gl702-705": "GL702",
                     "gl703-704": "GL703", "gl804-805-806": "GL804",
                     "gl1303-1305": "GL1303", "gl1402-1403": "GL1402",
                     "gl1502-1503": "GL1502", "gl1205-tp-span": "GL1205",
                     "gl1802-fanout": "GL1802", "gl1802-cache": "GL1802",
                     "gl1805-off": "GL1805"})


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_defect_findings_equal_the_references(pinned, case):
    graph, ann = PLANTED[case](PORT)
    rgraph, rann = PLANTED[case](REF)
    port = lint_graph(graph, annotations=ann)
    ref = ref_lint_graph(rgraph, annotations=rann)
    assert PLANTED_CODE[case] in [f.code for f in port], port
    assert _rows(port) == _ref_rows(ref)


def _deployment(ns, graph, annotations=None, predictors=None):
    return {"apiVersion": "machinelearning.seldon.io/v1alpha3",
            "kind": "SeldonDeployment", "metadata": {"name": "d"},
            "spec": {"name": "d", "annotations": annotations or {},
                     "predictors": predictors or [
                         {"name": "p", "graph": graph}]}}


DEPLOYMENTS = {
    "gl103-prefixed": lambda ns: _deployment(
        ns, _ens(ns, _model(ns, "m", IRIS))),
    "gl1304": lambda ns: _deployment(ns, None, predictors=[
        {"name": "p", "replicas": 2, "annotations": {
            "seldon.io/fleet-replicas": "3"},
         "graph": _model(ns, "m", IRIS)}]),
    "two-predictors-merge": lambda ns: _deployment(
        ns, None, annotations={"seldon.io/graph-plan": "fused"},
        predictors=[
            {"name": "a", "graph": _model(ns, "m", IRIS)},
            {"name": "b", "annotations": {"seldon.io/graph-plan": "walk",
                                          "seldon.io/mesh": "dp=2"},
             "graph": _model(ns, "m", MLP)}]),
    "unnamed-predictor": lambda ns: _deployment(ns, None, predictors=[
        {"graph": _ens(ns, _model(ns, "m", IRIS))}]),
    "bad-graph": lambda ns: _deployment(ns, None, predictors=[
        {"name": "p", "graph": {"name": "m", "type": "MODEL", "parameters": [
            {"name": "on", "value": "perhaps", "type": "BOOL"}]}}]),
    "bad-replicas": lambda ns: _deployment(ns, None, predictors=[
        {"name": "p", "replicas": "many", "graph": _model(ns, "m", IRIS)}]),
    "metadata-annotations": lambda ns: {
        "kind": "SeldonDeployment",
        "metadata": {"name": "d", "annotations": {
            "seldon.io/engine-walk-timeout-ms": "10"}},
        "spec": {"predictors": [{"name": "p", "graph": _model(
            ns, "m", IRIS, [_t(20)])}]}},
}


@pytest.mark.parametrize("case", sorted(DEPLOYMENTS))
def test_deployment_findings_equal_the_references(pinned, case):
    port = lint_deployment(DEPLOYMENTS[case](PORT))
    ref = ref_lint_deployment(DEPLOYMENTS[case](REF))
    assert port, case
    assert _rows(port) == _ref_rows(ref)


def test_graph_analysis_error_reads_like_the_references(pinned):
    from seldon_core_tpu.analysis import GraphAnalysisError as JError

    graph, ann = PLANTED["gl1801"](PORT)
    fs = lint_graph(graph, annotations=ann)
    rg, ra = PLANTED["gl1801"](REF)
    rfs = ref_lint_graph(rg, annotations=ra)
    err, jerr = GraphAnalysisError(fs), JError(rfs)
    assert _port_text(str(jerr)) == str(err)
    assert _rows(err.findings) == _ref_rows(jerr.findings)
    assert err.findings[0].severity == "ERROR" and errors(fs)


# ---- the CLI ---------------------------------------------------------------

def _write(path, obj):
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))
    return str(path)


HOT = textwrap.dedent("""
    import asyncio
    import time

    async def handler():
        time.sleep(1)

    async def serve(h):
        asyncio.create_task(h())

    def hop(registry, ref):
        return registry.resolve(ref)
""")


def _cli_cases(tmp, ns):
    """id → argv over files planted under ``tmp`` for package ``ns``."""
    ens = _write(tmp / "ens.json", _ens(ns, _model(ns, "m", IRIS)))
    fan = _write(tmp / "fan.json", PLANTED["gl1802-fanout"](ns)[0])
    mlp = _write(tmp / "mlp.json", _model(ns, "m", MLP, [_t(500)]))
    dep = _write(tmp / "dep.json", _deployment(ns, _model(
        ns, "m", RESNET, [_t(5)]), {"seldon.io/graph-plan": "fused"}))
    bad = _write(tmp / "bad.json", "{not json")
    hot = _write(tmp / "hot.py", HOT)
    base = str(tmp / "baseline.json")
    return {
        "specs": [ens, mlp],
        "json": [mlp, "--deadline-ms", "100", "--json"],
        "budgets": [dep, "--hbm-gb", "0.01", "--chips", "2",
                    "--deadline-ms", "1"],
        "plan-on": [fan, dep, "--plan", "on", "--json"],
        "plan-off": [fan, "--plan", "off"],
        "trace": [mlp, dep, "--trace", "--json"],
        "not-json": [bad],
        "self": ["--self", hot, "--json"],
        "fail-on-warn": ["--self", hot, "--fail-on", "warn"],
        "sarif": [fan, ens, "--self", hot, "--plan", "on", "--sarif",
                  str(tmp / "out.sarif")],
        "baseline-write": ["--self", hot, "--baseline", base,
                           "--baseline-write"],
    }


@pytest.mark.parametrize("case", ["specs", "json", "budgets", "plan-on",
                                  "plan-off", "trace", "not-json", "self",
                                  "fail-on-warn", "sarif", "baseline-write"])
def test_cli_answers_like_the_references(pinned, tmp_path, capsys, case):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    port_argv = _cli_cases(tmp_path / "p", PORT)[case]
    ref_argv = _cli_cases(tmp_path / "r", REF)[case]
    rc = port_main(port_argv)
    out = capsys.readouterr().out
    jrc = ref_main(ref_argv)
    jout = capsys.readouterr().out
    assert rc == jrc
    assert out == _port_text(jout).replace(str(tmp_path / "r"),
                                           str(tmp_path / "p"))
    for name in ("out.sarif", "baseline.json"):
        p, r = tmp_path / "p" / name, tmp_path / "r" / name
        if r.exists():
            assert p.read_text() == _port_text(r.read_text()).replace(
                str(tmp_path / "r"), str(tmp_path / "p"))


def test_cli_baseline_gates_only_new_findings(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text(HOT)
    base = str(tmp_path / "b.json")
    argv = ["--self", str(mod), "--fail-on", "warn", "--baseline", base]
    assert port_main(argv + ["--baseline-write"]) == 0
    assert port_main(argv) == 0  # every finding grandfathered
    mod.write_text("# shifted\n" + HOT + textwrap.dedent("""
        def pump(registry, frames):
            lane = registry.channel()
            for f in frames:
                lane.put(f)
    """))
    assert port_main(argv) == 1  # the new RL704 fails the run
    assert "RL704" in capsys.readouterr().out
    assert port_main(["--self", str(mod), "--baseline",
                      str(tmp_path / "nope.json")]) == 2
    with pytest.raises(SystemExit):
        port_main(["--self", str(mod), "--baseline-write"])


def test_cli_module_runs_without_jax_and_lints_the_port_clean():
    """``python -m seldon_core_tpu_torch.analysis --self --fail-on warn``
    with jax blocked: the port's package and its registry trace report no
    ERROR and no WARN, and nothing of the reference is loaded."""
    probe = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from seldon_core_tpu_torch.analysis.cli import main
        rc = main(["--self", "--fail-on", "warn"])
        ref = [m for m in sys.modules if m == "seldon_core_tpu"
               or m.startswith("seldon_core_tpu.")]
        traced = "seldon_core_tpu_torch.models.traceable" in sys.modules
        print("RESULT", rc, ref, traced)
    """)
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "graphlint: 0 error(s), 0 warning(s)" in p.stdout
    assert p.stdout.strip().splitlines()[-1] == "RESULT 0 [] True"


# ---- conformance (the port's tests/test_analysis_conformance.py) -----------

@pytest.mark.parametrize("plane", [None, "true", "false"])
@pytest.mark.parametrize("rel", EXAMPLES)
def test_example_graph_lints_clean_through_the_port(rel, plane):
    """Every example graph, with the port's own budgets and device count,
    and in both device-plane postures: no ERROR, no WARN."""
    with open(os.path.join(ROOT, rel)) as f:
        dep = _to(PORT, json.load(f))
    if plane is not None:
        dep["spec"].setdefault("annotations", {})[
            "seldon.io/device-plane"] = plane
    bad = [f for f in lint_deployment(dep) if f.severity in ("ERROR", "WARN")]
    assert bad == []


def test_the_ports_source_lints_clean():
    assert lint_paths([os.path.join(ROOT, "seldon_core_tpu_torch")]) == []


def test_the_ports_budget_is_a_cards_memory():
    """``seldon.io/tpu-chips`` budgets the card's memory, not a v5e's."""
    assert graphlint.HBM_PER_CHIP_GB != jgraphlint.HBM_PER_CHIP_GB
    two_resnets = _ens(PORT, _model(PORT, "r1", RESNET),
                       _model(PORT, "r2", RESNET))
    assert lint_graph(two_resnets, {"seldon.io/tpu-chips": "1"}) == []
    graph = _model(PORT, "llm", LLM)
    # 80 GiB of weights fit no card's budget
    from seldon_core_tpu_torch import models

    big = models.ModelSignature(input_shape=(None, None),
                                input_dtype="int32", hbm_bytes=80 << 30)
    models.register_signature("tests.synthetic:Huge", big)
    try:
        graph = _model("tests.synthetic", "h", "Huge")
        graph["parameters"][0]["value"] = "tests.synthetic:Huge"
        (f,) = lint_graph(graph, {"seldon.io/tpu-chips": "1"})
        assert f.code == "GL302" and "79 GiB" in f.message
    finally:
        models.SIGNATURES.pop("tests.synthetic:Huge")


def test_visible_devices_counts_cuda_only_when_torch_is_loaded(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert graphlint._visible_devices() == 3
    monkeypatch.delitem(sys.modules, "torch")
    assert graphlint._visible_devices() == 0
