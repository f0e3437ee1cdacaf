"""The port's operator (``seldon_core_tpu_torch/operator/{spec,crd_schema,
compile,chart}.py``) and its YAML reader against the reference.

The same specs go through both packages: model classes are renamed
``seldon_core_tpu_torch.models`` -> ``seldon_core_tpu.models`` for the
reference, and both outputs are normalised the same way (the
``ENGINE_PREDICTOR`` env decoded, the package name mapped back).  Every
comparison is EQUAL.  The one stated difference is placement on the GPU:
the port asks for ``nvidia.com/gpu`` on an H100 node pool where the
reference asks for ``google.com/tpu`` with its v5e selectors
(:func:`gpu_to_tpu` maps those fields and nothing else), and it ignores
``seldon.io/tpu-topology``, so a 3-device predictor compiles on the port
where the reference raises.
"""

import base64
import copy
import glob
import json
import os

import pytest
import yaml

from seldon_core_tpu.operator import chart as rchart
from seldon_core_tpu.operator import compile as rcompile
from seldon_core_tpu.operator import crd_schema as rschema
from seldon_core_tpu.operator import spec as rspec
from seldon_core_tpu_torch.analysis import GraphAnalysisError
from seldon_core_tpu_torch.operator import chart as pchart
from seldon_core_tpu_torch.operator import compile as pcompile
from seldon_core_tpu_torch.operator import crd_schema as pschema
from seldon_core_tpu_torch.operator import spec as pspec
from seldon_core_tpu_torch.operator.reconcile import crd_manifest
from seldon_core_tpu_torch.utils import analytics, yamlite

REPO = os.path.join(os.path.dirname(__file__), "..")
SPECS = sorted(
    glob.glob(os.path.join(REPO, "examples", "graphs", "*.json"))
    + glob.glob(os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                             "*.json")))
CHARTS = sorted(glob.glob(os.path.join(REPO, "charts", "*", "")))


def spec_id(path: str) -> str:
    return os.path.relpath(path, REPO)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def to_ref(o):
    """The reference's names for the port's model classes."""
    if isinstance(o, dict):
        return {k: to_ref(v) for k, v in o.items()}
    if isinstance(o, list):
        return [to_ref(v) for v in o]
    if isinstance(o, str):
        return o.replace("seldon_core_tpu_torch.", "seldon_core_tpu.")
    return o


def norm(manifests) -> list:
    """Manifests with ``ENGINE_PREDICTOR`` decoded, in the reference's
    names."""
    out = json.loads(json.dumps(manifests))

    def fix(o):
        if isinstance(o, dict):
            if o.get("name") == "ENGINE_PREDICTOR" and "value" in o:
                o["value"] = json.loads(base64.b64decode(o["value"]))
            for v in o.values():
                fix(v)
        elif isinstance(o, list):
            for v in o:
                fix(v)

    fix(out)
    return to_ref(out)


def gpu_to_tpu(manifests: list, dep: dict) -> list:
    """The stated difference, mapped: the port's GPU limit and node
    selector as the reference writes them for the same device count."""
    for m in manifests:
        pod = m.get("spec", {}).get("template", {}).get("spec", {})
        if "nodeSelector" in pod:
            pred = next(p for p in dep["spec"]["predictors"]
                        if m["metadata"]["labels"]["seldon-predictor-id"]
                        == p["name"])
            ann = {**dep.get("metadata", {}).get("annotations", {}),
                   **dep["spec"].get("annotations", {}),
                   **pred.get("annotations", {})}
            assert pod["nodeSelector"] == pcompile.GPU_NODE_SELECTOR
            chips = int(ann["seldon.io/tpu-chips"])
            pod["nodeSelector"] = {
                "cloud.google.com/gke-tpu-accelerator":
                    "tpu-v5-lite-podslice",
                "cloud.google.com/gke-tpu-topology":
                    ann.get("seldon.io/tpu-topology",
                            rcompile.KNOWN_TOPOLOGIES.get(chips)),
            }
        for c in pod.get("containers", []):
            limits = c.get("resources", {}).get("limits", {})
            if "nvidia.com/gpu" in limits:
                limits["google.com/tpu"] = limits.pop("nvidia.com/gpu")
    return manifests


def both_compile(dep: dict):
    """``(reference, port)``: each ``("ok", manifests)`` or ``("error",
    type name, message, findings)``, normalised."""
    out = []
    for comp, spec, d in ((rcompile, rspec, to_ref(dep)),
                          (pcompile, pspec, dep)):
        try:
            ms = comp.compile_deployment(
                spec.SeldonDeployment.from_dict(copy.deepcopy(d)))
        except Exception as e:  # compared across the two packages
            out.append(("error", type(e).__name__, to_ref(str(e)),
                        to_ref([f.to_dict()
                                for f in getattr(e, "findings", [])])))
        else:
            ms = norm(ms)
            if comp is pcompile:
                ms = gpu_to_tpu(ms, dep)
            out.append(("ok", ms))
    return out


def remote_model_uri(dep: dict) -> None:
    """Point the first node with a model_class at a remote artifact."""
    def first(u):
        params = u.get("parameters") or []
        if any(p["name"] == "model_class" for p in params):
            params.append({"name": "model_uri", "value": "gs://bucket/m/v1",
                           "type": "STRING"})
            return True
        return any(first(c) for c in u.get("children") or [])

    assert any(first(p["graph"]) for p in dep["spec"]["predictors"])


POSTURES = {
    "colocated": {},
    "distributed": {"seldon.io/colocate-graph": "false"},
    "chips16-replicas2": {"seldon.io/tpu-chips": "16"},
    "native-workers2": {"seldon.io/native-wire": "true",
                        "seldon.io/engine-workers": "2"},
    "remote-model-uri": {},
}


@pytest.mark.parametrize("posture", list(POSTURES))
@pytest.mark.parametrize("path", SPECS, ids=spec_id)
def test_compile_manifests_equal_the_reference(path, posture):
    dep = load(path)
    dep["spec"].setdefault("annotations", {}).update(POSTURES[posture])
    if posture == "chips16-replicas2":
        for p in dep["spec"]["predictors"]:
            p["replicas"] = 2
    if posture == "remote-model-uri":
        remote_model_uri(dep)
    ref, port = both_compile(dep)
    assert ref[0] == "ok", ref
    assert port == ref


# a COMBINER with one child: GL103, an ERROR finding
BAD_GRAPH = {
    "name": "ens", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
    "children": [{"name": "m", "type": "MODEL", "parameters": [
        {"name": "model_class", "type": "STRING",
         "value": "seldon_core_tpu_torch.models.iris:IrisClassifier"}]}],
}


def bad_deployment(annotations=None) -> dict:
    return {"apiVersion": "machinelearning.seldon.io/v1alpha3",
            "kind": "SeldonDeployment", "metadata": {"name": "d"},
            "spec": {"name": "d", "annotations": annotations or {},
                     "predictors": [{"name": "p", "graph": BAD_GRAPH}]}}


@pytest.mark.parametrize("mode", ["enforce", "warn", "off"])
def test_graphlint_modes_equal_the_reference(mode):
    ref, port = both_compile(bad_deployment(
        {} if mode == "enforce" else {"seldon.io/graphlint": mode}))
    assert port == ref
    if mode == "enforce":
        assert port[:2] == ("error", "GraphAnalysisError")
        assert [f["code"] for f in port[3]
                if f["severity"] == "ERROR"] == ["GL103"]
        assert "p/ens" in port[2]
    else:
        assert port[0] == "ok"


def test_admission_error_carries_findings():
    with pytest.raises(GraphAnalysisError) as ei:
        pcompile.compile_deployment(
            pspec.SeldonDeployment.from_dict(bad_deployment()))
    assert any(f.code == "GL103" for f in ei.value.findings)


def test_topology_is_dropped_on_the_gpu():
    """Stated difference: 3 devices have no v5e topology, so the reference
    refuses the predictor; the port asks for 3 GPUs."""
    dep = load(os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                            "iris.json"))
    dep["spec"]["annotations"]["seldon.io/tpu-chips"] = "3"
    with pytest.raises(ValueError, match="no known v5e topology"):
        rcompile.compile_deployment(
            rspec.SeldonDeployment.from_dict(to_ref(dep)))
    ms = pcompile.compile_deployment(pspec.SeldonDeployment.from_dict(dep))
    pod = ms[0]["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"] == {
        "limits": {"nvidia.com/gpu": "3"}}
    assert pod["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    # the topology annotation changes nothing on the port
    dep["spec"]["annotations"]["seldon.io/tpu-topology"] = "1x3"
    assert pcompile.compile_deployment(
        pspec.SeldonDeployment.from_dict(dep)) == ms


def test_multihost_env_contract_is_the_reference_names():
    # one home for the names: the runtime module that parses them
    from seldon_core_tpu_torch.runtime import multihost

    assert (multihost.ENV_NUM_HOSTS, multihost.ENV_WORKER_ID,
            multihost.ENV_COORDINATOR, multihost.COORDINATOR_PORT) == (
        "NUM_TPU_HOSTS", "TPU_WORKER_ID", "TPU_COORDINATOR_ADDRESS", 8476)


@pytest.mark.parametrize("path", SPECS, ids=spec_id)
def test_spec_round_trips_as_the_reference(path):
    d = load(path)
    port = pspec.SeldonDeployment.from_dict(d)
    ref = rspec.SeldonDeployment.from_dict(to_ref(d))
    assert to_ref(port.to_dict()) == ref.to_dict()
    again = pspec.SeldonDeployment.from_json(json.dumps(port.to_dict()))
    assert again.to_dict() == port.to_dict()


def _invalid(mutate) -> dict:
    d = load(os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                          "iris.json"))
    mutate(d)
    return d


INVALID = {
    "no-name": lambda d: (d["spec"].pop("name"), d["metadata"].pop("name")),
    "no-predictors": lambda d: d["spec"].update(predictors=[]),
    "duplicate-predictor": lambda d: d["spec"]["predictors"].append(
        copy.deepcopy(d["spec"]["predictors"][0])),
    "negative-replicas": lambda d: d["spec"]["predictors"][0].update(
        replicas=-1),
    "duplicate-node": lambda d: d["spec"]["predictors"][0].update(graph={
        "name": "r", "implementation": "SIMPLE_ROUTER", "children": [
            {"name": "a", "implementation": "SIMPLE_MODEL"},
            {"name": "a", "implementation": "SIMPLE_MODEL"}]}),
    "router-without-children": lambda d: d["spec"]["predictors"][0].update(
        graph={"name": "r", "type": "ROUTER"}),
    "unresolvable-node": lambda d: d["spec"]["predictors"][0].update(
        graph={"name": "orphan", "type": "MODEL"}),
    "unknown-implementation": lambda d: d["spec"]["predictors"][0].update(
        graph={"name": "x", "implementation": "FROB"}),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_validate_deployment_messages_equal(case):
    d = _invalid(INVALID[case])
    with pytest.raises(rspec.DeploymentValidationError) as r:
        rspec.validate_deployment(rspec.SeldonDeployment.from_dict(
            to_ref(d)))
    with pytest.raises(pspec.DeploymentValidationError) as p:
        pspec.validate_deployment(pspec.SeldonDeployment.from_dict(d))
    assert str(p.value) == str(r.value)


def test_container_names_and_valid_deployment():
    d = _invalid(lambda d: d["spec"]["predictors"][0].update(
        graph={"name": "c", "type": "MODEL"},
        componentSpecs=[{"spec": {"containers": [{"name": "c"}]}}]))
    pspec.validate_deployment(pspec.SeldonDeployment.from_dict(d))
    assert pspec._container_names(
        pspec.SeldonDeployment.from_dict(d).predictors[0]) == {"c"}


def test_validation_schema_equals_the_reference():
    assert pschema.GRAPH_DEPTH == rschema.GRAPH_DEPTH == 6
    assert pschema.validation_schema() == rschema.validation_schema()


def test_crd_manifest_equals_the_chart_and_the_reference():
    from seldon_core_tpu.operator.reconcile import (
        crd_manifest as ref_crd_manifest,
    )

    assert crd_manifest() == ref_crd_manifest()
    docs = [m for m in pchart.manifests(pchart.default_chart_dir())
            if m["kind"] == "CustomResourceDefinition"]
    assert docs == [crd_manifest()]


@pytest.mark.parametrize("chart", CHARTS, ids=os.path.basename)
@pytest.mark.parametrize("sets", [[], ["namespace=x", "gateway.enabled=false",
                                       "alertmanager.enabled=false",
                                       "load.workers=5"]],
                         ids=["defaults", "overrides"])
def test_chart_renders_equal_the_reference(chart, sets):
    assert pchart.render_chart(chart, sets) == rchart.render_chart(chart,
                                                                   sets)
    assert pchart.manifests(chart, sets) == rchart.manifests(chart, sets)
    assert pchart.load_values(chart, sets) == rchart.load_values(chart, sets)


def test_chart_cli_prints_every_template(capsys):
    pchart.main([])
    out = capsys.readouterr().out
    assert out.count("# Source: ") == len(os.listdir(os.path.join(
        pchart.default_chart_dir(), "templates")))


def _chart_texts():
    for chart in CHARTS:
        for name in sorted(os.listdir(chart)):
            if name.endswith(".yaml"):
                with open(os.path.join(chart, name)) as f:
                    yield os.path.relpath(os.path.join(chart, name),
                                          REPO), f.read()
        for name, text in rchart.render_chart(chart).items():
            yield f"{os.path.relpath(chart, REPO)}/templates/{name}", text


@pytest.mark.parametrize("name,text", list(_chart_texts()),
                         ids=[n for n, _ in _chart_texts()])
def test_yaml_reader_equals_pyyaml_on_every_chart_file(name, text):
    assert list(yamlite.safe_load_all(text)) == list(yaml.safe_load_all(text))


@pytest.mark.parametrize("text", [
    "", "# only a comment\n", "a: 1\n---\n", "---\na: 1",
    "a: |+\n  x\n\n\nb: 2", "a: >-\n  x\n  y\n\n  z\n   w\n  v\n",
    "- - a\n  - b\n- c: d\n  e: f", "a: 'it''s\n  two'\n",
    'a: "x\\\n  \\ y\n\n  z \\u2014"',
    "x: [a, {b: c}, 'd', 1.5, 0x1f, 010, on, ~, 1e5, 1.0e+5, .inf, -1_000]",
    "k: &a {x: 1}\nm: *a", "a:\n- 1\n- 2\nb: x # c\n", "a: b\n  c\n  d",
    "'q': v", "a: 12:30",
], ids=lambda t: repr(t)[:30])
def test_yaml_reader_equals_pyyaml_on_edge_cases(text):
    assert list(yamlite.safe_load_all(text)) == list(yaml.safe_load_all(text))


def test_yaml_reader_refuses_what_it_does_not_cover():
    for text in ("a: !!str x", "d: 2001-12-14", "%YAML 1.1\n---\na: 1"):
        with pytest.raises(yamlite.YamlError):
            list(yamlite.safe_load_all(text))


#: the reference's compile-cache series: the port keeps no compile cache,
#: so its catalog, dashboard and alerts omit them
COMPILE_CACHE_SERIES = ("seldon_compile_cache_enabled",
                        "seldon_compile_cache_hits",
                        "seldon_compile_cache_misses")


def _analytics_configmaps() -> tuple:
    tdir = os.path.join(REPO, "charts", "seldon-core-tpu-analytics",
                        "templates")
    with open(os.path.join(tdir, "prometheus-config.yaml")) as f:
        by_name = {d["metadata"]["name"]: d
                   for d in yamlite.safe_load_all(f.read())}
    with open(os.path.join(tdir, "grafana-dashboard.yaml")) as f:
        dash = next(yamlite.safe_load_all(f.read()))
    return (yamlite.safe_load(by_name["prometheus-config"]["data"]
                              ["prometheus.yml"]),
            yamlite.safe_load(by_name["prometheus-alerts"]["data"]
                              ["alerts.yaml"]),
            json.loads(dash["data"]["seldon-core-tpu.json"]))


def _ported(expr: str) -> bool:
    return not any(s in expr for s in COMPILE_CACHE_SERIES)


def test_analytics_configmaps_match_the_port_generators():
    """The chart's ConfigMaps, read with the port's YAML reader, against
    the port's generators: the scrape config is EQUAL; every alert rule is
    the port's with EQUAL expression, duration and labels (the recompile
    storm's summary names CUDA-graph captures, not XLA compiles); every
    dashboard query is the port's, less the three compile-cache series."""
    scrape, alerts, dash = _analytics_configmaps()
    assert scrape == analytics.prometheus_config()
    ours = {r["alert"]: r for g in analytics.alert_rules()["groups"]
            for r in g["rules"]}
    for g in alerts["groups"]:
        for rule in g["rules"]:
            mine = ours[rule["alert"]]
            assert {k: v for k, v in mine.items() if k != "annotations"} \
                == {k: v for k, v in rule.items() if k != "annotations"}
            if rule["alert"] != "SeldonRecompileStorm":
                assert mine["annotations"] == rule["annotations"]
    chart_exprs = [t["expr"] for p in dash["panels"] for t in p["targets"]]
    ported = [e for e in chart_exprs if _ported(e)]
    left_out = sorted(set(chart_exprs) - set(ported))
    assert all(any(s in e for s in COMPILE_CACHE_SERIES)
               for e in left_out) and any(
        COMPILE_CACHE_SERIES[0] in e for e in left_out)
    port_exprs = {t["expr"] for p in analytics.grafana_dashboard()["panels"]
                  for t in p["targets"]}
    assert set(ported) <= port_exprs, set(ported) - port_exprs


@pytest.mark.parametrize("what", ["prometheus", "alerts"])
def test_analytics_cli_yaml_reads_back(what, capsys):
    """The CLI's scrape config and alerts (JSON, which is YAML) read back
    with the port's reader and PyYAML as the generators' dicts."""
    analytics.main([what])
    text = capsys.readouterr().out
    want = {"prometheus": analytics.prometheus_config,
            "alerts": analytics.alert_rules}[what]()
    assert yamlite.safe_load(text) == want == yaml.safe_load(text)



ADMISSION = [
    ("graph_plan_mode", {"seldon.io/graph-plan": "turbo"}),
    ("prediction_cache_config", {"seldon.io/prediction-cache": "maybe"}),
    ("qos_config", {"seldon.io/slo-p95-ms": "50",
                    "seldon.io/qos-fallback": "nope"}),
    ("qos_config", {"seldon.io/slo-p95-ms": "50",
                    "seldon.io/qos-fallback": "classifier"}),
    ("qos_config", {"seldon.io/slo-p95-ms": "fast"}),
    ("trace_config", {"seldon.io/trace-sample": "2"}),
    ("health_config", {"seldon.io/slo-availability": "1.5"}),
    ("profile_config", {"seldon.io/profile-hz": "0"}),
    ("placement_config", {"seldon.io/mesh": "zz=2"}),
    ("fleet_config", {"seldon.io/fleet-replicas": "3",
                      "seldon.io/fleet-policy": "weighted"}),
    ("fleet_obs_config", {"seldon.io/fleet-obs-concurrency": "0"}),
    ("artifact_config", {"seldon.io/artifacts": "maybe"}),
    ("device_plane_config", {"seldon.io/device-plane": "maybe"}),
]


@pytest.mark.parametrize("fn,ann", ADMISSION,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(ADMISSION)])
def test_admission_hard_stops_equal_the_reference(fn, ann):
    """Every plane's annotation parser rejects at admission with the
    reference's message; without the annotation both answer alike."""
    dep = load(os.path.join(REPO, "seldon_core_tpu_torch", "examples",
                            "iris.json"))
    outs = []
    for comp, spec, d in ((rcompile, rspec, to_ref(dep)),
                          (pcompile, pspec, dep)):
        sd = spec.SeldonDeployment.from_dict(copy.deepcopy(d))
        plain = getattr(comp, fn)(sd, sd.predictors[0])
        sd.annotations.update(ann)
        with pytest.raises(Exception) as ei:
            getattr(comp, fn)(sd, sd.predictors[0])
        outs.append((type(ei.value).__name__, str(ei.value),
                     plain is None, type(plain).__name__))
    assert outs[1] == outs[0]
    assert outs[1][0] == "DeploymentValidationError"
