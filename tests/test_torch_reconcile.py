"""The port's reconcile loop (``seldon_core_tpu_torch/operator/
reconcile.py``) against the reference's, on the fake apiserver.

Every scenario runs on both packages: the cases of ``tests/test_reconcile
.py``, ``TestReconcileFleet`` of ``tests/test_fleet.py``, the reconcile
cases of ``tests/test_qos.py`` (``status.qos``) and the admission lint's
``status.analysis``.  The scenario's own assertions hold on each, and the
two fake apiservers end EQUAL: every object, status and action, after the
same normalisation as ``tests/test_torch_operator.py`` (model classes in
the reference's names, ``ENGINE_PREDICTOR`` decoded, the GPU limit and
selector mapped to the reference's TPU fields, and the spec-hash
annotation, a hash over those fields, dropped).  Autoscale decisions are
EQUAL under one FakeClock.
"""

import asyncio
import base64
import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest

NS = "default"


def pkg(port: bool) -> SimpleNamespace:
    """One package's operator surface and model-class prefix."""
    if port:
        from seldon_core_tpu_torch.fleet import Autoscaler
        from seldon_core_tpu_torch.fleet import registry as fleet_registry
        from seldon_core_tpu_torch.fleet.config import (
            fleet_config_from_annotations,
        )
        from seldon_core_tpu_torch.operator import reconcile as r
        from seldon_core_tpu_torch.qos import registry as qos_registry
        prefix = "seldon_core_tpu_torch"
    else:
        from seldon_core_tpu.fleet import Autoscaler
        from seldon_core_tpu.fleet import registry as fleet_registry
        from seldon_core_tpu.fleet.config import (
            fleet_config_from_annotations,
        )
        from seldon_core_tpu.operator import reconcile as r
        from seldon_core_tpu.qos import registry as qos_registry
        prefix = "seldon_core_tpu"
    return SimpleNamespace(
        port=port, r=r, FakeKubeApi=r.FakeKubeApi,
        Controller=r.SeldonDeploymentController,
        Watcher=r.SeldonDeploymentWatcher, fleet_registry=fleet_registry,
        qos_registry=qos_registry, Autoscaler=Autoscaler,
        fleet_config=fleet_config_from_annotations,
        iris=f"{prefix}.models.iris:IrisClassifier",
        mlp=f"{prefix}.models.mlp:MNISTMLP")


def make_cr(p, name="iris-dep", replicas=1, predictor="main",
            annotations=None):
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha3",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "namespace": NS,
                     "annotations": dict(annotations or {})},
        "spec": {"name": name, "predictors": [{
            "name": predictor, "replicas": replicas,
            "graph": {"name": "classifier", "type": "MODEL",
                      "parameters": [{"name": "model_class",
                                      "value": p.iris, "type": "STRING"}]},
        }]},
    }


def _ref_names(o):
    if isinstance(o, dict):
        if o.get("name") == "ENGINE_PREDICTOR" and "value" in o:
            o = {**o, "value": json.loads(base64.b64decode(o["value"]))}
        return {k: _ref_names(v) for k, v in o.items()
                if k != "seldon.io/spec-hash"}
    if isinstance(o, list):
        return [_ref_names(v) for v in o]
    if isinstance(o, str):
        return o.replace("seldon_core_tpu_torch.", "seldon_core_tpu.")
    return o


def _tpu_fields(obj: dict) -> dict:
    pod = obj.get("spec", {}).get("template", {}).get("spec", {})
    if pod.get("nodeSelector") == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}:
        pod["nodeSelector"] = {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
            "cloud.google.com/gke-tpu-topology": "4x4"}  # 16 devices
    for c in pod.get("containers", []):
        limits = c.get("resources", {}).get("limits", {})
        if "nvidia.com/gpu" in limits:
            limits["google.com/tpu"] = limits.pop("nvidia.com/gpu")
    return obj


def state(api) -> dict:
    return {"objects": {k: _tpu_fields(_ref_names(v))
                        for k, v in sorted(api._objs.items())},
            "actions": list(api.actions)}


def both(scenario):
    """Run ``scenario(pkg)`` on the reference, then the port; the fake
    apiservers must end EQUAL.  Returns the port's result."""
    out = {}
    for port in (False, True):
        p = pkg(port)
        out[port] = scenario(p)
    (ref_api, ref_res), (port_api, port_res) = out[False], out[True]
    assert state(port_api) == state(ref_api)
    assert _ref_names(port_res) == _ref_names(ref_res)
    return port_api, port_res


def boot(p):
    api = p.FakeKubeApi()
    return api, p.Watcher(api, namespace=NS)


# -- the cases of tests/test_reconcile.py ----------------------------------

def test_crd_registration_idempotent():
    def scenario(p):
        api = p.FakeKubeApi()
        first, second = p.r.ensure_crd(api), p.r.ensure_crd(api)
        assert (first, second) == (True, False)
        crd = api.get("CustomResourceDefinition", "",
                      "seldondeployments.machinelearning.seldon.io")
        assert crd["spec"]["names"]["shortNames"] == ["sdep"]
        assert crd["spec"]["versions"][0]["subresources"] == {"status": {}}
        return api, crd
    both(scenario)


def test_create_flow_creates_owned_resources_and_status():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p))
        actions = watcher.run_once()
        assert actions == {"iris-dep": "reconciled"}
        deployments = api.list("Deployment", NS)
        services = api.list("Service", NS)
        assert [d["metadata"]["name"] for d in deployments] == [
            "iris-dep-main"]
        assert services
        for obj in deployments + services:
            assert obj["metadata"]["labels"]["seldon-deployment-id"] == \
                "iris-dep"
            refs = obj["metadata"]["ownerReferences"]
            assert refs[0]["kind"] == "SeldonDeployment" and refs[0]["uid"]
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        assert cr["status"]["state"] == "Creating"
        assert cr["status"]["predictorStatus"] == [
            {"name": "main", "replicas": 1, "replicasAvailable": 0}]
        return api, actions
    both(scenario)


def test_replica_availability_flows_into_status():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p, replicas=2))
        watcher.run_once()
        api.set_workload_available(NS, "iris-dep-main", 1)
        watcher.run_once()
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        assert cr["status"]["state"] == "Creating"
        assert cr["status"]["predictorStatus"][0]["replicasAvailable"] == 1
        api.set_workload_available(NS, "iris-dep-main", 2)
        watcher.run_once()
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        assert cr["status"]["state"] == "Available"
        return api, cr["status"]
    both(scenario)


def test_unchanged_cr_causes_no_writes():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p))
        watcher.run_once()
        api.set_workload_available(NS, "iris-dep-main", 1)
        watcher.run_once()
        before = list(api.actions)
        watcher.run_once()
        watcher.run_once()
        assert api.actions[len(before):] == []
        return api, None
    both(scenario)


def test_spec_change_updates_workload():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p, replicas=1))
        watcher.run_once()
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        cr["spec"]["predictors"][0]["replicas"] = 3
        api.update(cr)
        watcher.run_once()
        assert api.get("Deployment", NS, "iris-dep-main")["spec"][
            "replicas"] == 3
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        assert cr["status"]["predictorStatus"][0]["replicas"] == 3
        return api, None
    both(scenario)


def test_renamed_predictor_prunes_orphan_workload():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p, predictor="main"))
        watcher.run_once()
        assert api.get("Deployment", NS, "iris-dep-main") is not None
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        cr["spec"]["predictors"][0]["name"] = "canary"
        api.update(cr)
        watcher.run_once()
        assert api.get("Deployment", NS, "iris-dep-main") is None
        assert api.get("Deployment", NS, "iris-dep-canary") is not None
        return api, None
    both(scenario)


def test_invalid_cr_writes_failed_status():
    def scenario(p):
        api, watcher = boot(p)
        bad = make_cr(p)
        bad["spec"]["predictors"][0]["graph"] = {"name": "orphan",
                                                 "type": "MODEL"}
        api.create(bad)
        watcher.run_once()
        cr = api.get("SeldonDeployment", NS, "iris-dep")
        assert cr["status"]["state"] == "Failed"
        assert cr["status"]["description"]
        assert api.list("Deployment", NS) == []
        return api, cr["status"]
    both(scenario)


def test_persistently_failing_cr_does_not_churn_status():
    def scenario(p):
        api, watcher = boot(p)
        bad = make_cr(p)
        bad["spec"]["predictors"][0]["graph"] = {"name": "orphan",
                                                 "type": "MODEL"}
        api.create(bad)
        watcher.run_once()
        before = list(api.actions)
        watcher.run_once()
        watcher.run_once()
        assert api.actions[len(before):] == []
        return api, None
    both(scenario)


def test_deleted_cr_prunes_owned_resources():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p))
        watcher.run_once()
        assert api.list("Deployment", NS) and api.list("Service", NS)
        api.delete("SeldonDeployment", NS, "iris-dep")
        actions = watcher.run_once()
        assert actions == {"iris-dep": "pruned"}
        assert api.list("Deployment", NS) == api.list("Service", NS) == []
        return api, actions
    both(scenario)


def test_two_deployments_are_isolated():
    def scenario(p):
        api, watcher = boot(p)
        api.create(make_cr(p, name="dep-a"))
        api.create(make_cr(p, name="dep-b"))
        watcher.run_once()
        assert len(api.list("Deployment", NS)) == 2
        api.delete("SeldonDeployment", NS, "dep-a")
        watcher.run_once()
        assert [d["metadata"]["name"] for d in
                api.list("Deployment", NS)] == ["dep-b-main"]
        return api, None
    both(scenario)


def test_controller_reconcile_is_idempotent():
    def scenario(p):
        api = p.FakeKubeApi()
        ctl = p.Controller(api)
        status = ctl.reconcile(api.create(make_cr(p)))
        before = list(api.actions)
        ctl.reconcile(api.get("SeldonDeployment", NS, "iris-dep"))
        assert [a for a in api.actions[len(before):]
                if a[0] in ("create", "update", "delete")] == []
        return api, status
    both(scenario)


def test_multihost_statefulset_status_aggregates():
    def scenario(p):
        api, watcher = boot(p)
        cr = make_cr(p, name="llm", replicas=2)
        cr["spec"]["predictors"][0]["annotations"] = {
            "seldon.io/tpu-chips": "16"}
        api.create(cr)
        watcher.run_once()
        names = sorted(s["metadata"]["name"]
                       for s in api.list("StatefulSet", NS))
        assert names == ["llm-main-r0", "llm-main-r1"]
        assert api.get("SeldonDeployment", NS, "llm")["status"][
            "state"] == "Creating"
        for n in names:
            api.set_workload_available(NS, n, 2)
        watcher.run_once()
        status = api.get("SeldonDeployment", NS, "llm")["status"]
        assert status["state"] == "Available"
        assert status["predictorStatus"][0]["replicasAvailable"] == 4
        return api, status
    api, _ = both(scenario)
    sts = api.get("StatefulSet", NS, "llm-main-r0")
    container = sts["spec"]["template"]["spec"]["containers"][0]
    assert container["resources"] == {"limits": {"nvidia.com/gpu": "8"}}


def test_stale_hash_triggers_update_but_fresh_does_not():
    def scenario(p):
        api = p.FakeKubeApi()
        ctl = p.Controller(api)
        ctl.reconcile(api.create(make_cr(p)))
        d = api.get("Deployment", NS, "iris-dep-main")
        assert d["metadata"]["annotations"]["seldon.io/spec-hash"]
        d["spec"]["progressDeadlineSeconds"] = 600
        api.update(d)
        before = list(api.actions)
        ctl.reconcile(api.get("SeldonDeployment", NS, "iris-dep"))
        assert [a for a in api.actions[len(before):]
                if a[0] != "patch_status"] == []
        return api, None
    both(scenario)


def test_crd_manifest_round_trips_json():
    from seldon_core_tpu.operator.reconcile import crd_manifest as ref
    from seldon_core_tpu_torch.operator.reconcile import crd_manifest

    assert json.loads(json.dumps(crd_manifest())) == ref()


def _validate(instance):
    """The structural-schema checker of ``tests/test_reconcile.py`` over
    the port's schema."""
    from seldon_core_tpu_torch.operator.crd_schema import validation_schema

    def walk(schema, val, path="$"):
        t = schema.get("type")
        if t == "object":
            if not isinstance(val, dict):
                raise AssertionError(f"{path}: not an object")
            if schema.get("x-kubernetes-preserve-unknown-fields"):
                return
            for req in schema.get("required", []):
                if req not in val:
                    raise AssertionError(f"{path}: missing {req}")
            props = schema.get("properties", {})
            addl = schema.get("additionalProperties")
            for k, v in val.items():
                if k in props:
                    walk(props[k], v, f"{path}.{k}")
                elif isinstance(addl, dict):
                    walk(addl, v, f"{path}.{k}")
                elif path == "$" and k in ("apiVersion", "kind", "metadata"):
                    continue
                else:
                    raise AssertionError(f"{path}.{k}: would be pruned")
        elif t == "array":
            if not isinstance(val, list):
                raise AssertionError(f"{path}: not an array")
            if "minItems" in schema and len(val) < schema["minItems"]:
                raise AssertionError(f"{path}: fewer than minItems")
            for i, v in enumerate(val):
                walk(schema["items"], v, f"{path}[{i}]")
        elif t == "string":
            if not isinstance(val, str):
                raise AssertionError(f"{path}: not a string")
            if "enum" in schema and val not in schema["enum"]:
                raise AssertionError(f"{path}: {val!r} not in enum")
        elif t == "integer":
            if not isinstance(val, int) or isinstance(val, bool):
                raise AssertionError(f"{path}: not an integer")
            if "minimum" in schema and val < schema["minimum"]:
                raise AssertionError(f"{path}: below minimum")

    walk(validation_schema(), instance)


class TestCrdValidationSchema:
    def test_every_example_graph_validates(self):
        import glob
        import os

        root = os.path.join(os.path.dirname(__file__), "..")
        for path in sorted(
                glob.glob(os.path.join(root, "examples", "graphs", "*.json"))
                + glob.glob(os.path.join(root, "seldon_core_tpu_torch",
                                         "examples", "*.json"))):
            with open(path) as f:
                _validate(json.load(f))

    def test_malformed_resources_rejected(self):
        good = make_cr(pkg(True))
        _validate(good)
        for mutate, match in (
                (lambda c: c["spec"].update(predictors=[]), "minItems"),
                (lambda c: c["spec"]["predictors"][0]["graph"].update(
                    type="FROBNICATOR"), "enum"),
                (lambda c: c["spec"]["predictors"][0].pop("graph"),
                 "missing graph"),
                (lambda c: c["spec"]["predictors"][0].update(replicas=-1),
                 "minimum")):
            bad = copy.deepcopy(good)
            mutate(bad)
            with pytest.raises(AssertionError, match=match):
                _validate(bad)

    def test_deep_graphs_stay_open(self):
        from seldon_core_tpu_torch.operator.crd_schema import GRAPH_DEPTH

        cr = make_cr(pkg(True))
        node = cr["spec"]["predictors"][0]["graph"]
        for i in range(GRAPH_DEPTH + 3):
            child = {"name": f"n{i}", "type": "MODEL",
                     "implementation": "SIMPLE_MODEL"}
            node["children"] = [child]
            node = child
        _validate(cr)


def test_endpoint_camelcase_aliases_not_pruned():
    cr = make_cr(pkg(True))
    cr["spec"]["predictors"][0]["graph"]["endpoint"] = {
        "serviceHost": "my-model", "servicePort": 9000, "type": "REST"}
    _validate(cr)


# -- status.fleet and the autoscale loop (tests/test_fleet.py) -------------

class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


FLEET = {"seldon.io/fleet-replicas": "1", "seldon.io/fleet-autoscale": "true",
         "seldon.io/fleet-max-replicas": "3",
         "seldon.io/fleet-cooldown-s": "30"}


class TestReconcileFleet:
    def test_status_fleet_and_autoscale_patch(self):
        def scenario(p):
            api, watcher = boot(p)
            api.create(make_cr(p, annotations={
                **FLEET, "seldon.io/fleet-cooldown-s": "0"}))
            p.fleet_registry.publish("iris-dep", lambda: {
                "deployment": "iris-dep",
                "signals": {"demandRps": 20.0, "capacityRps": 10.0}})
            try:
                watcher.run_once()
                fleet = api.get("SeldonDeployment", NS,
                                "iris-dep")["status"]["fleet"]
                assert fleet["signals"]["demandRps"] == 20.0
                decision = fleet["autoscale"]["main"]
                assert (decision["desired"], decision["current"]) == (3, 1)
                assert api.get("Deployment", NS, "iris-dep-main")["spec"][
                    "replicas"] == 3
                watcher.run_once()  # the hash guard must not revert it
                assert api.get("Deployment", NS, "iris-dep-main")["spec"][
                    "replicas"] == 3
            finally:
                p.fleet_registry.unpublish("iris-dep")
            return api, fleet
        both(scenario)

    def test_no_fleet_published_no_status_block(self):
        def scenario(p):
            api, watcher = boot(p)
            api.create(make_cr(p))
            watcher.run_once()
            status = api.get("SeldonDeployment", NS, "iris-dep")["status"]
            assert "fleet" not in status
            return api, status
        both(scenario)

    def test_autoscale_decisions_equal_under_one_clock(self):
        """Up past the demand, held by the cooldown, then down once it has
        passed: the same decisions and workload patches on both."""
        signals = [(20.0, 10.0, 0.0), (20.0, 10.0, 5.0), (1.0, 10.0, 10.0),
                   (1.0, 10.0, 45.0), (1.0, 10.0, 50.0)]

        def scenario(p):
            api = p.FakeKubeApi()
            ctl = p.Controller(api)
            cr = api.create(make_cr(p, annotations=FLEET))
            clock = FakeClock()
            cfg = p.fleet_config(FLEET, "iris-dep/main")
            ctl._autoscalers["iris-dep/main"] = (
                cfg, p.Autoscaler(cfg, clock=clock))
            seen = []
            box = {}
            p.fleet_registry.publish("iris-dep", lambda: {
                "deployment": "iris-dep", "signals": dict(box)})
            try:
                for demand, capacity, at in signals:
                    clock.t = 1000.0 + at
                    box.update(demandRps=demand, capacityRps=capacity)
                    status = ctl.reconcile(
                        api.get("SeldonDeployment", NS, "iris-dep") or cr)
                    seen.append((status["fleet"]["autoscale"]["main"],
                                 api.get("Deployment", NS, "iris-dep-main")
                                 ["spec"]["replicas"]))
            finally:
                p.fleet_registry.unpublish("iris-dep")
            return api, seen
        _, seen = both(scenario)
        replicas = [n for _, n in seen]
        assert replicas[0] == 3 and replicas[-1] < 3


# -- status.qos (tests/test_qos.py) and status.analysis --------------------

def _mlp_cr(p, name, annotations=None):
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha3",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "namespace": NS, "uid": "u1",
                     "resourceVersion": "1"},
        "spec": {"annotations": dict(annotations or {}), "predictors": [{
            "name": "main", "graph": {
                "name": "m", "type": "MODEL", "parameters": [
                    {"name": "model_class", "value": p.mlp,
                     "type": "STRING"},
                    {"name": "hidden", "value": "8", "type": "INT"}]}}]},
    }


class TestStatusQos:
    def test_status_gains_qos_block_from_live_runtime(self):
        from seldon_core_tpu_torch.graph.spec import load_deployment
        from seldon_core_tpu_torch.operator.local import LocalDeployment

        p = pkg(True)
        p.qos_registry.clear()
        cr = _mlp_cr(p, "qd", {"seldon.io/slo-p95-ms": "50",
                               "seldon.io/batching": "false"})
        local = LocalDeployment(load_deployment(cr), device="cpu")
        try:
            assert local.predictors[0].qos is not None
            api = p.FakeKubeApi()
            api.create(cr)
            status = p.Controller(api).reconcile(
                api.get("SeldonDeployment", NS, "qd"))
            pred = status["qos"]["predictors"][0]
            assert pred["name"] == "main"
            assert pred["admission"]["limit"] > 0
            assert "shedLevel" in pred
            assert "placement" not in status  # nothing publishes it yet
        finally:
            p.qos_registry.clear()

    def test_status_omits_qos_without_runtime(self):
        def scenario(p):
            p.qos_registry.clear()
            api = p.FakeKubeApi()
            api.create(_mlp_cr(p, "plain"))
            status = p.Controller(api).reconcile(
                api.get("SeldonDeployment", NS, "plain"))
            assert "qos" not in status
            return api, status
        both(scenario)


def test_reconcile_surfaces_lint_findings_in_status():
    def scenario(p):
        api = p.FakeKubeApi()
        cr = _mlp_cr(p, "d")
        cr["spec"]["predictors"][0]["graph"] = {
            "name": "ens", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [cr["spec"]["predictors"][0]["graph"]]}
        api.create(cr)
        status = p.Controller(api).reconcile(cr)
        assert status["state"] == "Failed"
        assert "GL103" in status["description"]
        assert status["analysis"][0]["code"] == "GL103"
        assert status["analysis"][0]["path"] == "main/ens"
        live = api.get("SeldonDeployment", NS, "d")
        assert live["status"]["analysis"][0]["code"] == "GL103"
        return api, status
    both(scenario)


def test_placement_registry_feeds_status():
    from seldon_core_tpu_torch import placement

    p = pkg(True)
    api = p.FakeKubeApi()
    api.create(make_cr(p))
    placement.publish("iris-dep", lambda: {"mesh": {"dp": 1}})
    try:
        status = p.Controller(api).reconcile(
            api.get("SeldonDeployment", NS, "iris-dep"))
        assert status["placement"] == {"mesh": {"dp": 1}}
        placement.publish("iris-dep", lambda: 1 / 0)
        assert placement.snapshot("iris-dep") is None
    finally:
        placement.clear()
    assert placement.snapshot("iris-dep") is None


def test_health_server_answers_probes():
    from seldon_core_tpu_torch.operator.reconcile import (
        _start_health_server,
    )
    from seldon_core_tpu_torch.serving.client import HttpSession
    import asyncio
    import socket

    p = pkg(True)
    watcher = p.Watcher(p.FakeKubeApi(), interval=0.05).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = _start_health_server(port, watcher)

    async def probe():
        sess = HttpSession()
        try:
            return [(await sess.request("GET", f"http://127.0.0.1:{port}"
                                        f"{path}"))[0]
                    for path in ("/ready", "/live", "/nope")]
        finally:
            await sess.close()
    try:
        assert asyncio.run(probe()) == [200, 200, 404]
    finally:
        srv.shutdown()
        watcher.stop()
    assert _start_health_server(0, watcher) is None


def test_http_kube_api_paths():
    from seldon_core_tpu.operator.reconcile import HttpKubeApi as Ref
    from seldon_core_tpu_torch.operator.reconcile import HttpKubeApi

    ours, ref = (HttpKubeApi("https://k:6443/", token="t"),
                 Ref("https://k:6443/", token="t"))
    for args in (("Deployment", NS, "x"), ("Service", NS),
                 ("SeldonDeployment", NS, "x", "status"),
                 ("CustomResourceDefinition", "", "y"),
                 ("StatefulSet", "", "")):
        assert ours._url(*args) == ref._url(*args)
    assert np.all([ours.token == "t", ours.base_url == "https://k:6443"])


# -- the engine boots from its own compiled manifest -----------------------

def test_compiled_manifest_env_alone_boots_the_engine(tmp_path):
    """The engine container's env of a compiled iris manifest, and
    nothing else (no ``--graph``), boots ``python -m
    seldon_core_tpu_torch.operator.local --device cpu``; its answer is
    EQUAL to the in-process graph's, and ``ENGINE_MAX_LIFETIME_S`` ends
    it on its own."""
    import os
    import socket
    import subprocess
    import sys
    import urllib.request

    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator.compile import compile_deployment
    from seldon_core_tpu_torch.operator.local import LocalDeployment
    from seldon_core_tpu_torch.operator.spec import SeldonDeployment

    root = os.path.join(os.path.dirname(__file__), "..")
    iris = os.path.join(root, "seldon_core_tpu_torch", "examples",
                        "iris.json")
    with open(iris) as f:
        dep = json.load(f)
    manifests = compile_deployment(SeldonDeployment.from_dict(dep))
    container = manifests[0]["spec"]["template"]["spec"]["containers"][0]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ENGINE_", "SELDON_"))}
    env.update({e["name"]: e["value"] for e in container["env"]})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env.update(ENGINE_SERVER_PORT=str(port), ENGINE_SERVER_GRPC_PORT="0",
               ENGINE_MAX_LIFETIME_S="3")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.operator.local",
         "--device", "cpu", "--host", "127.0.0.1"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        while line and "serving deployment" not in line:
            line = proc.stdout.readline()
        assert f"serving deployment {dep['spec']['name']!r}" in line, line
        body = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2],
                                     [6.2, 2.9, 4.3, 1.3]]}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v0.1/predictions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            served = json.loads(resp.read())
        assert proc.wait(timeout=30) == 0  # the lifetime bound ended it
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    local = LocalDeployment(load_deployment(iris), device="cpu")
    from seldon_core_tpu_torch.messages import SeldonMessage

    ref = asyncio.run(local.predict(SeldonMessage.from_dict(body)))
    asyncio.run(local.aclose())
    assert served["data"] == ref.to_dict()["data"]


def test_engine_without_graph_or_env_exits_with_the_reference_message():
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ENGINE_")}
    out = subprocess.run(
        [sys.executable, "-m", "seldon_core_tpu_torch.operator.local",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=120, cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.returncode == 1
    assert "need --graph or ENGINE_PREDICTOR env" in out.stderr


def test_engine_flags_default_from_the_compiled_env(monkeypatch):
    from seldon_core_tpu_torch.operator.local import (
        build_parser,
        graph_from_env,
    )

    for name, value in (("ENGINE_SERVER_PORT", "8123"),
                        ("ENGINE_SERVER_GRPC_PORT", "5123"),
                        ("ENGINE_NATIVE_PORT", "8555"),
                        ("ENGINE_NATIVE_GRPC_PORT", "5555"),
                        ("ENGINE_WORKERS", "2"),
                        ("ENGINE_MAX_LIFETIME_S", "9.5")):
        monkeypatch.setenv(name, value)
    a = build_parser().parse_args([])
    assert (a.graph, a.port, a.grpc_port, a.native_port, a.native_grpc_port,
            a.workers, a.max_lifetime_s, a.device) == (
        None, 8123, 5123, 8555, 5555, 2, 9.5, None)
    pred = {"name": "main", "graph": {"name": "m",
                                      "implementation": "SIMPLE_MODEL"}}
    monkeypatch.setenv("ENGINE_PREDICTOR", base64.b64encode(
        json.dumps(pred).encode()).decode())
    monkeypatch.setenv("SELDON_DEPLOYMENT_ID", "d9")
    assert graph_from_env() == {"spec": {"name": "d9",
                                         "predictors": [pred]}}
