"""The port's placement plane and sharded fused segments
(``seldon_core_tpu_torch/placement/``, ``graph/plan.py``) against the
reference's on the CPU.

The reference is booted as ``tests/test_placement.py`` boots it
(``LocalDeployment`` on conftest's 8 virtual CPU devices); the port the
same way with ``device="cpu"``, its mesh four or two repeats of the CPU,
and every component given the reference component's weights.

- **Answers.**  iris at dp = 4, MNISTMLP at dp = 4 and tp = 2, the MNIST
  classifier at tp = 2 and dp = 2,tp = 2, over batches of 2, 4, 8 and 64
  rows: the sharded answer is byte-EQUAL to the port's fused and walk
  answers, class ids EQUAL the reference's, probabilities within the
  float32 tolerance of ``tests/test_torch_plan.py`` (1e-5), and
  ``n_sharded_calls`` counts every call a verified bucket served.
- **The gate, on the port's backend.**  iris at dp = 4 and the classifier
  at tp = 2 arm ``verified`` here; stages planted to break the row split
  disarm at the probe, or fail at one bucket, which serves the unsharded
  bytes; a stage that raises on a row block makes the call raise.
- **Surfaces** EQUAL to the reference's for the same deployment:
  ``placement_body`` (the 404 hint, ``?meshes``, segments, ``tpSpans``),
  the registry's snapshot and ``status.placement``, the gauges and
  counters, ``/admin/placement`` through both gateways and the port's
  engine.  The backend's own fields are named where they are left out:
  ``devicesVisible`` (8 virtual devices against
  ``torch.cuda.device_count()``), ``shardedSegments`` (each backend's gate
  verdict: the reference's iris fails its probe on this host's XLA), and
  the mesh registry's keys and device names (``dp=4@cpu``, ``cpu``).
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import LocalDeployment as JLocal
from seldon_core_tpu.operator.spec import SeldonDeployment
from seldon_core_tpu.placement import snapshot as jsnapshot
from seldon_core_tpu.placement import unpublish as junpublish
from seldon_core_tpu.placement.http import placement_body as jbody
from seldon_core_tpu.runtime.batcher import BatcherConfig as JBatcherConfig
from seldon_core_tpu.runtime.batcher import DynamicBatcher as JBatcher
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.graph.spec import load_deployment
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.models import SIGNATURES, ModelSignature
from seldon_core_tpu_torch.operator.local import LocalDeployment
from seldon_core_tpu_torch.parallel.mesh import MeshPlanError, make_mesh
from seldon_core_tpu_torch.placement import (
    PlacementConfig,
    PlacementPlane,
    placement_body,
    placement_config_from_annotations,
    snapshot,
    unpublish,
)
from seldon_core_tpu_torch.runtime.batcher import BatcherConfig, DynamicBatcher
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry

MESH = "seldon.io/mesh"
FUSED = {"seldon.io/graph-plan": "fused"}
IRIS = "iris:IrisClassifier"
MLP = "mlp:MNISTMLP"
CLF = "mlp:MNISTMLPClassifier"
ROWS = (2, 4, 8, 64)


def run(coro):
    return asyncio.run(coro)


def _dep(name, ann, model, node, pkg):
    return {
        "apiVersion": "machinelearning.seldon.io/v1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "annotations": {
            "seldon.io/batching": "false", **ann}},
        "spec": {"predictors": [{
            "name": "p", "replicas": 1,
            "graph": {"name": node, "type": "MODEL", "parameters": [{
                "name": "model_class", "value": f"{pkg}.models.{model}",
                "type": "STRING"}], "children": []},
            "componentSpecs": [],
        }]},
    }


def jboot(name, ann, model, node):
    return JLocal(SeldonDeployment.from_dict(
        _dep(name, ann, model, node, "seldon_core_tpu")))


_JWALK: dict = {}


def jwalk(model, node):
    """The reference's walk deployment of ``model`` (its weights and
    answers)."""
    if (model, node) not in _JWALK:
        _JWALK[(model, node)] = jboot(f"ref-{node}", {}, model, node)
    return _JWALK[(model, node)]


def tboot(name, ann, model, node):
    """The port's deployment on the CPU, every component given the
    reference component's weights before the plan compiles."""
    jh = jwalk(model, node).predictors[0].engine.node_impl(node)
    jh = getattr(jh, "handle", jh)

    def wrap(handle):
        h = getattr(handle, "handle", handle)
        h.user.params = convert.params_from_jax(
            jax.tree.map(np.asarray, jh.user.params))
        return handle

    return LocalDeployment(load_deployment(
        _dep(name, ann, model, node, "seldon_core_tpu_torch")),
        device="cpu", component_wrap=wrap)


def _msg(cls, x, puid="placement-parity"):
    m = cls.from_ndarray(np.asarray(x))
    m.meta.puid = puid
    return m


def tpredict(dep, x) -> dict:
    return run(dep.predictors[0].engine.predict(
        _msg(SeldonMessage, x))).to_dict()


def jpredict(dep, x) -> dict:
    return dep.predictors[0].engine.predict_sync(
        _msg(JMessage, x)).to_dict()


def _batches(features):
    return [np.random.RandomState(i).uniform(size=(n, features)).astype(
        "float32") for i, n in enumerate(ROWS)]


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

CASES = {
    "iris-dp4": (IRIS, "clf", "dp=4", 4),
    "mlp-dp4": (MLP, "mlp", "dp=4", 784),
    "mlp-tp2": (MLP, "mlp", "tp=2", 784),
    "clf-tp2": (CLF, "clf", "tp=2", 784),
    "clf-dp2tp2": (CLF, "clf", "dp=2,tp=2", 784),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_answers_equal_fused_walk_and_reference(case):
    model, node, mesh, features = CASES[case]
    name = f"tpl-{case}"
    sharded = tboot(name, {**FUSED, MESH: mesh}, model, node)
    fused = tboot(f"{name}-fused", FUSED, model, node)
    walk = tboot(f"{name}-walk", {}, model, node)
    try:
        seg = sharded.predictors[0].engine.plan.segments[0]
        assert sharded.placement.sharded_segments == [seg.name]
        assert seg.shard_parity == "verified"
        dp = placement_config_from_annotations({MESH: mesh}).dp
        assert seg.shard_rows == dp
        served = 0
        for x in _batches(features):
            s0 = seg.n_sharded_calls
            a = tpredict(sharded, x)
            assert a == tpredict(fused, x) == tpredict(walk, x)
            ref = jpredict(jwalk(model, node), x)
            got = np.asarray(a["data"]["ndarray"])
            want = np.asarray(ref["data"]["ndarray"])
            if model == CLF:
                assert got.tolist() == want.tolist()
            else:
                np.testing.assert_allclose(got, want, atol=1e-5)
            assert a["data"]["names"] == ref["data"]["names"]
            assert a["meta"]["requestPath"] == ref["meta"]["requestPath"]
            wire = ((len(x), features), "float32")
            verdict = seg.shard_cost_by_bucket.get(wire, {}).get("parity")
            if len(x) % dp == 0:
                assert verdict in ("verified", "failed"), verdict
            else:
                assert verdict is None  # the rows do not split: unsharded
            want_calls = 1 if verdict == "verified" else 0
            assert seg.n_sharded_calls - s0 == want_calls
            served += want_calls
        assert sharded.placement.n_sharded_dispatches == served > 0
    finally:
        unpublish(name)


def test_a_dp_and_a_tp_case_serve_sharded_verified():
    """The verdicts the port reaches on this CPU: iris splits its rows
    over dp = 4 and the classifier its weights over tp = 2, both verified
    at the probe and at every bucket."""
    iris = tboot("tpl-v-iris", {**FUSED, MESH: "dp=4"}, IRIS, "clf")
    clf = tboot("tpl-v-clf", {**FUSED, MESH: "tp=2"}, CLF, "clf")
    try:
        for dep, features in ((iris, 4), (clf, 784)):
            seg = dep.predictors[0].engine.plan.segments[0]
            for x in _batches(features)[1:]:
                tpredict(dep, x)
            assert seg.shard_parity == "verified"
            assert {v["parity"] for v in seg.shard_cost_by_bucket.values()} \
                == {"verified"}
        seg = clf.predictors[0].engine.plan.segments[0]
        assert (seg.shard_tp, seg.shard_slice, seg.shard_label()) == \
            (2, "tp=2", "clf@tp2")
        assert seg.tp_sharded_param_bytes == (784 * 512 + 512
                                              + 512 * 256 + 256) * 4
        assert seg.tp_bytes_per_device == seg.tp_sharded_param_bytes // 2
        seg = iris.predictors[0].engine.plan.segments[0]
        assert (seg.shard_rows, seg.shard_slice, seg.shard_label()) == \
            (4, "dp=4", "clf@dp4")
    finally:
        unpublish("tpl-v-iris")
        unpublish("tpl-v-clf")


def test_dp1_mesh_never_arms():
    dep = tboot("tpl-dp1", {**FUSED, MESH: "dp=1"}, IRIS, "clf")
    try:
        assert dep.placement is not None
        assert dep.placement.sharded_segments == []
        seg = dep.predictors[0].engine.plan.segments[0]
        assert seg.shard_parity is None
        out = tpredict(dep, np.zeros((4, 4), np.float32))
        assert "status" not in out or out["status"]["status"] == "SUCCESS"
    finally:
        unpublish("tpl-dp1")


# ---------------------------------------------------------------------------
# the two-tier gate on planted stages
# ---------------------------------------------------------------------------


class RowCount:
    """Adds the batch's row count: a row block never agrees."""

    device = "cpu"

    def predict_fn(self, X):
        return X.float() + X.shape[0]


class BigBatches:
    """Adds 1 to batches of 32 rows or more: a row block of a big batch
    disagrees, the probe's do not."""

    device = "cpu"

    def predict_fn(self, X):
        return X.float() + float(X.shape[0] >= 32)


class RaisesOn16:
    """Raises on a block of 16 rows (a batch of 64 over dp = 4)."""

    device = "cpu"

    def predict_fn(self, X):
        if X.shape[0] == 16:
            raise RuntimeError("stage failed on a row block")
        return X.float() * 2.0


@pytest.fixture
def planted(monkeypatch):
    """A fused engine over one planted stage on a dp = 4 CPU mesh, and
    a walk engine over the same stage."""
    def build(cls):
        mc = f"tests.test_torch_placement:{cls.__name__}"
        monkeypatch.setitem(SIGNATURES, mc, ModelSignature(
            input_shape=(None, 4), input_dtype="float32", pure_fn=True))
        spec = {"name": "m", "type": "MODEL", "parameters": [{
            "name": "model_class", "value": mc, "type": "STRING"}]}
        obj = cls()
        plane = PlacementPlane(
            PlacementConfig(enabled=True, dp=4),
            mesh=make_mesh(devices=["cpu"] * 4, tp=1))
        fused = GraphEngine(spec, resolver=lambda u: ComponentHandle(
            obj, name="m"), name="p", plan_mode="fused", placement=plane)
        walk = GraphEngine(spec, resolver=lambda u: ComponentHandle(
            obj, name="m"), name="p")
        return fused, walk, fused.plan.segments[0]
    return build


def _same(a, b, x):
    out = [run(e.predict(_msg(SeldonMessage, x))).to_dict() for e in (a, b)]
    assert out[0] == out[1]
    return out[0]


def test_a_stage_whose_blocks_disagree_disarms_at_the_probe(planted):
    fused, walk, seg = planted(RowCount)
    assert seg.shard_parity == "failed"
    assert fused.placement.sharded_segments == []
    assert seg.shard_rows == 1 and seg.shard_slice == ""
    for x in _batches(4):
        _same(fused, walk, x)
    assert seg.n_sharded_calls == 0
    assert "shardRows" not in seg.describe()
    assert seg.describe()["shardParity"] == "failed"


def test_a_bucket_that_differs_serves_the_unsharded_bytes(planted):
    fused, walk, seg = planted(BigBatches)
    assert seg.shard_parity == "verified"
    x8, x64 = _batches(4)[2:]
    out = _same(fused, walk, x8)
    assert seg.n_sharded_calls == 1
    assert out["data"]["ndarray"] == (x8 + 0.0).tolist()
    out = _same(fused, walk, x64)
    assert out["data"]["ndarray"] == (x64.astype(np.float32) + 1.0).tolist()
    assert seg.n_sharded_calls == 1  # the 64-row bucket served unsharded
    costs = seg.shard_cost_by_bucket
    assert costs[((8, 4), "float32")]["parity"] == "verified"
    assert costs[((64, 4), "float32")]["parity"] == "failed"
    assert costs[((64, 4), "float32")]["meshSlice"] == "dp=4"
    _same(fused, walk, x64)  # and for good, without a second gate
    assert seg.n_sharded_calls == 1
    assert seg._shard_buckets[((64, 4), "torch.float32")] is None
    assert fused.placement.n_sharded_dispatches == 1


def test_a_stage_that_raises_on_a_block_raises(planted):
    """Only a parity mismatch retires a bucket: an exception on the
    sharded path reaches the caller (the engine answers it as a failure),
    and the bucket is not retired to the unsharded path."""
    fused, walk, seg = planted(RaisesOn16)
    assert seg.shard_parity == "verified"
    x64 = _batches(4)[3]
    with pytest.raises(RuntimeError, match="row block"):
        seg(x64)
    assert ((64, 4), "torch.float32") not in seg._shard_buckets
    with pytest.raises(RuntimeError, match="row block"):
        seg(x64)
    out = run(fused.predict(_msg(SeldonMessage, x64))).to_dict()
    assert out["status"]["status"] == "FAILURE"
    assert "row block" in out["status"]["info"]
    ok = run(walk.predict(_msg(SeldonMessage, x64))).to_dict()
    assert "status" not in ok or ok["status"]["status"] == "SUCCESS"
    assert seg.n_sharded_calls == 0


# ---------------------------------------------------------------------------
# the batcher's shard_rows
# ---------------------------------------------------------------------------


def test_batcher_shard_rows_rounds_buckets_as_the_reference():
    ref = JBatcher(lambda x: x, JBatcherConfig(
        max_batch_size=32, buckets=[1, 2, 6, 32], shard_rows=4))
    port = DynamicBatcher(lambda x: (x, None), BatcherConfig(
        max_batch_size=32, shard_rows=4))
    port.buckets = [1, 2, 6, 32]
    for rows in range(1, 33):
        assert port.bucket_for(rows) == ref.bucket_for(rows), rows
    assert [port.bucket_for(r) for r in (1, 3, 7)] == [4, 8, 32]
    off = DynamicBatcher(lambda x: (x, None), BatcherConfig(
        max_batch_size=32))
    off.buckets = [1, 2, 6, 32]
    assert off.bucket_for(3) == 6


def test_an_armed_segment_pads_its_batches_to_the_dp_span():
    ann = {**FUSED, MESH: "dp=4", "seldon.io/batching": "true"}
    dep = tboot("tpl-batch", ann, IRIS, "clf")
    try:
        seg = dep.predictors[0].engine.plan.segments[0]
        assert seg.batcher.config.shard_rows == 4
        out = tpredict(dep, np.ones((3, 4), np.float32))
        assert len(out["data"]["ndarray"]) == 3
        assert seg.n_sharded_calls == 1  # 3 rows padded to 4
    finally:
        unpublish("tpl-batch")


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

#: the backend's own fields of a /admin/placement body (module docstring)
BACKEND_FIELDS = ("devicesVisible", "shardedSegments", "meshes")

SURFACE_CASES = {
    "dp=4": (IRIS, "clf"),
    "tp=2": (CLF, "clf"),
    "dp=2,tp=2": (CLF, "clf"),
}


def _both(name, mesh):
    model, node = SURFACE_CASES[mesh]
    ann = {**FUSED, MESH: mesh}
    return jboot(name, ann, model, node), tboot(name, ann, model, node)


def _registry_axes(meshes: dict) -> dict:
    return {k.split("@")[0]: v["axes"] for k, v in meshes.items()}


def _unpublish(name):
    unpublish(name)
    junpublish(name)


def test_disabled_body_equals_the_reference():
    assert placement_body(None, {}) == jbody(None, {})
    status, payload = placement_body(None, {})
    assert status == 404 and "seldon.io/mesh" in payload["hint"]


@pytest.mark.parametrize("mesh", list(SURFACE_CASES))
def test_placement_body_equals_the_reference(mesh):
    name = "tpl-body-" + mesh.replace("=", "").replace(",", "-")
    jdep, tdep = _both(name, mesh)
    try:
        js, jp = jbody(jdep.placement, {})
        ts, tp = placement_body(tdep.placement, {})
        assert js == ts == 200
        assert tp["shardedSegments"] == ["clf"]
        assert tp["devicesVisible"] == torch.cuda.device_count()
        assert _registry_axes(tp["meshes"])[mesh] == \
            _registry_axes(jp["meshes"])[mesh]
        assert tp["meshes"][f"{mesh}@cpu"]["devices"] == ["cpu"] * len(
            jdep.placement.mesh.devices.flat)
        strip = lambda p: {k: v for k, v in p.items()  # noqa: E731
                           if k not in BACKEND_FIELDS}
        assert strip(tp) == strip(jp)
        assert all(s["devices"] for s in tp["segments"])
        if "tp" in mesh:
            assert tp["tpSpans"] == tdep.placement.tp_spans()
            assert [s["source"] for s in tp["segments"]] == ["tp-span"]

        js, jp = jbody(jdep.placement, {"meshes": "1"})
        ts, tp = placement_body(tdep.placement, {"meshes": "1"})
        assert js == ts == 200 and set(tp) == set(jp) == {"meshes"}
    finally:
        _unpublish(name)


@pytest.mark.parametrize("mesh", ["dp=4", "dp=2,tp=2"])
def test_registry_snapshot_equals_the_reference(mesh):
    name = "tpl-reg-" + mesh.replace("=", "").replace(",", "-")
    jdep, tdep = _both(name, mesh)
    try:
        tsnap, jsnap = snapshot(name), jsnapshot(name)
        for snap in (tsnap, jsnap):
            snap["predictors"][0].pop("shardedSegments")
        assert tsnap == jsnap
        pred = tsnap["predictors"][0]
        assert pred["mesh"] == mesh
        assert pred["devices"] == tdep.placement.config.n_devices
        assert all(pred["segments"].values())
    finally:
        _unpublish(name)
    assert snapshot(name) is None and jsnapshot(name) is None


def test_disabled_deployment_stays_unpublished():
    dep = tboot("tpl-off", FUSED, IRIS, "clf")
    assert dep.placement is None
    assert snapshot("tpl-off") is None


def test_status_placement_equals_the_reference():
    from seldon_core_tpu.operator import reconcile as jrec
    from seldon_core_tpu_torch.operator import reconcile as trec

    name = "tpl-status"
    jdep, tdep = _both(name, "dp=2,tp=2")
    try:
        out = []
        for rec, model in ((jrec, "seldon_core_tpu"),
                           (trec, "seldon_core_tpu_torch")):
            cr = _dep(name, {**FUSED, MESH: "dp=2,tp=2"}, CLF, "clf", model)
            cr["metadata"].update(namespace="default", uid="u1",
                                  resourceVersion="1")
            api = rec.FakeKubeApi()
            api.create(cr)
            status = rec.SeldonDeploymentController(api).reconcile(
                api.get("SeldonDeployment", "default", name))
            out.append(status["placement"])
        assert out[1] == snapshot(name)
        assert out[0] == out[1]
        assert out[1]["predictors"][0]["tpSpans"] == {"clf": "dp=2,tp=2"}
    finally:
        _unpublish(name)


def test_gauges_and_counters_equal_the_reference():
    name = "tpl-gauges"
    jdep, tdep = _both(name, "dp=2,tp=2")
    try:
        lines = []
        for dep, reg in ((jdep, JRegistry()), (tdep, MetricsRegistry())):
            plane = dep.placement
            plane.metrics = reg
            plane.deployment = name
            plane.attach_plan(dep.predictors[0].engine.plan)
            plane.placement()
            plane._note_sharded("clf", 8)
            lines.append(sorted(
                ln for ln in reg.render().splitlines()
                if ln.startswith("seldon_placement_")))
        assert lines[0] == lines[1]
        text = "\n".join(lines[1])
        assert f'seldon_placement_tp_spans{{deployment="{name}"}} 1' in text
        assert "seldon_placement_tp_bytes_per_device{" in text
        assert all(f'device="{d}"' in text for d in range(4))
    finally:
        _unpublish(name)


def test_tp_spans_surface():
    name = "tpl-spans"
    jdep, tdep = _both(name, "tp=2")
    try:
        spans = tdep.placement.tp_spans()
        assert spans == jdep.placement.tp_spans()
        (span,) = spans
        assert span["meshSlice"] == "tp=2"
        assert 0 < span["tpBytesPerDevice"] < span["shardedParamBytes"]
        assert span["params"] == {"clf": ["0/b", "0/w", "1/b", "1/w"]}
        seg = tdep.predictors[0].engine.plan.segments[0]
        desc = seg.describe()
        assert desc["tpSpan"] == {k: v for k, v in span.items()
                                  if k != "segment"}
        assert desc["shardParity"] == "verified" and desc["shardRows"] == 1
        assert "shardRanksEager" not in desc  # the ranks share the CPU
        assert snapshot(name)["predictors"][0]["tpSpans"] == {"clf": "tp=2"}
    finally:
        _unpublish(name)


def test_a_mesh_wider_than_the_cards_is_refused():
    cfg = placement_config_from_annotations({MESH: "dp=2"})
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards visible: the mesh fits")
    with pytest.raises(MeshPlanError):
        PlacementPlane(cfg, device="cuda")
    with pytest.raises(MeshPlanError):
        PlacementPlane(cfg, mesh=make_mesh(devices=["cpu"] * 4, tp=2))


def test_one_mesh_per_spec_per_device_kind():
    from seldon_core_tpu_torch.placement import meshes

    cfg = placement_config_from_annotations({MESH: "dp=2,tp=2"})
    m1 = meshes.mesh_for(cfg, device="cpu")
    assert meshes.mesh_for(cfg, device="cpu") is m1
    assert meshes.lookup("dp=2,tp=2", device="cpu") is m1
    assert meshes.registry_stats()["dp=2,tp=2@cpu"] == {
        "axes": {"dp": 2, "pp": 1, "tp": 2}, "devices": ["cpu"] * 4}


# ---------------------------------------------------------------------------
# /admin/placement through both gateways and the port's engine
# ---------------------------------------------------------------------------


def test_admin_placement_over_http_equals_the_reference():
    from aiohttp import web

    from seldon_core_tpu.gateway import app as japp
    from seldon_core_tpu.gateway.store import DeploymentRecord as JRecord
    from seldon_core_tpu.gateway.store import DeploymentStore as JStore
    from seldon_core_tpu_torch.gateway import app as tapp
    from seldon_core_tpu_torch.gateway.store import (
        DeploymentRecord as TRecord,
    )
    from seldon_core_tpu_torch.gateway.store import (
        DeploymentStore as TStore,
    )
    from seldon_core_tpu_torch.serving.client import HttpSession
    from seldon_core_tpu_torch.serving.rest import RestServer

    name = "tpl-http"
    jdep, tdep = _both(name, "tp=2")

    def record(cls):
        return cls(name=name, oauth_key="k", oauth_secret="s",
                   engine_url="http://127.0.0.1:9")

    async def go():
        jstore, tstore = JStore(), TStore()
        jstore.put(record(JRecord))
        tstore.put(record(TRecord))
        jgw = japp.Gateway(jstore, placement=jdep.placement)
        runner = web.AppRunner(jgw.build_app(), access_log=None)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        jurl = f"http://127.0.0.1:{runner.addresses[0][1]}"
        tgw = tapp.Gateway(tstore, placement=tdep.placement)
        tsrv = await tgw.start("127.0.0.1", 0)
        esrv = await RestServer(tdep, host="127.0.0.1", port=0).start()
        http = HttpSession()
        try:
            out = {}
            for query in ("", "?meshes=1"):
                for who, base in (
                        ("ref-gateway", jurl),
                        ("port-gateway", f"http://127.0.0.1:{tsrv.port}"),
                        ("port-engine", f"http://127.0.0.1:{esrv.port}")):
                    st, _, body = await http.request(
                        "GET", f"{base}/admin/placement{query}", b"", {})
                    out[(who, query)] = (st, json.loads(body))
            return out
        finally:
            await http.close()
            await esrv.stop()
            await tgw.close()
            await runner.cleanup()
            await jgw.close()

    try:
        out = run(go())
        for query in ("", "?meshes=1"):
            ref = out[("ref-gateway", query)]
            assert ref[0] == 200
            for who in ("port-gateway", "port-engine"):
                st, body = out[(who, query)]
                assert st == 200
                assert _registry_axes(body["meshes"])["tp=2"] == \
                    _registry_axes(ref[1]["meshes"])["tp=2"]
                strip = {k: v for k, v in body.items()
                         if k not in BACKEND_FIELDS}
                assert strip == {k: v for k, v in ref[1].items()
                                 if k not in BACKEND_FIELDS}, who
        assert out[("port-gateway", "")] == out[("port-engine", "")]
    finally:
        _unpublish(name)


# ---------------------------------------------------------------------------
# the probe and the flight record
# ---------------------------------------------------------------------------


def test_placement_probe_reports_device_bytes():
    from seldon_core_tpu_torch.health import placement_probe

    dep = tboot("tpl-probe", {**FUSED, MESH: "dp=2,tp=2"}, CLF, "clf")
    try:
        reg = MetricsRegistry()
        tpredict(dep, np.zeros((8, 784), np.float32))
        sample = placement_probe(dep.placement, metrics=reg)()
        assert sample["placement_devices"] == 4.0
        assert sample["placement_segments_sharded"] == 1.0
        assert sample["placement_sharded_dispatches"] == 1.0
        seg = dep.predictors[0].engine.plan.segments[0]
        per_rank = seg.rank_param_bytes()
        assert sample["placement_device_bytes_max"] == max(per_rank)
        # each rank holds half the covered bytes and the last layer whole
        last = (256 * 10 + 10) * 4
        assert per_rank == [seg.tp_sharded_param_bytes // 2 + last] * 4
        rendered = reg.render()
        assert "seldon_runtime_placement_device_bytes{" in rendered
        assert all(f'device="{r}"' in rendered for r in range(4))
    finally:
        unpublish("tpl-probe")


def test_flight_records_and_spans_carry_the_mesh():
    ann = {**FUSED, MESH: "dp=4", "seldon.io/health": "true",
           "seldon.io/tracing": "true"}
    dep = tboot("tpl-flight", ann, IRIS, "clf")
    try:
        eng = dep.predictors[0].engine
        out = tpredict(dep, np.ones((4, 4), np.float32))
        rec = dep.health.recorder.get(out["meta"]["puid"])
        assert rec["flags"]["mesh"] == "dp=4"

        def spans(d):
            yield d
            for c in d["children"]:
                yield from spans(c)

        span = eng.tracer.get(out["meta"]["puid"]).to_dict()
        seg_spans = [c for c in spans(span) if c["kind"] == "FUSED_SEGMENT"]
        assert seg_spans and seg_spans[0]["attributes"]["mesh"] == "dp=4"
        assert seg_spans[0]["attributes"]["sharded"] is True
    finally:
        unpublish("tpl-flight")
