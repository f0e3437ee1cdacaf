"""The port's artifact plane (``seldon_core_tpu_torch/artifacts/``) against
the reference's on the CPU.

Held to the reference's ``tests/test_artifacts.py`` cases that pass here:
the key invalidation matrix (every field, the runtime identity that
replaces the jaxlib version included, changes the key), tp and dp keys
that never collide, the fingerprint that tracks the params, config
parsing with the reference's messages, runtime drift that forces a live
capture, the ``/admin/artifacts`` body and the OpenAPI document.

A bucket is captured only on the card, so the cold publish, the warm
hydration, the warm-up that skips hydrated buckets and the quarantine of
a corrupt record run here with torch.cuda's capture calls stood in for
(``programs.graphs_on``, ``GraphPool`` and ``capture``: a stand-in graph
whose replay runs the stages eagerly into its static output), as
``tests/test_torch_plan.py`` does.  ``ops/_build.py``'s kernel library
from the store runs with ``nvcc`` and ``dlopen`` stood in for.  The
reference's ``test_compile_cache_stats_counts_monitoring_events`` reads
``jax.monitoring`` and has no counterpart.
"""

import asyncio
import ctypes
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.artifacts import artifact_config_from_annotations as j_cfg
from seldon_core_tpu.artifacts import artifact_key as j_key
from seldon_core_tpu.artifacts.http import artifacts_body as j_body
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import resolve_component as j_resolve
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.artifacts import (
    ArtifactConfig,
    ArtifactPlane,
    InMemoryArtifactStore,
    LocalArtifactStore,
    artifact_config_from_annotations,
    artifact_key,
    runtime_identity,
    segment_fingerprint,
)
from seldon_core_tpu_torch.artifacts import snapshot as registry_snapshot
from seldon_core_tpu_torch.artifacts.http import artifacts_body
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.operator.local import resolve_component
from seldon_core_tpu_torch.ops import _build, launches
from seldon_core_tpu_torch.runtime import programs

NO_BATCH = {"seldon.io/batching": "false"}


def mlp_node(name, seed=0, hidden=32, pkg="seldon_core_tpu_torch"):
    return {"name": name, "type": "MODEL", "parameters": [
        {"name": "model_class", "value": f"{pkg}.models.mlp:MNISTMLP",
         "type": "STRING"},
        {"name": "seed", "value": str(seed), "type": "INT"},
        {"name": "hidden", "value": str(hidden), "type": "INT"}]}


def plane_for(path, **kw) -> ArtifactPlane:
    return ArtifactPlane(ArtifactConfig(enabled=True, store=str(path), **kw))


_JENGINES: dict = {}


def jengine(seed=0):
    """The reference's walk over the same node (its weights)."""
    if seed not in _JENGINES:
        _JENGINES[seed] = JEngine(
            mlp_node("clf", seed=seed, pkg="seldon_core_tpu"),
            resolver=lambda u: j_resolve(u, NO_BATCH), name="p")
    return _JENGINES[seed]


def port_resolver(seed=0):
    """The port's component on the CPU, given the reference component's
    weights (before the plan compiles)."""
    def resolve(unit):
        impl = resolve_component(unit, NO_BATCH, "cpu")
        jparams = jengine(seed).node_impl(unit.name).user.params
        impl.user.params = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams))
        return impl

    return resolve


def engine_for(path, seed=0, plane=None):
    plane = plane if plane is not None else plane_for(path)
    eng = GraphEngine(mlp_node("clf", seed=seed), resolver=port_resolver(seed),
                      name="p", plan_mode="fused", artifacts=plane)
    assert eng.plan is not None
    return eng, plane


XS = [np.linspace(0.0, 1.0, n * 784, dtype=np.float32).reshape(n, 784)
      for n in (1, 4)]


def predict_all(eng):
    outs = []
    for x in XS:
        resp = asyncio.run(eng.predict(SeldonMessage.from_ndarray(x)))
        assert resp.status is None or resp.status.status == "SUCCESS"
        outs.append(resp.to_dict())
    return outs


class _Graph:
    """A captured graph's stand-in: its replay runs the function into the
    static output."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        self.out.copy_(self.fn(*self.inputs))


@pytest.fixture
def graphs(monkeypatch):
    """torch.cuda's capture calls stood in for on the CPU; counts
    captures."""
    n = {"captures": 0}

    def capture(fn, inputs, pool, what, key_desc, select=None):
        n["captures"] += 1
        ref = fn(*inputs)
        out = fn(*inputs).clone()
        g = _Graph(fn, inputs, out)
        g.replay()
        if not programs.bitwise_equal(ref, out):
            raise RuntimeError(f"{what}: {key_desc}: not bitwise equal")
        return programs.Captured(g, inputs, out, launches.Recording())

    monkeypatch.setattr(programs, "graphs_on", lambda device: True)
    monkeypatch.setattr(programs, "GraphPool",
                        lambda device: type("Pool", (), {
                            "bytes": lambda self: 0})())
    monkeypatch.setattr(programs, "capture", capture)
    return n


# ---- key schema --------------------------------------------------------


def test_artifact_key_invalidation_matrix():
    base = dict(segment_fp="fp0", bucket_shape=(4, 784), dtype="float32",
                mesh_spec="", runtime="torch=2;cuda=12")

    def key(**over):
        kw = {**base, **over}
        return artifact_key(kw["segment_fp"], kw["bucket_shape"],
                            kw["dtype"], kw["mesh_spec"], kw["runtime"],
                            format_version=kw.get("format_version", 1),
                            sharding=kw.get("sharding", ""))

    keys = [
        key(),
        key(segment_fp="fp1"),
        key(bucket_shape=(8, 784)),
        key(bucket_shape=(4, 785)),
        key(dtype="bfloat16"),
        key(mesh_spec="dp=2"),
        key(mesh_spec="dp=2,tp=2"),
        key(runtime="torch=2;cuda=13"),
        key(format_version=2),
        key(mesh_spec="dp=2,tp=2", sharding="tp=2"),
        key(mesh_spec="dp=2,tp=2", sharding="dp=2,tp=2"),
    ]
    assert len(set(keys)) == len(keys)
    assert key() == key()
    # the same key material as the reference's, field for field
    assert key() == j_key("fp0", (4, 784), "float32", "", "torch=2;cuda=12",
                          format_version=1)


@pytest.mark.parametrize("field", ["torch", "cuda", "cudnn", "device",
                                   "sms", "kernels"])
def test_every_runtime_field_changes_the_key(monkeypatch, field):
    """The runtime identity holds the torch version, the CUDA toolkit,
    cuDNN's version, the device's name, its SM count and the kernel
    library's source hash: moving any one moves every key."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "H")
    monkeypatch.setattr(_build, "sm_count", lambda d: 132)
    before = runtime_identity("cuda")
    if field == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0")
    elif field == "cuda":
        monkeypatch.setattr(torch.version, "cuda", "0.0")
    elif field == "cudnn":
        monkeypatch.setattr(torch.backends.cudnn, "is_available",
                            lambda: True)
        monkeypatch.setattr(torch.backends.cudnn, "version", lambda: 1)
    elif field == "device":
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: "other card")
    elif field == "sms":
        monkeypatch.setattr(_build, "sm_count", lambda d: 114)
    else:
        monkeypatch.setattr(_build, "source_hash", lambda: "0" * 16)
    after = runtime_identity("cuda")
    assert before != after
    assert artifact_key("fp", (1, 4), "float32", "", before) != \
        artifact_key("fp", (1, 4), "float32", "", after)


def test_artifact_key_tp_vs_dp_never_collide():
    def key(sharding):
        return artifact_key("fp0", (4, 784), "float32", "dp=2,tp=2",
                            "rt", format_version=2, sharding=sharding)

    assert len({key(""), key("dp=2"), key("tp=2"), key("dp=2,tp=2")}) == 4


def test_segment_fingerprint_tracks_params(tmp_path):
    eng0, _ = engine_for(tmp_path / "a", seed=0)
    eng0b, _ = engine_for(tmp_path / "b", seed=0)
    eng1, _ = engine_for(tmp_path / "c", seed=1)
    fp0 = segment_fingerprint(eng0.plan.segments[0])
    assert fp0 == segment_fingerprint(eng0b.plan.segments[0])
    assert fp0 != segment_fingerprint(eng1.plan.segments[0])
    # taken once, when the plan is attached
    assert eng0.plan.segments[0]._artifact_fp == fp0


# ---- config / admission ------------------------------------------------


_CONFIGS = [
    {},
    {"seldon.io/artifact-store": "STORE"},
    {"seldon.io/artifacts": "false", "seldon.io/artifact-store": "STORE"},
    {"seldon.io/artifacts": "true"},
    {"seldon.io/artifacts": "maybe", "seldon.io/artifact-store": "STORE"},
    {"seldon.io/artifact-store": "STORE",
     "seldon.io/artifact-precompile": "no", "seldon.io/artifact-parity": "0",
     "seldon.io/artifact-publish": "off"},
    {"seldon.io/artifact-store": "STORE",
     "seldon.io/artifact-precompile": "sometimes"},
]


@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("ann", _CONFIGS)
def test_artifact_config_parses_like_the_reference(tmp_path, monkeypatch,
                                                   ann, env):
    if env:
        monkeypatch.setenv("SELDON_ARTIFACT_STORE", str(tmp_path))
    else:
        monkeypatch.delenv("SELDON_ARTIFACT_STORE", raising=False)
    ann = {k: v.replace("STORE", str(tmp_path)) for k, v in ann.items()}

    def parse(fn):
        try:
            cfg = fn(ann, "t")
        except ValueError as e:
            return ("error", str(e))
        return None if cfg is None else (
            cfg.enabled, cfg.store, cfg.precompile, cfg.parity, cfg.publish)

    assert parse(artifact_config_from_annotations) == parse(j_cfg)


def test_artifact_config_parsing(tmp_path, monkeypatch):
    monkeypatch.delenv("SELDON_ARTIFACT_STORE", raising=False)
    assert artifact_config_from_annotations({}, "t") is None
    cfg = artifact_config_from_annotations(
        {"seldon.io/artifact-store": str(tmp_path)}, "t")
    assert cfg.enabled and cfg.store == str(tmp_path)
    assert cfg.precompile and cfg.parity and cfg.publish
    with pytest.raises(ValueError):
        artifact_config_from_annotations({"seldon.io/artifacts": "true"}, "t")


def test_deployment_refuses_a_bad_artifact_annotation_at_load(tmp_path):
    from seldon_core_tpu_torch.graph.spec import (
        DeploymentValidationError,
        load_deployment,
    )

    dep = {"metadata": {"name": "bad", "annotations": {
        "seldon.io/artifact-store": str(tmp_path),
        "seldon.io/artifact-precompile": "sometimes"}},
        "spec": {"predictors": [{"name": "p", "graph": mlp_node("clf")}]}}
    with pytest.raises(DeploymentValidationError,
                       match="bad/p: annotation seldon.io/artifact-"
                             "precompile must be a boolean"):
        load_deployment(dep)


# ---- stores ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["local", "memory"])
def test_store_backends_keep_the_reference_contract(tmp_path, kind):
    from seldon_core_tpu.artifacts import InMemoryArtifactStore as JMem
    from seldon_core_tpu.artifacts import LocalArtifactStore as JLocal

    pairs = {"local": (LocalArtifactStore(str(tmp_path / "t")),
                       JLocal(str(tmp_path / "j"))),
             "memory": (InMemoryArtifactStore(), JMem())}[kind]
    seen = []
    for st in pairs:
        assert st.get("fp0123456789abc", "k") is None
        st.put("fp0123456789abc", "k", b"abc", {"key": "k", "n": 1})
        st.put("fp0123456789abc", "k2", b"de", {"key": "k2"})
        got = (st.get("fp0123456789abc", "k"),
               sorted(json.dumps(s, sort_keys=True)
                      for s in st.sidecars("fp0123456789abc")),
               st.stats())
        st.delete("fp0123456789abc", "k")
        seen.append((got, st.get("fp0123456789abc", "k"), st.stats()))
    assert seen[0] == seen[1]
    if kind == "local":
        assert sorted(p.name for p in (tmp_path / "t" / "fp0123456789").
                      iterdir()) == ["k2.bin", "k2.json"]


# ---- warm start (capture stood in for) ---------------------------------


def test_cold_publish_then_warm_hydrate_byte_parity(tmp_path, graphs):
    cold, cold_plane = engine_for(tmp_path)
    cold.plan.warmup()  # precompile: the (1, 784) bucket
    cold_out = predict_all(cold)  # and (4, 784) at first sight
    snap = cold_plane.snapshot()
    assert snap["published"] >= 2 and snap["parityFailures"] == 0
    assert cold_plane.source_tag() == "live"
    assert all(o["meta"]["tags"]["artifact-source"] == "live"
               for o in cold_out)
    captures = graphs["captures"]

    warm, warm_plane = engine_for(tmp_path)
    assert graphs["captures"] == captures + 2  # at boot
    warm_out = predict_all(warm)
    assert graphs["captures"] == captures + 2  # none on the request path
    snap = warm_plane.snapshot()
    assert snap["liveCompiles"] == 0, snap
    assert snap["hydrated"] >= 2
    assert warm_plane.coverage()["coverage"] == 1.0
    assert warm_plane.source_tag() == "aot-cache"
    assert all(o["meta"]["tags"]["artifact-source"] == "aot-cache"
               for o in warm_out)
    seg = warm.plan.segments[0]
    assert not seg.live_compiled
    for a, b in zip(cold_out, warm_out):
        assert a["data"] == b["data"]
        assert a["meta"]["requestPath"] == b["meta"]["requestPath"]
    # and the reference's answers (its walk over the same weights)
    for x, b in zip(XS, warm_out):
        want = jengine().predict_sync(JMessage.from_ndarray(x)).to_dict()
        np.testing.assert_allclose(np.asarray(b["data"]["ndarray"]),
                                   np.asarray(want["data"]["ndarray"]),
                                   atol=1e-5)


def test_warmup_skips_hydrated_buckets(tmp_path, graphs):
    cold, _ = engine_for(tmp_path)
    cold.plan.warmup()

    warm, warm_plane = engine_for(tmp_path)
    before = warm_plane.snapshot()
    assert before["hydrated"] >= 1
    n = graphs["captures"]
    assert warm.plan.warmup() == 0  # every warm-up bucket hydrated
    assert graphs["captures"] == n
    after = warm_plane.snapshot()
    assert after["liveCompiles"] == 0
    assert after["hydrated"] == before["hydrated"]
    assert ((1, 784), "torch.float32") in warm.plan.segments[0].hydrated


@pytest.mark.parametrize("what", ["sidecar-digest", "payload"])
def test_corrupt_record_is_quarantined_and_served_live(tmp_path, graphs,
                                                       what):
    cold, _ = engine_for(tmp_path)
    cold_out = predict_all(cold)
    if what == "sidecar-digest":
        path = sorted(tmp_path.rglob("*.json"))[0]
        sc = json.loads(path.read_text())
        sc["probeDigest"] = "0" * 32
        path.write_text(json.dumps(sc))
    else:
        path = sorted(tmp_path.rglob("*.bin"))[0]
        path.write_bytes(b"not a probe record")

    warm, warm_plane = engine_for(tmp_path)
    snap = warm_plane.snapshot()
    assert snap["quarantined"] == 1, snap
    if what == "sidecar-digest":
        assert snap["parityFailures"] == 1
    else:
        assert snap["deserializeFailures"] == 1
    assert snap["hydrated"] == 1  # the other bucket
    assert not path.exists()  # deleted from the store
    warm_out = predict_all(warm)
    snap = warm_plane.snapshot()
    assert snap["liveCompiles"] == 1  # the quarantined bucket, live
    assert warm_plane.source_tag() == "live"
    for a, b in zip(cold_out, warm_out):
        assert a["data"] == b["data"]
    # self-healing: the live capture published a fresh record
    assert snap["published"] == 1
    assert path.with_suffix(".json").exists()
    fresh, fresh_plane = engine_for(tmp_path)
    assert fresh_plane.snapshot()["hydrated"] == 2
    assert fresh_plane.snapshot()["quarantined"] == 0


def test_runtime_or_mesh_drift_forces_live_capture(tmp_path, graphs):
    cold, _ = engine_for(tmp_path)
    predict_all(cold)

    drifted = plane_for(tmp_path)
    drifted.runtime = "torch=99"
    eng, _ = engine_for(tmp_path, plane=drifted)
    predict_all(eng)
    snap = drifted.snapshot()
    assert snap["hydrated"] == 0
    assert snap["liveCompiles"] >= 2
    assert snap["misses"] >= 2

    meshy = plane_for(tmp_path)
    eng2 = GraphEngine(mlp_node("clf"),
                       resolver=lambda u: resolve_component(u, NO_BATCH,
                                                            "cpu"),
                       name="p", plan_mode="fused")
    meshy.attach_plan(eng2.plan, mesh_spec="dp=2")
    assert meshy.hydrate_plan() == 0


def test_eager_cpu_segments_publish_nothing(tmp_path):
    """Without capture (the CPU), a segment runs eagerly: nothing is
    stored, nothing hydrates, every answer still carries the tag."""
    eng, plane = engine_for(tmp_path)
    outs = predict_all(eng)
    assert plane.snapshot()["published"] == 0
    assert not list(tmp_path.rglob("*.bin"))
    assert all(o["meta"]["tags"]["artifact-source"] == "live"
               for o in outs)


# ---- surfaces ----------------------------------------------------------


def test_artifacts_http_body(tmp_path, graphs):
    assert artifacts_body(None, {}) == j_body(None, {})
    status, payload = artifacts_body(None, {})
    assert status == 404 and "hint" in payload

    cold, plane = engine_for(tmp_path)
    predict_all(cold)
    status, payload = artifacts_body(plane, {})
    assert status == 200
    assert payload["store"] == str(tmp_path)
    assert payload["segments"][0]["stored"] == 2
    assert set(payload["segments"][0]["buckets"]) == {"1x784:float32",
                                                      "4x784:float32"}
    status, payload = artifacts_body(plane, {"coverage": "1"})
    assert status == 200 and set(payload) == {
        "buckets", "hydrated", "liveCompiles", "coverage"}


def test_admin_artifacts_route_and_registry(tmp_path, monkeypatch):
    """``GET /admin/artifacts`` on the runner: 404 with the reference's
    body without a plane, the posture with one; the deployment publishes
    its snapshot provider."""
    import urllib.error
    import urllib.request

    from seldon_core_tpu_torch.operator.local import serve

    monkeypatch.delenv("SELDON_ARTIFACT_STORE", raising=False)
    monkeypatch.setattr(_build, "_artifacts", None)

    def graph(ann):
        return {"metadata": {"name": f"art-{len(ann)}",
                             "annotations": ann},
                "spec": {"predictors": [{"name": "p",
                                         "graph": mlp_node("clf")}]}}

    def get(port, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    async def run(ann):
        server, local = await serve(graph(ann), port=0, host="127.0.0.1",
                                    device="cpu")
        try:
            loop = asyncio.get_running_loop()
            full = await loop.run_in_executor(None, get, server.port,
                                              "/admin/artifacts")
            cov = await loop.run_in_executor(None, get, server.port,
                                             "/admin/artifacts?coverage=1")
            return full, cov, local
        finally:
            await server.stop()

    full, _, _ = asyncio.run(run({}))
    assert full == (404, j_body(None, {})[1])
    ann = {**NO_BATCH, "seldon.io/graph-plan": "fused",
           "seldon.io/artifact-store": str(tmp_path)}
    try:
        full, cov, local = asyncio.run(run(ann))
    finally:
        monkeypatch.setattr(_build, "_artifacts", None)
    assert full[0] == 200 and full[1]["store"] == str(tmp_path)
    assert cov == (200, {"buckets": 0, "hydrated": 0, "liveCompiles": 0,
                         "coverage": 1.0})
    snap = registry_snapshot("art-3")
    assert snap is not None and snap["predictors"][0]["name"] == "p"
    assert local.artifacts is local.predictors[0].artifacts


def test_openapi_documents_admin_artifacts():
    from seldon_core_tpu_torch.serving import openapi

    for spec in (openapi.engine_spec(), openapi.gateway_spec()):
        assert "/admin/artifacts" in spec["paths"]


def test_probe_and_metrics(tmp_path, graphs):
    from seldon_core_tpu_torch.utils.metrics import MetricsRegistry

    reg = MetricsRegistry()
    cfg = ArtifactConfig(enabled=True, store=str(tmp_path))
    plane = ArtifactPlane(cfg, metrics=reg)
    eng, _ = engine_for(tmp_path, plane=plane)
    predict_all(eng)
    sample = plane.probe()()
    assert sample["artifact_store_entries"] >= 2
    assert sample["artifact_live_compiles"] >= 2
    assert sample["artifact_coverage"] == 0.0
    text = reg.render()
    assert "seldon_artifact_publishes_total" in text
    assert "seldon_artifact_store_entries" in text

    warm_plane = ArtifactPlane(cfg, metrics=reg)
    engine_for(tmp_path, plane=warm_plane)
    sample = warm_plane.probe()()
    assert sample["artifact_hydrated"] >= 2
    assert sample["artifact_coverage"] == 1.0
    assert "seldon_artifact_hydrations_total" in reg.render()


# ---- the kernel library ------------------------------------------------


class _Lib:
    """``ctypes.CDLL``'s stand-in: records the path it was given."""

    opened: list = []

    def __init__(self, path):
        _Lib.opened.append(path)

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A fresh build directory, ``dlopen`` recorded, and an ``nvcc`` that
    writes a fake library (counted)."""
    built = []
    _Lib.opened = []

    def compile_(so):
        built.append(so)
        so.write_bytes(b"\x7fELF fake kernel library " + so.name.encode())
        return "fake nvcc log"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", _Lib)
    monkeypatch.setattr(_build, "build_stats", {})
    yield built
    _build.attach_artifacts(None)


def test_kernel_library_miss_builds_and_publishes(tmp_path, no_nvcc):
    plane = plane_for(tmp_path / "store")
    _build.attach_artifacts(plane)
    _build.load()
    assert len(no_nvcc) == 1  # built
    assert plane.library["source"] == "live"
    stored = plane.store.sidecars("kernel-library")
    assert len(stored) == 1 and stored[0]["sha256"] == plane.library["sha256"]


def test_kernel_library_hit_loads_without_nvcc(tmp_path, no_nvcc,
                                              monkeypatch):
    store = tmp_path / "store"
    first = plane_for(store)
    _build.attach_artifacts(first)
    _build.load()
    # a fresh process: no library built here, the store holds one
    for p in (tmp_path / "build").glob("libsck_*"):
        p.unlink()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_compile", lambda so: pytest.fail("nvcc"))
    warm = plane_for(store)
    _build.attach_artifacts(warm)
    _build.load()
    assert _build.build_stats["compiled"] is False
    assert _build.build_stats["store"] == warm.library["store"]
    assert warm.library["source"] == "aot-cache"
    assert _Lib.opened[-1] == _build.build_stats["library"]
    assert (tmp_path / "build").joinpath(
        f"libsck_{_build.source_hash()}.store.so").read_bytes() == \
        (store / "kernel-libra").joinpath(
            f"{warm.library['key']}.bin").read_bytes()


def test_kernel_library_mismatch_is_quarantined_never_loaded(
        tmp_path, no_nvcc, monkeypatch):
    store = tmp_path / "store"
    _build.attach_artifacts(plane_for(store))
    _build.load()
    (blob,) = list((store / "kernel-libra").glob("*.bin"))
    blob.write_bytes(b"tampered")
    monkeypatch.setattr(_build, "_lib", None)
    _Lib.opened = []
    warm = plane_for(store)
    _build.attach_artifacts(warm)
    _build.load()
    assert warm.snapshot()["quarantined"] == 1
    assert all("store.so" not in p for p in _Lib.opened)  # never dlopen'ed
    assert _Lib.opened == [str(tmp_path / "build" /
                               f"libsck_{_build.source_hash()}.so")]
    # the build's library was published again in its place
    assert blob.read_bytes() != b"tampered"
