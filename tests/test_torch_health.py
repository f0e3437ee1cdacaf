"""The port's health plane (``seldon_core_tpu_torch/health/``) against the
reference's on the CPU.

Under a fake clock, the same sequence of outcomes goes through the
reference's plane and the port's: burn rates, verdicts (QoS and
capture-storm signals fused in) and flight-recorder fields are EQUAL apart
from timings.  The config parser's answers and messages are EQUAL; the
sampler's lifecycle, bounds and gauges are the reference's; the probes of
the engine, batcher, cache, QoS and device registry give the reference's
keys.  The device probe reads ``torch.cuda.memory_stats`` on a card and
never reports host memory as the card's.  Both engines behind their REST
tiers answer ``/admin/introspect``, ``/admin/flightrecorder`` and
``/admin/health`` with the reference's keys, 404 with its hint when the
plane is off and 400 for a bad number; the local runner wires every
probe, the artifact and device planes' included.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu import health as jh
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import health as th
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.graph.spec import (
    DeploymentValidationError,
    load_deployment,
)
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import LocalDeployment
from seldon_core_tpu_torch.serving.rest import RestServer
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

TIMEOUT = 120
SIDES = {"port": th, "ref": jh}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def plane(h, clock, slo_availability=0.999, slo_p95_ms=None, **kw):
    cfg = h.HealthConfig(enabled=True, slo_availability=slo_availability,
                         slo_p95_ms=slo_p95_ms)
    return h.HealthPlane(cfg, clock=clock, **kw)


# ---- config ----------------------------------------------------------------


@pytest.mark.parametrize("ann", [
    {},
    {"seldon.io/health": "true"},
    {"seldon.io/slo-availability": "0.999"},
    {"seldon.io/health": "yes", "seldon.io/health-sample-ms": "250",
     "seldon.io/health-timeline": "64",
     "seldon.io/health-flight-records": "16", "seldon.io/slo-p95-ms": "50"},
    {"seldon.io/health": "maybe"},
    {"seldon.io/slo-availability": "1.0"},
    {"seldon.io/slo-availability": "nope"},
    {"seldon.io/health": "1", "seldon.io/health-sample-ms": "-5"},
    {"seldon.io/health": "1", "seldon.io/health-timeline": "x"},
    {"seldon.io/health": "1", "seldon.io/health-flight-records": "0"},
    {"seldon.io/health": "1", "seldon.io/slo-p95-ms": "z"},
])
def test_config_equal(ann, monkeypatch):
    for k in ("SELDON_HEALTH", "SELDON_SLO_AVAILABILITY",
              "SELDON_HEALTH_SAMPLE_MS"):
        monkeypatch.delenv(k, raising=False)

    def parse(h):
        try:
            return h.health_config_from_annotations(ann, "d/p").__dict__
        except ValueError as e:
            return str(e)

    got, want = parse(th), parse(jh)
    assert got == want
    if isinstance(want, str):  # the loader refuses it with that message
        with pytest.raises(DeploymentValidationError, match="seldon.io/"):
            load_deployment({"metadata": {"name": "d", "annotations": ann},
                             "spec": {"predictors": [{"name": "p", "graph": {
                                 "name": "m",
                                 "implementation": "SIMPLE_MODEL"}}]}})


# ---- burn rates and verdicts -----------------------------------------------

#: (slo_p95_ms, slo_availability, [(advance_s, n, latency_ms, status)])
SCENARIOS = {
    "healthy": (100.0, 0.999, [(0, 100, 5.0, 200)]),
    "error-burst": (None, 0.999, [(0, 90, 1.0, 200), (0, 10, 1.0, 503)]),
    "latency-warn": (10.0, None, [(0, 60, 1.0, 200), (0, 40, 50.0, 200)]),
    "latency-clears": (10.0, None, [(0, 60, 1.0, 200), (0, 40, 50.0, 200),
                                    (301, 20, 1.0, 200)]),
    "min-volume": (None, 0.999, [(0, 5, 1.0, 500)]),
    "diluted-1h": (None, 0.999, [(60, 100, 1.0, 200)] * 40
                   + [(0, 50, 1.0, 500)]),
    "4xx-not-errors": (None, 0.99, [(0, 100, 1.0, 429)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_burn_rates_and_verdicts_equal(name):
    p95, avail, steps = SCENARIOS[name]
    out = {}
    for side, h in SIDES.items():
        clk = FakeClock()
        p = plane(h, clk, slo_availability=avail, slo_p95_ms=p95)
        trail = []
        for adv, n, ms, status in steps:
            clk.t += adv
            for _ in range(n):
                p.note_request(ms, status)
            v = p.verdict()
            trail.append((v["verdict"], v["level"], v["signals"],
                          v.get("burn"), v["windows"]))
        out[side] = (trail, p.monitor.burn(), p.snapshot()["slo"])
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("shed,breakers,storm", [
    (0, [], []), (2, ["m"], []), (0, [], ["seg"]), (1, [], ["a", "b"])])
def test_verdict_fusion_equal(shed, breakers, storm):
    class Qos:
        shed_level = shed

        def open_breakers(self):
            return list(breakers)

    class Prof:
        def storm_segments(self):
            return list(storm)

    out = {}
    for side, h in SIDES.items():
        reg = (TRegistry if side == "port" else JRegistry)()
        p = plane(h, FakeClock(), metrics=reg, deployment="dep")
        p.qos, p.profiler = Qos(), Prof()
        v = p.verdict()
        out[side] = (v, sorted(ln for ln in reg.render().splitlines()
                               if ln.startswith("seldon_health")))
    assert out["port"] == out["ref"]


# ---- flight recorder -------------------------------------------------------

RECORDS = [("a", 200, 1.0, "d1", {}), ("b", 500, 5.0, "d1", {"shed": True}),
           ("c", 200, 50.0, "d2", {"mode": "fused"}),
           ("d", 429, 2.0, "d2", {"routing": {"r": 1}})]


@pytest.mark.parametrize("query", [
    {}, {"errors_only": True}, {"min_ms": 10.0},
    {"deployment": "d1", "status": 200}, {"n": 2}, {"puid": "c"},
    {"replica": "r0"}])
def test_flight_recorder_fields_equal(query):
    out = {}
    for side, h in SIDES.items():
        reg = (TRegistry if side == "port" else JRegistry)()
        fr = h.FlightRecorder(3, service="engine", metrics=reg)
        for puid, status, ms, dep, flags in RECORDS:
            fr.record(puid=puid, trace_id=puid * 32, deployment=dep,
                      route=("m",), node_ms={"m": ms}, status=status,
                      reason="", duration_ms=ms, flags=flags,
                      replica="r0")
        def untimed(r):
            return None if r is None else {k: v for k, v in r.items()
                                           if k != "ts"}

        recs = [untimed(r) for r in fr.query(**query)]
        out[side] = (recs, fr.stats(), untimed(fr.get("b")), sorted(
            ln for ln in reg.render().splitlines()
            if ln.startswith("seldon_flightrecorder")))
    assert out["port"] == out["ref"]


def test_flight_recorder_ring_bound_under_threads():
    fr = th.FlightRecorder(32, service="engine")

    def worker(k):
        for i in range(200):
            fr.record(puid=f"p{k}-{i}", trace_id="", deployment="d",
                      route=("m",), node_ms={}, status=200, reason="",
                      duration_ms=1.0, flags={})

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = fr.stats()
    assert (st["size"], st["recorded"], st["dropped"]) == \
        (32, 1600, 1600 - 32)


# ---- sampler and probes ----------------------------------------------------


def test_sampler_equal():
    out = {}
    for side, h in SIDES.items():
        reg = (TRegistry if side == "port" else JRegistry)()
        s = h.RuntimeSampler(interval_s=0.01, timeline=4, metrics=reg,
                             service="engine")
        s.add_probe("good", lambda: {"queue_rows": 3, "not_a_gauge": 1})
        s.add_probe("bad", lambda: 1 / 0)
        for _ in range(6):
            sample = s.sample_once()
        st = s.stats()
        st.pop("eventLoopLagMs")
        out[side] = (sorted(sample["probes"]), sample["probes"]["good"], st,
                     len(s.timeline()), s.timeline(probe="good")[-1][
                         "probes"],
                     sorted(ln for ln in reg.render().splitlines()
                            if "queue_rows" in ln or "ticks" in ln))
    assert out["port"] == out["ref"]


def test_sampler_lifecycle_leaks_no_task():
    async def go():
        s = th.RuntimeSampler(interval_s=0.005, timeline=16)
        s.add_probe("p", lambda: {"queue_rows": 1})
        assert s.ensure_started() and s.ensure_started()
        for _ in range(200):
            if s.stats()["samples"] >= 2:
                break
            await asyncio.sleep(0.01)
        assert s.stats()["samples"] >= 2
        await s.stop()
        assert not s.running
        return {t.get_name() for t in asyncio.all_tasks()
                if t is not asyncio.current_task()}

    assert "health-sampler" not in run(go())
    assert not th.RuntimeSampler().ensure_started()  # no loop: no task


def test_component_probes_give_the_reference_keys():
    from seldon_core_tpu.caching import CacheConfig as JCacheConfig
    from seldon_core_tpu.caching import PredictionCache as JCache
    from seldon_core_tpu.qos import EngineQos as JQos
    from seldon_core_tpu.qos import qos_from_annotations as jqos_cfg
    from seldon_core_tpu.runtime.batcher import DynamicBatcher as JBatcher
    from seldon_core_tpu_torch.caching import CacheConfig as TCacheConfig
    from seldon_core_tpu_torch.caching import PredictionCache as TCache
    from seldon_core_tpu_torch.qos import EngineQos as TQos
    from seldon_core_tpu_torch.qos import qos_from_annotations as tqos_cfg
    from seldon_core_tpu_torch.runtime.batcher import (
        DynamicBatcher as TBatcher,
    )

    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}
    ann = {"seldon.io/slo-p95-ms": "100"}
    out = {}
    for side, h, Eng, Batcher, Cache, CacheCfg, Qos, qcfg in (
            ("port", th, TEngine, TBatcher, TCache, TCacheConfig, TQos,
             tqos_cfg),
            ("ref", jh, JEngine, JBatcher, JCache, JCacheConfig, JQos,
             jqos_cfg)):
        probes = {
            "engine": h.engine_probe(Eng(graph, plan_mode="fused")),
            "batcher": h.batcher_probe(Batcher(lambda x: (x, None))),
            "cache": h.cache_probe(Cache(CacheCfg())),
            "qos": h.qos_probe(Qos(qcfg(ann, "d"))),
        }
        out[side] = {k: sorted(p()) for k, p in probes.items()}
    assert out["port"] == out["ref"]
    from seldon_core_tpu_torch.runtime.device_registry import registry

    assert sorted(th.device_registry_probe(registry)()) == [
        "device_registry_bytes", "device_registry_entries"]


def test_device_probe_on_the_cpu_is_host_rss():
    got = th.device_memory_probe("cpu")()
    assert list(got) == ["host_rss_bytes"] and got["host_rss_bytes"] > 0
    assert list(jh.device_memory_probe()()) == ["host_rss_bytes"]


def test_device_probe_on_a_card_reads_torch_cuda(monkeypatch):
    """On a CUDA device the probe reads the allocator's allocated bytes
    and the card's total memory; a card that reports no
    stats raises (the sampler counts the error), never answers RSS."""
    import torch

    stats = {"allocated_bytes.all.current": 7 << 20,
             "reserved_bytes.all.current": 9 << 20}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80 << 30}))
    probe = th.device_memory_probe("cuda:0")
    assert probe() == {"hbm_bytes_in_use": float(7 << 20),
                       "hbm_bytes_limit": float(80 << 30)}
    reg = TRegistry()
    s = th.RuntimeSampler(metrics=reg)
    s.add_probe("device", probe)
    s.sample_once()
    text = reg.render()
    assert 'seldon_runtime_hbm_bytes_in_use{probe="device"} 7340032' in text
    assert "host_rss" not in text
    stats.clear()  # a card that reports nothing
    with pytest.raises(RuntimeError, match="memory_stats"):
        probe()
    sample = s.sample_once()
    assert "device" not in sample["probes"]
    assert s.stats()["probeErrors"] == 1


# ---- the REST tiers --------------------------------------------------------


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


PATHS = ["/admin/health", "/admin/health?verbose=1", "/admin/flightrecorder",
         "/admin/flightrecorder?stats=1", "/admin/introspect",
         "/admin/introspect?stats=1", "/admin/introspect?probe=nope",
         "/admin/introspect?n=xyz", "/admin/flightrecorder?status=x"]


def keys(obj):
    """The key structure of a JSON body (lists by their first item)."""
    if isinstance(obj, dict):
        return {k: keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [keys(obj[0])]
    return type(obj).__name__ if obj is not None else None


def serve_both(planes: bool):
    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}

    async def port_side():
        p = plane(th, FakeClock()) if planes else None
        srv = await RestServer(TEngine(graph, health=p), host="127.0.0.1",
                               port=0).start()
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, post, srv.port,
                                       {"data": {"ndarray": [[1.0, 2.0]]}})
            if p is not None:
                p.sampler.sample_once()
            return [await loop.run_in_executor(None, get, srv.port, path)
                    for path in PATHS]
        finally:
            await srv.stop()
            if p is not None:
                await p.aclose()

    async def ref_side():
        p = plane(jh, FakeClock()) if planes else None
        runner = await start_server(
            build_app(engine=JEngine(graph, health=p)), "127.0.0.1", 0)
        port = runner.addresses[0][1]
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, post, port,
                                       {"data": {"ndarray": [[1.0, 2.0]]}})
            if p is not None:
                p.sampler.sample_once()
            return [await loop.run_in_executor(None, get, port, path)
                    for path in PATHS]
        finally:
            await runner.cleanup()
            if p is not None:
                await p.aclose()

    return run(port_side()), run(ref_side())


def test_admin_health_bodies_have_the_reference_keys():
    got, want = serve_both(True)
    for path, (gc, gb), (wc, wb) in zip(PATHS, got, want):
        assert gc == wc, path
        assert keys(gb) == keys(wb), path
    assert got[0][1]["verdict"] == "ok"
    assert got[2][1]["records"][0]["status"] == 200


def test_admin_health_off_answers_the_reference_404():
    got, want = serve_both(False)
    for path, g, w in zip(PATHS, got, want):
        assert g == w, path
        assert g[0] == 404 and "hint" in g[1]


# ---- the local runner ------------------------------------------------------


def test_local_runner_wires_every_probe(tmp_path):
    from seldon_core_tpu_torch.health import registry as hreg

    mlp = {"name": "clf", "type": "MODEL", "parameters": [
        {"name": "model_class", "type": "STRING",
         "value": "seldon_core_tpu_torch.models.mlp:MNISTMLP"},
        {"name": "hidden", "value": "8", "type": "INT"}]}
    dep = {"metadata": {"name": "hp", "annotations": {
        "seldon.io/health": "true", "seldon.io/profile": "true",
        "seldon.io/graph-plan": "fused",
        "seldon.io/prediction-cache": "true",
        "seldon.io/slo-p95-ms": "500",
        "seldon.io/artifact-store": str(tmp_path),
        "seldon.io/device-plane": "true"}},
        "spec": {"predictors": [{"name": "p", "graph": mlp}]}}
    local = LocalDeployment(load_deployment(dep), device="cpu", seed=0)

    async def go():
        out = await local.predict(TMessage.from_ndarray(
            np.zeros((1, 784), np.float32)))
        sample = local.health.sampler.sample_once()
        await local.aclose()
        return out, sample

    try:
        out, sample = run(go())
        assert out.status.status == "SUCCESS"
        assert set(sample["probes"]) == {
            "device", "device_registry", "engine", "cache", "qos",
            "profile", "artifacts", "device_plane", "batcher:clf", "loop"}
        assert set(sample["probes"]["device"]) == {"host_rss_bytes"}
        assert sample["probes"]["artifacts"]["artifact_live_compiles"] == 0
        assert "device_plane_transfers_avoided" in \
            sample["probes"]["device_plane"]
        assert local.health.sampler.stats()["probeErrors"] == 0
        # the artifact plane's precompile warmed the 7 batcher buckets at
        # boot: 7 ledger rows within a minute are a capture storm (>= 4),
        # which the verdict carries as the reference's does
        snap = hreg.snapshot("hp")["predictors"][0]
        assert local.profiler.compile.stats()["compiles"] == 7
        assert local.profiler.storm_segments() == ["clf"]
        assert (snap["verdict"], snap["signals"]) == \
            ("warn", ["recompile-storm"])
        rec = local.health.recorder.query()[0]
        assert rec["flags"]["mode"] == "fused" and rec["flags"]["flops"] > 0
    finally:
        hreg.clear()


def test_native_tier_serves_the_planes():
    """The native REST tier answers from ``rest.py``'s route tables: the
    same ``/admin/*`` and ``/trace`` bodies as the stdlib tier."""
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.serving.native_http import NativeRestServer

    dep = {"metadata": {"name": "nt", "annotations": {
        "seldon.io/health": "true", "seldon.io/tracing": "true",
        "seldon.io/profile": "true"}},
        "spec": {"predictors": [{"name": "p", "graph": {
            "name": "m", "implementation": "SIMPLE_MODEL"}}]}}

    async def go():
        server, local = await serve(dep, port=0, host="127.0.0.1",
                                    device="cpu")
        native = NativeRestServer(rest=server, port=0, bind="127.0.0.1")
        nport = await native.start()
        loop = asyncio.get_running_loop()
        try:
            code, body = await loop.run_in_executor(
                None, post, server.port, {"data": {"ndarray": [[1.0]]}})
            puid = body["meta"]["puid"]
            out = []
            for path in (f"/trace?puid={puid}", "/admin/health",
                         "/admin/flightrecorder?stats=1",
                         "/admin/profile/compile", "/admin/introspect?n=x"):
                a = await loop.run_in_executor(None, get, server.port, path)
                b = await loop.run_in_executor(None, get, nport, path)
                out.append((path, a, b))
            return out
        finally:
            await native.stop()
            await server.stop()
            await local.aclose()

    for path, a, b in run(go()):
        assert a[0] == b[0] and keys(a[1]) == keys(b[1]), path
        assert a[0] == (400 if path.endswith("=x") else 200), path
