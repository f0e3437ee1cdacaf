"""The port's profiling plane (``seldon_core_tpu_torch/profiling/``) and
its bucket costs (``graph/plan.py``, ``ops/cost.py``) against the
reference's on the CPU.

The cases of the reference's ``tests/test_profiling.py``, through both
packages on the same inputs: config answers and messages EQUAL; the host
sampler's folded-stack format, overflow and capture windows; the capture
ledger's keys and bucket labels EQUAL to the reference's compile ledger on
the same notes and on the same engine traffic; attribution shares and
capacity EQUAL under the same ``SELDON_DEVICE_PEAK_TFLOPS``;
``cost_for_rows`` ranking EQUAL; the storm signal degrading the health
verdict as the reference's does.  The bucket cost counted from the
stages' shapes against XLA's ``cost_analysis()`` for the MNIST MLP at
rows 1, 8 and 64: FLOPs within 0.5% (elementwise work, which XLA counts
and ``FlopCounterMode`` does not, is the 0.15% gap); bytes within 15%
(the port counts every op's inputs and outputs, unfused: 0.3%, 2.1% and
12.3% above XLA's fused count at rows 1, 8 and 64).  The hand-written
kernels' ``pl.CostEstimate`` formulas are added exactly once, and their
plain versions' own matmuls never.  Device-trace windows open and close
the ``torch.profiler`` session (CPU activity only, in these CPU tests).
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu import profiling as jp
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.graph.plan import FusedSegment as JSegment
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import resolve_component as jresolve
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch import profiling as tp
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.graph.plan import FusedSegment as TSegment
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import resolve_component as tresolve
from seldon_core_tpu_torch.ops import cost
from seldon_core_tpu_torch.runtime.batcher import BatcherConfig as TBatcherConfig
from seldon_core_tpu_torch.utils import tracing as tt
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

NO_BATCH = {"seldon.io/batching": "false"}
TIMEOUT = 120
SIDES = {"port": tp, "ref": jp}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _spin(seconds: float) -> int:
    deadline = time.perf_counter() + seconds
    acc = 0
    while time.perf_counter() < deadline:
        acc += 1
    return acc


def _spin_until(stop: threading.Event) -> None:
    while not stop.is_set():
        _spin(0.002)


def mlp_engine(side, plane=None, **kw):
    pkg = "seldon_core_tpu_torch" if side == "port" else "seldon_core_tpu"
    spec = {"name": "m", "type": "MODEL", "parameters": [
        {"name": "model_class", "value": f"{pkg}.models.mlp:MNISTMLP",
         "type": "STRING"}]}
    if side == "port":
        return TEngine(spec, resolver=lambda u: tresolve(u, NO_BATCH, "cpu"),
                       name="prof", plan_mode="fused", profiler=plane, **kw)
    return JEngine(spec, resolver=lambda u: jresolve(u, NO_BATCH),
                   name="prof", plan_mode="fused", profiler=plane, **kw)


MSG = {"port": TMessage, "ref": JMessage}


# ---- config ----------------------------------------------------------------


@pytest.mark.parametrize("ann", [
    {}, {"seldon.io/profile": "true", "seldon.io/profile-hz": "97",
         "seldon.io/profile-stacks": "50",
         "seldon.io/profile-window-s": "10", "seldon.io/profile-storm": "3"},
    {"seldon.io/profile": "maybe"}, {"seldon.io/profile-hz": "0"},
    {"seldon.io/profile-hz": "2000"}, {"seldon.io/profile-hz": "x"},
    {"seldon.io/profile-stacks": "0"}, {"seldon.io/profile-stacks": "1.5"},
    {"seldon.io/profile-window-s": "601"},
    {"seldon.io/profile-window-s": "z"}, {"seldon.io/profile-storm": "1"},
    {"seldon.io/profile-storm": "y"}])
def test_config_equal(ann, monkeypatch):
    for k in ("SELDON_PROFILE", "SELDON_PROFILE_HZ"):
        monkeypatch.delenv(k, raising=False)

    def parse(p):
        try:
            return p.profile_config_from_annotations(ann, "d/p").__dict__
        except ValueError as e:
            return str(e)

    assert parse(tp) == parse(jp)


# ---- host sampler ----------------------------------------------------------


def test_folded_stack_format():
    """Root-first collapsed stacks keyed by thread, ``file:function``
    frames, rendered hottest first as ``stack count``."""
    sampler = tp.HostSampler(hz=50.0)
    stop = threading.Event()
    t = threading.Thread(target=lambda: _spin_until(stop),
                         name="busy-worker")
    t.start()
    try:
        for _ in range(20):
            sampler.sample_once()
            time.sleep(0.002)
    finally:
        stop.set()
        t.join()
    folded = sampler.folded()
    assert any("thread:busy-worker" in s and "test_torch_profiling:_spin" in s
               for s in folded)
    assert all(s.split(";")[0].startswith("thread:") for s in folded)
    text = sampler.collapsed(n=3).splitlines()
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in text]
    assert len(text) <= 3 and counts == sorted(counts, reverse=True)
    # the same table renders the same text in both packages
    assert tp.HostSampler.render(folded) == jp.HostSampler.render(folded)


def test_running_asyncio_task_keys_the_stack():
    sampler = tp.HostSampler(hz=500.0)

    def hammer():
        for _ in range(60):
            sampler.sample_once()
            time.sleep(0.002)

    async def main():
        t = threading.Thread(target=hammer)
        t.start()
        join = asyncio.get_running_loop().create_task(
            asyncio.to_thread(t.join))

        async def spin():
            _spin(0.12)

        await asyncio.get_running_loop().create_task(spin(), name="prof-busy")
        await join

    run(main())
    assert any("task:prof-busy" in s for s in sampler.folded())


@pytest.mark.parametrize("side", ["port", "ref"])
def test_stack_table_overflows_to_other(side):
    p = SIDES[side]
    sampler = p.HostSampler(hz=1.0, max_stacks=2)
    with sampler._lock:
        sampler._folded["a"] = 1
        sampler._folded["b"] = 1
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="parked")
    t.start()
    try:
        sampler.sample_once()
    finally:
        stop.set()
        t.join()
    folded = sampler.folded()
    assert set(folded) == {"a", "b", "(other)"}
    assert folded["(other)"] >= 1


def test_windows_hold_independent_baselines_and_cap():
    sampler = tp.HostSampler(hz=1.0)
    try:
        w1 = sampler.open_window(30.0)
        sampler.sample_once()
        w2 = sampler.open_window(30.0)
        sampler.sample_once()
        r1 = sampler.read_window(w1["id"], stop=True)
        r2 = sampler.read_window(w2["id"], stop=True)
        # lower bounds: the background thread may add samples
        assert r1["done"] and r2["done"]
        assert r1["samples"] >= 2 and r2["samples"] >= 1
        assert r1["samples"] >= r2["samples"]
        assert sampler.read_window(w1["id"]) is None  # one-shot fetch
        for _ in range(8):
            sampler.open_window(30.0)
        with pytest.raises(ValueError, match="concurrent"):
            sampler.open_window(30.0)
    finally:
        sampler.stop()


def test_device_trace_window_inside_an_active_window(tmp_path, caplog):
    """A window asking for a device trace while one is open warns and
    skips the device part; its host capture is intact.  Counts are lower
    bounds: the sampler's thread may add samples (the reference's exact
    count races it)."""
    sampler = tp.HostSampler(hz=1.0)
    tt.warm_device_profile()  # what the profiling plane does at boot
    stop = threading.Event()
    t = threading.Thread(target=lambda: _spin_until(stop))
    t.start()
    try:
        with tt.xla_profile(str(tmp_path / "outer")):
            with caplog.at_level("WARNING"):
                w = sampler.open_window(30.0,
                                        device_dir=str(tmp_path / "inner"))
            for _ in range(5):
                sampler.sample_once()
            r = sampler.read_window(w["id"], stop=True)
    finally:
        stop.set()
        t.join()
        sampler.stop()
    assert r["done"] and r["samples"] >= 5 and r["stacks"] > 0
    assert any("already active" in rec.message for rec in caplog.records)
    assert not (tmp_path / "inner").exists() or not list(
        (tmp_path / "inner").iterdir())
    assert list((tmp_path / "outer").glob("trace-*.json"))


def test_device_trace_window_writes_and_stop_closes(tmp_path):
    sampler = tp.HostSampler(hz=1.0)
    w = sampler.open_window(30.0, device_dir=str(tmp_path / "a"))
    assert w["device"] == str(tmp_path / "a") and tt.profiler_active()
    torch.ones(4) @ torch.ones(4)
    r = sampler.read_window(w["id"], stop=True)
    assert r["device"] == str(tmp_path / "a") and not tt.profiler_active()
    assert list((tmp_path / "a").glob("trace-*.json"))
    sampler.open_window(30.0, device_dir=str(tmp_path / "b"))
    sampler.stop()  # closes the session, never leaks it
    assert not tt.profiler_active()
    with tt.xla_profile(str(tmp_path / "after")) as session:
        pass
    assert session.path is not None


# ---- the capture ledger ------------------------------------------------------

NOTES = [("seg", "1x784:float32", 12.5, 1e9, 2e6, 3e6, "live"),
         ("seg", "8x784:float32", 3.0, 8e9, 3e6, 3e6, "live"),
         ("seg", "8x784:float32", 2.0, 8e9, 3e6, 3e6, "aot-cache"),
         ("calm", "1x4:float32", 1.0, 0.0, 0.0, 0.0, "live"),
         ("seg", "64x784:float32", 9.0, 6e10, 4e6, 5e6, "live")]


def ledger(side, storm=3):
    p = SIDES[side]
    clock = FakeClock()
    reg = (TRegistry if side == "port" else JRegistry)()
    watch = p.CompileWatch(metrics=reg, storm_threshold=storm, clock=clock)
    trail = []
    for seg, bucket, ms, fl, by, pk, src in NOTES:
        watch.note_compile(seg, bucket=bucket, wall_ms=ms, flops=fl,
                           bytes_accessed=by, peak_hbm_bytes=pk, source=src)
        clock.t += 1.0
        trail.append(watch.storm_segments())
    clock.t += 120.0
    trail.append(watch.storm_segments())
    return (trail, watch.snapshot(), watch.stats(),
            sorted(ln for ln in reg.render().splitlines()
                   if ln.startswith("seldon_compile")))


def test_ledger_equal():
    assert ledger("port") == ledger("ref")


def test_ledger_bounded_per_segment():
    watch = tp.CompileWatch(clock=FakeClock())
    for i in range(100):
        watch.note_compile("seg", bucket=f"{i}x:f32")
    seg = watch.snapshot()["segments"]["seg"]
    assert seg["compiles"] == 100 and len(seg["buckets"]) <= 64


def test_engine_ledger_keys_and_labels_equal():
    """The same MNIST traffic through both fused engines: the ledgers hold
    the same segments, buckets (``"1x784:float32"``), counts and keys."""
    out = {}
    for side in ("port", "ref"):
        plane = SIDES[side].ProfilePlane(
            SIDES[side].ProfileConfig(enabled=True), deployment="prof")
        eng = mlp_engine(side, plane)
        try:
            for rows in (1, 8, 1, 64):
                m = MSG[side].from_ndarray(np.zeros((rows, 784), np.float32))
                assert run(eng.predict(m)).status.status == "SUCCESS"
            snap = plane.compile.snapshot()
            segs = {
                name: (s["compiles"], s["hydrations"], s["storm"],
                       sorted(s), sorted(s["buckets"]),
                       sorted(sorted(b) for b in s["buckets"].values()),
                       s["wallMsTotal"] > 0)
                for name, s in snap["segments"].items()}
            out[side] = (segs, snap["storm"], sorted(snap),
                         sorted(plane.compile.stats()))
        finally:
            run(plane.aclose())
    assert out["port"] == out["ref"]


MNIST_ROWS = (1, 8, 64)


@pytest.fixture(scope="module")
def mnist_costs():
    costs = {}
    for side in ("port", "ref"):
        eng = mlp_engine(side)
        for rows in MNIST_ROWS:
            m = MSG[side].from_ndarray(np.zeros((rows, 784), np.float32))
            run(eng.predict(m))
        costs[side] = eng.plan.segments[0].cost_by_bucket
    return costs


@pytest.mark.parametrize("rows", MNIST_ROWS)
def test_mnist_bucket_cost_against_xla(mnist_costs, rows):
    key = ((rows, 784), "float32")
    got, want = mnist_costs["port"][key], mnist_costs["ref"][key]
    assert sorted(got) == sorted(want)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.005)
    assert got["bytes_accessed"] == pytest.approx(want["bytes_accessed"],
                                                  rel=0.15)
    # the products alone, 2 x rows x (784x512 + 512x256 + 256x10), as
    # FlopCounterMode counts them
    assert got["flops"] == 2 * rows * (784 * 512 + 512 * 256 + 256 * 10)


def test_kernel_formulas_added_once_and_plain_versions_hidden():
    """K1's and K3's ``pl.CostEstimate`` formulas count once per call; the
    plain versions' own aten products, which run on the CPU, do not."""
    from seldon_core_tpu_torch.ops import attention, quant

    g = torch.Generator().manual_seed(0)
    w = quant.quantize_int8(torch.randn(64, 48, generator=g))
    x = torch.randn(5, 64, generator=g)
    with cost.CostCount() as c:
        quant.int8_matmul(x, w)
    assert c.flops == 2 * 5 * 48 * 64
    assert c.bytes_accessed == 5 * 64 * 4 + 64 * 48 + 5 * 48 * 4
    q = torch.randn(2, 16, 4, 8, generator=g)
    kv = torch.randn(2, 16, 2, 8, generator=g)
    with cost.CostCount() as c:
        attention.flash_attention(q, kv, kv)
    assert c.flops == 4 * 2 * 4 * 16 * 16 * 8
    assert c.bytes_accessed == 4 * 2 * 4 * 16 * 8 * 4
    # around them, aten work still counts; without a count nothing does
    with cost.CostCount() as c:
        y = quant.int8_matmul(x, w)
        y @ torch.ones(48, 3)
    assert c.flops == 2 * 5 * 48 * 64 + 2 * 5 * 48 * 3
    assert cost.kernel(1, 1) is cost.kernel(2, 2)  # the shared no-op
    with pytest.raises(RuntimeError, match="already open"):
        with cost.CostCount(), cost.CostCount():
            pass


# ---- attribution and capacity ----------------------------------------------


def test_attribution_scopes_equal():
    out = {}
    for side, p in SIDES.items():
        from importlib import import_module

        attr = import_module(f"{p.__name__}.attribution")
        token = attr.attribution_scope()
        attr.note_segment_cost("a", 100.0, 10.0)
        attr.note_segment_cost("a", 50.0, 5.0)
        attr.note_segment_cost("b", 25.0, 0.0)
        res = token.close()
        attr.note_segment_cost("c", 1.0, 1.0)  # closed: a no-op

        async def request(f, attr=attr):
            tok = attr.attribution_scope()
            await asyncio.sleep(0.005)
            attr.note_segment_cost("seg", f, 0.0)
            return tok.close()["flops"]

        async def many(request=request):
            return await asyncio.gather(*(request(float(i))
                                          for i in range(1, 6)))

        out[side] = (res, run(many()))
    assert out["port"] == out["ref"]
    assert out["port"][1] == [1.0, 2.0, 3.0, 4.0, 5.0]


@pytest.mark.parametrize("n,gap", [(0, 1.0), (10, 1.0), (5, 0.25)])
def test_capacity_equal_under_the_same_peak(n, gap, monkeypatch):
    monkeypatch.setenv("SELDON_DEVICE_PEAK_TFLOPS", "459")
    out = {}
    for side, p in SIDES.items():
        clock = FakeClock()
        reg = (TRegistry if side == "port" else JRegistry)()
        attr = p.CostAttribution(metrics=reg, deployment="d", clock=clock)
        for i in range(n):
            attr.note_dispatch("seg", 1e12 * (i + 1), 1e9)
            attr.note_request(1e12 * (i + 1))
            clock.t += gap
        cap = attr.capacity()
        cap.pop("deviceKind", None)
        out[side] = (cap, attr.stats(), attr.occupancy_estimate(),
                     sorted(ln for ln in reg.render().splitlines()
                            if ln.startswith("seldon_request")))
    assert out["port"] == out["ref"]


def test_device_peak_rules(monkeypatch):
    from seldon_core_tpu_torch.profiling import attribution

    monkeypatch.delenv("SELDON_DEVICE_PEAK_TFLOPS", raising=False)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4),
                       ("NVIDIA H100 PCIe", 756.5),
                       ("NVIDIA A100-SXM4-80GB", None), ("cpu", None)):
        monkeypatch.setattr(attribution, "device_kind", lambda n=name: n)
        assert attribution.device_peak_tflops() == peak
    monkeypatch.setenv("SELDON_DEVICE_PEAK_TFLOPS", "459")
    assert attribution.device_peak_tflops() == 459.0
    monkeypatch.setenv("SELDON_DEVICE_PEAK_TFLOPS", "bogus")
    assert attribution.device_peak_tflops() is None  # cpu: unknown
    # an unknown peak: capacity names the missing override, estimates 0
    attr = tp.CostAttribution(clock=FakeClock())
    attr.note_request(1e9)
    cap = attr.capacity()
    assert cap["devicePeakTflops"] is None and cap["deviceKind"] == "cpu"
    assert "SELDON_DEVICE_PEAK_TFLOPS" in cap["hint"]
    assert attr.occupancy_estimate() == 0.0


def test_cost_for_rows_ranking_equal():
    class Stub:
        cost_by_bucket = {
            ((4, 8), "float32"): {"flops": 400.0, "bytes_accessed": 40.0},
            ((8, 8), "float32"): {"flops": 800.0, "bytes_accessed": 80.0},
            ((0,), "float32"): {"flops": 0.0},
        }

    class Empty:
        cost_by_bucket = {}

    for rows in (1, 3, 4, 6, 8, 9, 16):
        assert TSegment.cost_for_rows(Stub(), rows) == \
            JSegment.cost_for_rows(Stub(), rows)
    assert TSegment.cost_for_rows(Empty(), 1) is None


def test_request_attribution_equals_the_bucket_cost():
    """One request of two rows is charged its bucket's whole cost; two
    coalesced one-row requests share the two-row bucket's cost."""
    plane = tp.ProfilePlane(tp.ProfileConfig(enabled=True), deployment="p")
    eng = mlp_engine("port", plane)
    try:
        run(eng.predict(TMessage.from_ndarray(np.zeros((2, 784),
                                                       np.float32))))
        bucket = eng.plan.segments[0].cost_by_bucket[((2, 784), "float32")]
        with plane.attribution._lock:
            flops = [f for _, f in plane.attribution._requests]
        assert flops == [pytest.approx(bucket["flops"])]
    finally:
        run(plane.aclose())
    plane = tp.ProfilePlane(tp.ProfileConfig(enabled=True), deployment="p")
    eng = mlp_engine("port", plane, plan_batcher=TBatcherConfig(
        max_batch_size=2, max_delay_ms=20.0))
    try:
        msg = TMessage.from_ndarray(np.zeros((1, 784), np.float32))

        async def two():
            return await asyncio.gather(eng.predict(msg), eng.predict(msg))

        run(two())
        bucket = eng.plan.segments[0].cost_by_bucket[((2, 784), "float32")]
        with plane.attribution._lock:
            flops = [f for _, f in plane.attribution._requests]
        assert len(flops) == 2
        assert sum(flops) == pytest.approx(bucket["flops"])
    finally:
        run(plane.aclose())


# ---- admin bodies and the verdict -------------------------------------------


def admin(side, window_s=30.0):
    from importlib import import_module

    p = SIDES[side]
    http = import_module(f"{p.__name__}.http")
    plane = p.ProfilePlane(p.ProfileConfig(enabled=True, hz=1000.0,
                                           window_s=window_s),
                           service="engine", deployment="d")
    return http, plane


def shape(obj):
    if isinstance(obj, dict):
        return {k: shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_admin_bodies_equal(monkeypatch):
    monkeypatch.setenv("SELDON_DEVICE_PEAK_TFLOPS", "459")
    out = {}
    for side in ("port", "ref"):
        http, plane = admin(side)
        try:
            plane.compile.note_compile("seg", bucket="1x4:float32",
                                       wall_ms=3.0, flops=1e6)
            res = [body(None, {}) for body in (
                http.profile_body, http.capture_body, http.compile_body,
                http.capacity_body)]
            st, body = http.compile_body(plane, {})
            for b in body["segments"]["seg"]["buckets"].values():
                b.pop("ts")
            res.append((st, body))
            st, body = http.capacity_body(plane, {})
            body.pop("deviceKind", None)
            res.append((st, body))
            res.append(http.capture_body(plane, {"seconds": "60"}))
            st, w = http.capture_body(plane, {"seconds": "20"})
            res.append((st, sorted(w)))
            st, r = http.capture_body(plane, {"id": w["id"], "stop": "1"})
            res.append((st, shape({k: v for k, v in r.items()
                                   if k not in ("folded",)})))
            res.append(http.capture_body(plane, {"id": "w999"}))
            for _ in range(8):
                http.capture_body(plane, {"seconds": "20"})
            res.append(http.capture_body(plane, {"seconds": "20"}))
            st, body = http.profile_body(plane, {"n": "3", "reset": "1"})
            res.append((st, sorted(body), sorted(body["stats"]),
                        plane.sampler.folded()))
            snap = plane.snapshot()
            res.append((sorted(snap), snap["storm"], sorted(
                snap["compile"]), sorted(snap["attribution"])))
            with pytest.raises(ValueError):
                http.profile_body(plane, {"n": "x"})
        finally:
            run(plane.aclose())
        out[side] = res
    assert out["port"] == out["ref"]


def test_storm_degrades_the_health_verdict_equal():
    from seldon_core_tpu import health as jh
    from seldon_core_tpu_torch import health as th

    out = {}
    for side, p, h in (("port", tp, th), ("ref", jp, jh)):
        clock = FakeClock()
        health = h.HealthPlane(h.HealthConfig(enabled=True),
                               service="engine")
        plane = p.ProfilePlane(p.ProfileConfig(enabled=True, storm=2),
                               clock=clock)
        health.profiler = plane
        trail = [health.verdict()["signals"]]
        plane.compile.note_compile("seg", bucket="a")
        plane.compile.note_compile("seg", bucket="b")
        v = health.verdict()
        trail.append((v["verdict"], v["signals"], v["recompileStorm"]))
        clock.t += 120.0
        trail.append(health.verdict()["signals"])
        out[side] = trail
    assert out["port"] == out["ref"]
    assert out["port"][1] == ("warn", ["recompile-storm"], ["seg"])
