"""The port's device plane (``runtime/device_registry.py``,
``runtime/device_plane.py`` and the transports' ``deviceRef`` paths)
against the reference's on the CPU.

Every case of the reference's ``tests/test_device_plane.py`` but the
GL17xx lints (they come with slice 5-ii) runs on the port: one-shot refs
exactly once under concurrency, capacity eviction, pid-sensitive process
scoping, shm staging and pooled lanes, the plane's config and counters,
metadata that never copies to the host, the meta-only route, and the
framed negotiation with its downgrades.  Interop cases hold the formats to
the reference's: a port shm producer read by the reference's registry and
the reverse (bytes equal, bfloat16 included), a port framed client
against a reference framed server and the reverse (each pairing
negotiates what the reference's rule gives for two processes on one host,
and the answers are equal), REST hops in both directions, the proto's
``DeviceTensorRef`` arm, the configs' messages and the residency map.

The port's registry resolves shm refs onto the CPU here (``device="cpu"``,
as the reference's does under ``JAX_PLATFORMS=cpu``).  Every socket test
runs under a timeout.
"""

import asyncio
import os
import threading
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.proto import prediction_pb2 as jpb
from seldon_core_tpu.proto.convert import message_from_proto as j_from_proto
from seldon_core_tpu.proto.convert import message_to_proto as j_to_proto
from seldon_core_tpu.runtime import device_plane as jplane
from seldon_core_tpu.runtime import device_registry as jreg
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.serving import framed as jframed
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.proto import prediction_pb2 as tpb
from seldon_core_tpu_torch.proto.convert import (
    message_from_proto,
    message_to_proto,
)
from seldon_core_tpu_torch.runtime import device_registry as treg
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.runtime.device_plane import (
    DevicePlane,
    DevicePlaneConfig,
    device_plane_config_from_annotations,
)
from seldon_core_tpu_torch.runtime.device_registry import (
    SHM_PREFIX,
    DeviceBufferRegistry,
    ForeignProcessRef,
    process_token,
)
from seldon_core_tpu_torch.serving import framed as tframed
from seldon_core_tpu_torch.serving.client import RemoteComponent
from seldon_core_tpu_torch.serving.rest import RestServer

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _cpu_registry(monkeypatch):
    """The process registry resolves onto the CPU, as the reference's does
    on its CPU backend."""
    monkeypatch.setattr(treg.registry, "device", torch.device("cpu"))


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _arr(shape=(4, 8), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _reg(**kw):
    return DeviceBufferRegistry(device="cpu", **kw)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# ---------------------------------------------------------------------------
# registry: loopback refs
# ---------------------------------------------------------------------------


def test_one_shot_resolve_is_exactly_once_under_concurrency():
    r = _reg()
    ref = r.put(torch.from_numpy(_arr()))
    got, errs = [], []
    start = threading.Barrier(16)

    def worker():
        start.wait()
        try:
            got.append(r.resolve(ref))
        except KeyError as e:
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 1 and len(errs) == 15
    assert len(r) == 0 and r.nbytes == 0


def test_capacity_eviction_bills_reaped_counter():
    r = _reg(capacity=2)
    refs = [r.put(torch.from_numpy(_arr(seed=i))) for i in range(4)]
    assert len(r) == 2
    assert r.reaped == 2
    for ref in refs[:2]:  # the oldest two were evicted, never consumed
        with pytest.raises(KeyError):
            r.resolve(ref)
    for ref in refs[2:]:
        assert r.resolve(ref) is not None
    assert r.nbytes == 0


def test_foreign_process_ref_rejected_with_downgrade_marker():
    r = _reg()
    foreign = f"not-{process_token()}/deadbeef"
    with pytest.raises(ForeignProcessRef) as ei:
        r.resolve(foreign)
    assert "DeviceTensorRef" in str(ei.value)
    # the reference's message, word for word
    with pytest.raises(jreg.ForeignProcessRef) as ej:
        jreg.DeviceBufferRegistry().resolve(foreign)
    assert str(ei.value) == str(ej.value)


def test_fork_scoping_is_pid_sensitive(monkeypatch):
    r = _reg()
    x = torch.from_numpy(_arr())
    ref = r.put(x)
    real_pid = os.getpid()
    monkeypatch.setattr(treg.os, "getpid", lambda: real_pid + 1)
    with pytest.raises(ForeignProcessRef):
        r.resolve(ref)
    monkeypatch.undo()
    assert torch.equal(r.resolve(ref), x)


def test_non_consuming_resolve_keeps_entry():
    r = _reg()
    ref = r.put(torch.from_numpy(_arr()))
    a = r.resolve(ref, consume=False)
    b = r.resolve(ref)
    assert a is b
    with pytest.raises(KeyError):
        r.resolve(ref)


def test_ref_ownership_is_the_references():
    for ref in ("shmc:lane:float32:2:1", "shm:x:float32:2", "tok/uuid"):
        assert treg.ref_ownership(ref) == jreg.ref_ownership(ref)


# ---------------------------------------------------------------------------
# registry: shm staging, lanes, the transfer ledger
# ---------------------------------------------------------------------------


def test_shm_round_trip_unlinks_on_consume():
    r = _reg()
    x = _arr((16, 32), seed=3)
    ref = r.put_shm(x)
    assert ref.startswith("shm:")
    name = ref.split(":", 2)[1]
    assert os.path.exists(f"/dev/shm/{name}")
    np.testing.assert_array_equal(np.asarray(r.resolve(ref)), x)
    assert not os.path.exists(f"/dev/shm/{name}")
    with pytest.raises(KeyError) as ei:
        r.resolve(ref)
    assert "DeviceTensorRef" in str(ei.value)


def test_shm_rejects_object_dtype():
    with pytest.raises(ValueError):
        _reg().put_shm(np.array([{"a": 1}], dtype=object))


def test_transfer_bytes_ledger():
    r = _reg()
    x = _arr((8, 8))
    r.resolve(r.put_shm(x))
    assert r.transfer_bytes["d2h"] == x.nbytes
    assert r.transfer_bytes["h2d"] == x.nbytes
    r.resolve(r.put(torch.from_numpy(x)))
    assert r.transfer_bytes["avoided"] == x.nbytes


def test_orphan_reap_collects_dead_producers_segments():
    from multiprocessing import shared_memory

    r = _reg()
    name = f"{SHM_PREFIX}orphan_torch_test_{os.getpid()}"
    seg = shared_memory.SharedMemory(create=True, size=64, name=name)
    seg.close()
    old = time.time() - 3600
    os.utime(f"/dev/shm/{name}", (old, old))
    before = r.reaped
    assert r.reap_orphan_shm(max_age_s=1800) >= 1
    assert not os.path.exists(f"/dev/shm/{name}")
    assert r.reaped > before


def test_channel_round_trip_reuses_one_segment():
    r = _reg()
    lane = r.channel()
    try:
        a, b = _arr(seed=1), _arr(seed=2)
        ref1 = lane.put(a)
        assert ref1.startswith("shmc:")
        lane_name = ref1.split(":", 2)[1]
        assert lane_name.startswith(SHM_PREFIX)
        np.testing.assert_array_equal(np.asarray(r.resolve(ref1)), a)
        ref2 = lane.put(b)
        assert ref2.split(":", 2)[1] == lane_name
        assert int(ref2.rsplit(":", 1)[1]) == int(ref1.rsplit(":", 1)[1]) + 1
        np.testing.assert_array_equal(np.asarray(r.resolve(ref2)), b)
        assert os.path.exists(f"/dev/shm/{lane_name}")
    finally:
        lane.close()


def test_channel_layout_change_and_growth():
    r = _reg()
    lane = r.channel()
    try:
        name1 = lane.put(_arr((4, 4))).split(":", 2)[1]
        small = np.arange(4, dtype=np.int32)
        ref = lane.put(small)
        assert ref.split(":", 2)[1] == name1
        np.testing.assert_array_equal(np.asarray(r.resolve(ref)), small)
        big = _arr((64, 64), seed=9)
        ref_big = lane.put(big)
        assert ref_big.split(":", 2)[1] != name1
        assert not os.path.exists(f"/dev/shm/{name1}")
        np.testing.assert_array_equal(np.asarray(r.resolve(ref_big)), big)
    finally:
        lane.close()


def test_channel_close_degrades_fresh_attach_with_marker():
    producer, cached, fresh = _reg(), _reg(), _reg()
    lane = producer.channel()
    x = _arr(seed=7)
    ref = lane.put(x)
    np.testing.assert_array_equal(np.asarray(cached.resolve(ref)), x)
    lane.close()
    np.testing.assert_array_equal(np.asarray(cached.resolve(ref)), x)
    with pytest.raises(KeyError) as ei:
        fresh.resolve(ref)
    assert "DeviceTensorRef" in str(ei.value)


def test_channel_rejects_object_dtype():
    lane = _reg().channel()
    try:
        with pytest.raises(ValueError):
            lane.put(np.array(["a", {"b": 1}], dtype=object))
    finally:
        lane.close()


_INTEROP = [
    ("float32", lambda: _arr((3, 5), seed=4)),
    ("int64", lambda: np.arange(12, dtype=np.int64).reshape(3, 4)),
    ("uint8", lambda: np.arange(6, dtype=np.uint8)),
    ("bool", lambda: np.array([[True, False, True]])),
    ("bfloat16", lambda: torch.from_numpy(_arr((2, 7), seed=5)).to(
        torch.bfloat16)),
    ("empty", lambda: np.zeros((0, 3), np.float32)),
]


@pytest.mark.parametrize("kind", ["shm", "lane"])
@pytest.mark.parametrize("name,make", _INTEROP, ids=[n for n, _ in _INTEROP])
def test_port_producer_reference_consumer_same_bytes(kind, name, make):
    """A port export read by the reference's registry: the same ref format
    and the same bytes off the segment (bfloat16 as ``ml_dtypes``')."""
    x = make()
    producer = _reg()
    lane = producer.channel() if kind == "lane" else None
    try:
        ref = lane.put(x) if lane is not None else producer.put_shm(x)
        head = ref.split(":")
        assert head[2] == name.replace("empty", "float32")
        got = jreg.DeviceBufferRegistry().resolve(ref)
        assert np.asarray(got).dtype.name == head[2]
        assert tuple(got.shape) == tuple(x.shape)
        assert np.ascontiguousarray(got).tobytes() == _bytes(x)
    finally:
        if lane is not None:
            lane.close()


@pytest.mark.parametrize("kind", ["shm", "lane"])
@pytest.mark.parametrize("name,make", _INTEROP, ids=[n for n, _ in _INTEROP])
def test_reference_producer_port_consumer_same_bytes(kind, name, make):
    """The reverse: a reference export read by the port's registry."""
    import ml_dtypes

    x = make()
    if isinstance(x, torch.Tensor):  # the reference's bfloat16 array
        x = x.float().numpy().astype(ml_dtypes.bfloat16)
    producer = jreg.DeviceBufferRegistry()
    lane = producer.channel() if kind == "lane" else None
    try:
        ref = lane.put(x) if lane is not None else producer.put_shm(x)
        got = _reg().resolve(ref)
        assert tuple(got.shape) == tuple(x.shape)
        assert _bytes(got) == np.ascontiguousarray(x).tobytes()
    finally:
        if lane is not None:
            lane.close()


# ---------------------------------------------------------------------------
# plane config and counters
# ---------------------------------------------------------------------------


_CONFIGS = [
    {},
    {"seldon.io/graph-plan": "fused"},
    {"seldon.io/device-plane": "true"},
    {"seldon.io/device-plane": "false",
     "seldon.io/device-plane-remote": " SHM "},
    {"seldon.io/device-plane-remote": "loopback"},
    {"seldon.io/device-plane": "banana"},
    {"seldon.io/device-plane": "true",
     "seldon.io/device-plane-remote": "nvlink"},
]


@pytest.mark.parametrize("ann", _CONFIGS)
def test_config_parses_like_the_reference(ann):
    def parse(fn):
        try:
            cfg = fn(ann, "p")
        except ValueError as e:
            return ("error", str(e))
        return None if cfg is None else (cfg.enabled, cfg.remote)

    assert parse(device_plane_config_from_annotations) == parse(
        jplane.device_plane_config_from_annotations)


def test_config_parses_and_validates():
    assert device_plane_config_from_annotations({}, "p") is None
    cfg = device_plane_config_from_annotations(
        {"seldon.io/device-plane": "true"}, "p")
    assert cfg == DevicePlaneConfig(enabled=True, remote="auto")
    with pytest.raises(ValueError, match="p:.*device-plane"):
        device_plane_config_from_annotations(
            {"seldon.io/device-plane": "banana"}, "p")
    with pytest.raises(ValueError, match="auto/loopback/shm/off"):
        device_plane_config_from_annotations(
            {"seldon.io/device-plane": "true",
             "seldon.io/device-plane-remote": "nvlink"}, "p")


def test_deployment_refuses_a_bad_device_plane_at_load():
    from seldon_core_tpu_torch.graph.spec import (
        DeploymentValidationError,
        load_deployment,
    )

    dep = {"metadata": {"name": "d", "annotations": {
        "seldon.io/device-plane": "banana"}},
        "spec": {"predictors": [{"name": "p", "graph": {
            "name": "m", "type": "MODEL"}}]}}
    with pytest.raises(DeploymentValidationError,
                       match="d/p: annotation seldon.io/device-plane"):
        load_deployment(dep)


@pytest.mark.parametrize("remote", ["auto", "loopback", "shm", "off"])
@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("transport", ["GRPC", "REST"])
def test_tier_model_is_the_references(remote, enabled, transport):
    from seldon_core_tpu_torch.runtime import device_plane as tplane

    t = tplane.negotiated_remote_tier(
        tplane.DevicePlaneConfig(enabled, remote), transport)
    j = jplane.negotiated_remote_tier(
        jplane.DevicePlaneConfig(enabled, remote), transport)
    assert t == j
    assert tplane.tier_transfers(t) == jplane.tier_transfers(j)
    assert tplane.RESIDENCY_TIERS == jplane.RESIDENCY_TIERS


def test_plane_counters_roll_up():
    plane = DevicePlane(DevicePlaneConfig(enabled=True))
    jp = jplane.DevicePlane(jplane.DevicePlaneConfig(enabled=True))
    for p in (plane, jp):
        p.note_avoided("d2h", 100)
        p.note_avoided("d2h", 50)
        p.note_avoided("copy", 10)
        p.note_remote_ref("loopback")
        p.note_downgrade("resolve-failed")
        p.note_donation()
    snap = plane.snapshot()
    assert snap == jp.snapshot()
    assert snap["transfersAvoided"] == {"d2h": 2, "copy": 1}
    assert plane.counts() == jp.counts()
    from seldon_core_tpu_torch.runtime.device_plane import device_plane_probe

    assert device_plane_probe(plane)() == plane.counts()


# ---------------------------------------------------------------------------
# metadata without a host copy
# ---------------------------------------------------------------------------


def test_shape_and_nbytes_never_materialize_host_data(monkeypatch):
    msg = SeldonMessage.from_ndarray(torch.zeros((3, 5), dtype=torch.float32))
    monkeypatch.setattr(
        SeldonMessage, "host_data",
        lambda self: (_ for _ in ()).throw(AssertionError("D2H tripwire")))
    assert msg.shape == (3, 5)
    assert msg.nbytes == 3 * 5 * 4
    assert msg.is_device_resident


def test_device_ref_payload_resolves_through_the_registry():
    x = torch.from_numpy(_arr((2, 3)))
    ref = treg.registry.put(x)
    d = {"data": {"names": ["a"], "deviceRef": {
        "ref": ref, "shape": [2, 3], "dtype": "float32", "nbytes": 24}}}
    msg = SeldonMessage.from_dict(d)
    assert msg.data is x and msg.names == ["a"]
    with pytest.raises(KeyError, match="DeviceTensorRef"):
        SeldonMessage.from_dict(d)  # one-shot: consumed


# ---------------------------------------------------------------------------
# engine: the meta-only route
# ---------------------------------------------------------------------------


def _resolver_for(mapping, handle_cls):
    def resolve(unit):
        obj, stype = mapping[unit.name]
        return handle_cls(obj, name=unit.name, service_type=stype)

    return resolve


class _Double:
    accepts_tensors = True
    accepts_jax_arrays = True

    def predict(self, X, names):
        return X * 2


_ROUTED = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
           "children": [{"name": "m", "type": "MODEL"}]}


def test_meta_only_router_skips_d2h_on_device_payload():
    plane = DevicePlane(DevicePlaneConfig(enabled=True))
    eng = GraphEngine(_ROUTED, resolver=_resolver_for(
        {"m": (_Double(), "MODEL")}, ComponentHandle), device_plane=plane)
    x = _arr((2, 4))
    asyncio.run(eng.predict(SeldonMessage.from_ndarray(torch.from_numpy(x))))

    counted = [0]
    orig = SeldonMessage.host_data

    def counting(self):
        counted[0] += 1
        return orig(self)

    before = plane.counts()["device_plane_transfers_avoided"]
    SeldonMessage.host_data = counting
    try:
        out = asyncio.run(eng.predict(
            SeldonMessage.from_ndarray(torch.from_numpy(x))))
    finally:
        SeldonMessage.host_data = orig
    assert counted[0] == 0
    assert plane.counts()["device_plane_transfers_avoided"] > before
    np.testing.assert_allclose(np.asarray(out.host_data()), x * 2, rtol=1e-6)
    assert out.meta.tags.get("device-plane") == "on"


@pytest.mark.parametrize("on", [True, False])
def test_engine_answers_like_the_reference_with_the_plane(on):
    """The routed graph with the plane on and off: the port's answer (data,
    routing, requestPath, tags) is the reference's."""
    import jax.numpy as jnp

    x = _arr((2, 4), seed=6)
    tp = DevicePlane(DevicePlaneConfig(enabled=on))
    jp = jplane.DevicePlane(jplane.DevicePlaneConfig(enabled=on))
    teng = GraphEngine(_ROUTED, resolver=_resolver_for(
        {"m": (_Double(), "MODEL")}, ComponentHandle), device_plane=tp)
    jeng = JEngine(_ROUTED, resolver=_resolver_for(
        {"m": (_Double(), "MODEL")}, JHandle), device_plane=jp)
    t = asyncio.run(teng.predict(SeldonMessage.from_ndarray(
        torch.from_numpy(x)))).to_dict()
    j = jeng.predict_sync(JMessage.from_ndarray(jnp.asarray(x))).to_dict()
    for d in (t, j):
        d["meta"].pop("puid")
    assert t == j
    assert ("device-plane" in t["meta"].get("tags", {})) == on


def test_residency_map_is_the_references():
    """The planned tier of every edge of a fused plan (a chain, an
    ensemble under it, a remote node), plane on and off."""
    graph = {"name": "t", "type": "TRANSFORMER", "parameters": [
        {"name": "model_class", "type": "STRING",
         "value": "PKG.mlp:MNISTMLP"}],
        "children": [{"name": "c", "type": "COMBINER",
                      "implementation": "AVERAGE_COMBINER",
                      "children": [{"name": "a", "type": "MODEL"},
                                   {"name": "rem", "type": "MODEL",
                                    "endpoint": {"service_host": "h",
                                                 "service_port": 1,
                                                 "type": "GRPC"}}]}]}

    class Ident:
        def transform_input_fn(self, X):
            return X

        def predict_fn(self, X):
            return X

    class Remote:
        def predict(self, X, names):
            return X

    def spec(pkg):
        import json

        return json.loads(json.dumps(graph).replace("PKG", pkg))

    def resolver(handle_cls):
        def resolve(u):
            obj = Remote() if u.name == "rem" else Ident()
            return handle_cls(obj, name=u.name,
                              service_type=u.resolved_type)

        return resolve

    t = GraphEngine(spec("seldon_core_tpu_torch.models"),
                    resolver=resolver(ComponentHandle), plan_mode="fused")
    j = JEngine(spec("seldon_core_tpu.models"), resolver=resolver(JHandle),
                plan_mode="fused")
    for ann in ({}, {"seldon.io/device-plane": "true"},
                {"seldon.io/device-plane": "true",
                 "seldon.io/device-plane-remote": "shm"}):
        assert t.plan.residency_map(ann) == j.plan.residency_map(ann)


# ---------------------------------------------------------------------------
# framed: negotiation, reply in kind, downgrades
# ---------------------------------------------------------------------------


class _Echo:
    def predict(self, msg):
        return type(msg)(data=msg.data, names=list(msg.names))


def _plane(remote="auto"):
    return DevicePlane(DevicePlaneConfig(enabled=True, remote=remote))


def test_framed_negotiates_loopback_in_process():
    plane = _plane()
    with tframed.FramedComponentServer(_Echo(), device_plane=plane) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            assert cli._device_mode == "loopback"
            x = _arr((4, 4), seed=5)
            out = cli.predict(SeldonMessage.from_ndarray(x))
            np.testing.assert_array_equal(np.asarray(out.data), x)
            assert plane.snapshot()["remoteRefs"].get("loopback", 0) >= 1
        finally:
            cli.close()


def test_framed_shm_cap_forces_pooled_lane_and_reply_in_kind():
    plane = _plane(remote="shm")
    with tframed.FramedComponentServer(_Echo(), device_plane=plane) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            assert cli._device_mode == "shm"
            assert cli._lane is not None
            for seed in (6, 7):
                x = _arr((8, 16), seed=seed)
                out = cli.predict(SeldonMessage.from_ndarray(x))
                np.testing.assert_array_equal(np.asarray(out.data), x)
                assert out.device_wire_mode == "shm"
            assert plane.snapshot()["remoteRefs"].get("shm", 0) >= 2
        finally:
            cli.close()


def test_framed_remote_off_keeps_bytes():
    plane = _plane(remote="off")
    with tframed.FramedComponentServer(_Echo(), device_plane=plane) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            assert cli._device_mode == "off"
            x = _arr((2, 2))
            out = cli.predict(SeldonMessage.from_ndarray(x))
            np.testing.assert_array_equal(np.asarray(out.data), x)
        finally:
            cli.close()


def test_framed_planeless_server_replies_bytes():
    plane = _plane()
    with tframed.FramedComponentServer(_Echo()) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            x = _arr((2, 3))
            out = cli.predict(SeldonMessage.from_ndarray(x))
            np.testing.assert_array_equal(np.asarray(out.data), x)
            assert out.device_wire_mode == "off"
        finally:
            cli.close()


def test_framed_negotiation_downgrades_against_old_server(monkeypatch):
    monkeypatch.setattr(tframed, "_is_plane_hello", lambda m: False)
    plane = _plane()
    with tframed.FramedComponentServer(_Echo(), device_plane=plane) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            assert cli._device_mode == "off"
            assert plane.snapshot()["downgrades"].get("negotiation", 0) >= 1
            monkeypatch.undo()
            x = _arr((2, 3))
            out = cli.predict(SeldonMessage.from_ndarray(x))
            np.testing.assert_array_equal(np.asarray(out.data), x)
        finally:
            cli.close()


class _FailOnceWithMarker:
    def __init__(self):
        self.calls = 0

    def predict(self, msg):
        self.calls += 1
        if self.calls == 1:
            raise KeyError("shm DeviceTensorRef lane gone (test)")
        return type(msg)(data=msg.data, names=list(msg.names))


@pytest.mark.parametrize("client", ["sync", "async"])
def test_framed_client_downgrade_retries_as_bytes_and_sticks(client):
    plane = _plane(remote="shm")
    target = _FailOnceWithMarker()
    x = _arr((4, 4), seed=8)
    with tframed.FramedComponentServer(target, device_plane=plane) as srv:
        if client == "async":
            async def go():
                c = await tframed.AsyncFramedClient(
                    timeout=TIMEOUT, device_plane=plane).connect(
                        "127.0.0.1", srv.port)
                try:
                    m0 = c._device_mode
                    o = await c.predict(SeldonMessage.from_ndarray(x))
                    return m0, o, c._device_mode, c._lane
                finally:
                    c.close()

            mode0, out, mode1, lane = _run(go())
        else:
            cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                       timeout=TIMEOUT)
            try:
                mode0 = cli._device_mode
                out = cli.predict(SeldonMessage.from_ndarray(x))
                mode1, lane = cli._device_mode, cli._lane
            finally:
                cli.close()
        assert mode0 == "shm"
        np.testing.assert_array_equal(np.asarray(out.data), x)
        assert target.calls == 2
        assert mode1 == "off"
        assert lane is None
        assert plane.snapshot()["downgrades"].get("resolve-failed", 0) >= 1


# the reference's rule for two processes on one host: a port registry
# and a reference registry never share a token, so ``auto`` and ``shm``
# meet on the shm tier and ``loopback`` finds a foreign process
_PAIRED = {"auto": "shm", "shm": "shm", "loopback": "off", "off": "off"}


@pytest.mark.parametrize("remote", sorted(_PAIRED))
def test_port_client_against_reference_framed_server(remote):
    x = _arr((5, 6), seed=10)
    plane = _plane(remote)
    jp = jplane.DevicePlane(jplane.DevicePlaneConfig(enabled=True,
                                                     remote=remote))
    with jframed.FramedComponentServer(JHandle(_EchoJ(), name="e"),
                                       device_plane=jp) as srv:
        cli = tframed.FramedClient(port=srv.port, device_plane=plane,
                                   timeout=TIMEOUT)
        try:
            assert cli._device_mode == _PAIRED[remote]
            outs = [cli.predict(SeldonMessage.from_ndarray(x))
                    for _ in range(2)]
        finally:
            cli.close()
        jcli = jframed.FramedClient(port=srv.port, device_plane=jp)
        try:
            want = jcli.predict(JMessage.from_ndarray(x))
        finally:
            jcli.close()
    for out in outs:
        assert _bytes(np.asarray(out.data)) == _bytes(
            np.asarray(want.data))
        assert out.device_wire_mode == (
            "shm" if _PAIRED[remote] == "shm" else "off")


@pytest.mark.parametrize("remote", sorted(_PAIRED))
def test_reference_client_against_port_framed_server(remote):
    x = _arr((5, 6), seed=11)
    plane = _plane(remote)
    jp = jplane.DevicePlane(jplane.DevicePlaneConfig(enabled=True,
                                                     remote=remote))
    with tframed.FramedComponentServer(ComponentHandle(_EchoJ(), name="e"),
                                       device_plane=plane) as srv:
        jcli = jframed.FramedClient(port=srv.port, device_plane=jp)
        try:
            assert jcli._device_mode == _PAIRED[remote]
            outs = [jcli.predict(JMessage.from_ndarray(x)) for _ in range(2)]
        finally:
            jcli.close()
        cli = tframed.FramedClient(port=srv.port, timeout=TIMEOUT)
        try:
            want = cli.predict(SeldonMessage.from_ndarray(x))
        finally:
            cli.close()
    for out in outs:
        assert np.asarray(out.data).tobytes() == _bytes(
            np.asarray(want.data))
        assert out.device_wire_mode == (
            "shm" if _PAIRED[remote] == "shm" else "off")


class _EchoJ:
    def predict(self, X, names):
        return np.asarray(X) * 3.0


# ---------------------------------------------------------------------------
# REST: the identity header and refs per peer
# ---------------------------------------------------------------------------


def test_rest_negotiates_per_peer_and_counts():
    """The port's RemoteComponent with a plane: the first call rides bytes
    and learns the peer's identity; to a port server in this process the
    next call rides a loopback ref, to a reference server (another
    registry on this host) a one-shot shm segment; every answer equals
    the plane-off one (binTensor: an ndarray body loses the dtype on the
    byte path, in the reference too)."""
    x = _arr((3, 4), seed=12)

    async def run():
        tsrv = await RestServer(component=ComponentHandle(_EchoJ(), name="e"),
                                host="127.0.0.1", port=0).start()
        jsrv = await start_server(build_app(component=JHandle(
            _EchoJ(), name="e")), "127.0.0.1", 0)
        urls = {"port": f"http://127.0.0.1:{tsrv.port}",
                "ref": f"http://127.0.0.1:{jsrv.addresses[0][1]}"}
        res = {}
        try:
            for peer, url in urls.items():
                plane = _plane()
                c = RemoteComponent(url, name="e", device_plane=plane)
                off = RemoteComponent(url, name="e")
                try:
                    outs = [await c.predict(SeldonMessage.from_ndarray(x, encoding="binTensor"))
                            for _ in range(3)]
                    want = await off.predict(SeldonMessage.from_ndarray(x, encoding="binTensor"))
                finally:
                    await c.close()
                    await off.close()
                res[peer] = (c._device_mode(), plane.snapshot(),
                             [o.to_dict()["data"] for o in outs],
                             want.to_dict()["data"])
        finally:
            await tsrv.stop()
            await jsrv.cleanup()
        return res

    res = _run(run())
    for peer, mode in (("port", "loopback"), ("ref", "shm")):
        got_mode, snap, outs, want = res[peer]
        assert got_mode == mode
        assert snap["remoteRefs"] == {mode: 2}
        assert snap["downgrades"] == {}
        assert all(o == want for o in outs)


def test_rest_resolve_failure_downgrades_to_bytes_for_good():
    """A peer that cannot resolve the ref answers 400 naming
    DeviceTensorRef: the same request goes again as bytes, and the peer
    stays on bytes (counted once)."""
    x = _arr((2, 2), seed=13)

    async def run():
        srv = await RestServer(component=ComponentHandle(_EchoJ(), name="e"),
                               host="127.0.0.1", port=0).start()
        plane = _plane()
        c = RemoteComponent(f"http://127.0.0.1:{srv.port}", name="e",
                            device_plane=plane)
        try:
            await c.predict(SeldonMessage.from_ndarray(x, encoding="binTensor"))
            # the peer now names another process on another host
            c._peer_plane = f"not-{process_token()}|" + treg.host_token()
            c.device_plane.config = DevicePlaneConfig(True, "shm")
            real = treg.registry.put_shm
            treg.registry.put_shm = lambda a: "shm:gone:float32:2,2"
            try:
                outs = [await c.predict(SeldonMessage.from_ndarray(x, encoding="binTensor"))
                        for _ in range(2)]
            finally:
                treg.registry.put_shm = real
            return plane.snapshot(), c._device_mode(), outs
        finally:
            await c.close()
            await srv.stop()

    snap, mode, outs = _run(run())
    assert snap["downgrades"] == {"resolve-failed": 1}
    assert mode == "off"
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o.data), x * 3.0)


@pytest.mark.parametrize("meta_only", [True, False])
def test_remote_meta_only_route_sends_no_tensor_like_the_reference(meta_only):
    x = torch.from_numpy(_arr((2, 2), seed=14))

    class Router:
        accepts_messages = True

        def __init__(self):
            self.seen = []

        def route(self, msg):
            self.seen.append(msg.data is None)
            return 0

    async def run():
        router = Router()
        srv = await RestServer(component=ComponentHandle(router, name="r"),
                               host="127.0.0.1", port=0).start()
        plane = _plane()
        c = RemoteComponent(f"http://127.0.0.1:{srv.port}", name="r",
                            route_meta_only=meta_only, device_plane=plane)
        try:
            branch = await c.route(SeldonMessage.from_ndarray(x))
        finally:
            await c.close()
            await srv.stop()
        return branch, router.seen, plane.snapshot()

    branch, seen, snap = _run(run())
    assert branch == 0 and seen == [meta_only]
    assert ("d2h" in snap["transfersAvoided"]) == meta_only


# ---------------------------------------------------------------------------
# proto: the DeviceTensorRef arm
# ---------------------------------------------------------------------------


def test_proto_loopback_ref_hands_back_the_tensor():
    x = torch.from_numpy(_arr((2, 3)))
    p = message_to_proto(SeldonMessage.from_ndarray(x, names=["a"]),
                         device_refs=True)
    assert p.data.WhichOneof("data_oneof") == "device"
    assert p.data.device.dtype == "float32"
    assert list(p.data.device.shape) == [2, 3]
    out = message_from_proto(p)
    assert out.data is x and out.names == ["a"]
    # a host array is not device resident: bytes, as the reference sends
    h = message_to_proto(SeldonMessage.from_ndarray(_arr()),
                         device_refs=True)
    assert h.data.WhichOneof("data_oneof") != "device"


def test_proto_shm_refs_cross_between_the_packages():
    x = _arr((3, 2), seed=15)
    p = message_to_proto(SeldonMessage.from_ndarray(x), device_refs="shm")
    j = jpb.SeldonMessage.FromString(p.SerializeToString())
    got = j_from_proto(j)
    assert np.asarray(got.data).tobytes() == x.tobytes()
    jp = j_to_proto(JMessage.from_ndarray(x), device_refs="shm")
    t = message_from_proto(tpb.SeldonMessage.FromString(
        jp.SerializeToString()))
    assert np.asarray(t.data).tobytes() == x.tobytes()
    assert t.encoding == "device"


def test_foreign_proto_ref_raises_with_marker():
    p = tpb.SeldonMessage()
    p.data.device.buffer_uuid = "not-this-process/uuid"
    with pytest.raises(ForeignProcessRef, match="DeviceTensorRef"):
        message_from_proto(p)


@pytest.mark.parametrize("env,want", [("", False), ("1", True),
                                      ("shm", "shm")])
def test_grpc_client_device_refs_from_env(monkeypatch, env, want):
    from seldon_core_tpu_torch.serving.grpc_api import GrpcComponentClient

    monkeypatch.setenv("SELDON_DEVICE_REFS", env)
    assert GrpcComponentClient("127.0.0.1:1").device_refs == want
