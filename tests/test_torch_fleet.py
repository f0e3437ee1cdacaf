"""The port's fleet data plane (``seldon_core_tpu_torch/fleet/`` and
``operator/local.py`` ``LocalFleet``) against the reference's on the CPU.

- ``HashRing``: the vnode positions and their owners, every lookup (with
  and without excluded members) and the remaps on membership change EQUAL.
- ``ReplicaPool`` under each policy (round-robin, least-loaded,
  consistent-hash, session affinity): the same scripted sequence of picks,
  loads, ejections, verdicts, headroom, penalties and clock steps on a
  ``FakeClock`` gives EQUAL picks and EQUAL snapshots, metric series and
  decision records (``ts`` left out).
- ``_decorrelated_backoff`` sequences from one seed, ``Autoscaler``
  decisions over one signal script, ``fleet_body`` answers and the
  registry EQUAL.
- The gateway over a ``LocalFleet``: killing a replica mid-traffic keeps
  every answer 200, the pool ejects it, and the engine's ``/admin/fleet``
  lists the replica set; ``autoscale_tick`` grows and shrinks membership
  as the reference's does; with ``seldon.io/artifact-store`` a replica
  added by ``autoscale_tick`` answers bitwise as the cold first one.
"""

import asyncio
import json
import random

import numpy as np
import pytest

from seldon_core_tpu.fleet import autoscale as jautoscale
from seldon_core_tpu.fleet import http as jhttp
from seldon_core_tpu.fleet import observe as jobserve
from seldon_core_tpu.fleet import registry as jregistry
from seldon_core_tpu.fleet.config import FleetConfig as JConfig
from seldon_core_tpu.fleet.pool import ReplicaPool as JPool
from seldon_core_tpu.fleet.ring import HashRing as JRing
from seldon_core_tpu.gateway.app import _decorrelated_backoff as jbackoff
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch.fleet import autoscale as tautoscale
from seldon_core_tpu_torch.fleet import http as thttp
from seldon_core_tpu_torch.fleet import observe as tobserve
from seldon_core_tpu_torch.fleet import registry as tregistry
from seldon_core_tpu_torch.fleet.config import FleetConfig as TConfig
from seldon_core_tpu_torch.fleet.pool import ReplicaPool as TPool
from seldon_core_tpu_torch.fleet.ring import HashRing as TRing
from seldon_core_tpu_torch.gateway.app import _decorrelated_backoff as tbackoff
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

TIMEOUT = 60
KEYS = [f"blake2b-key-{i}" for i in range(1000)]


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for reg in (jregistry, tregistry):
        reg.clear()
    # a fresh process-default decision ring per test in both packages, so
    # no test reads another's records (or its late ones)
    for ob in (jobserve, tobserve):
        monkeypatch.setattr(ob, "_DEFAULT_AUDIT", ob.DecisionAudit())
    yield
    for reg in (jregistry, tregistry):
        reg.clear()


# ---- ring ------------------------------------------------------------------

@pytest.mark.parametrize("members", [["m0", "m1", "m2"],
                                     [f"http://127.0.0.1:{8000 + i}"
                                      for i in range(5)]])
def test_ring_positions_and_lookups_equal(members):
    j, t = JRing(members), TRing(list(reversed(members)))
    assert t._points == j._points and t._owner == j._owner
    assert t.describe() == j.describe()
    assert [t.lookup(k) for k in KEYS] == [j.lookup(k) for k in KEYS]
    ex = {members[0], members[2]}
    assert [t.lookup(k, exclude=ex) for k in KEYS[:200]] == \
        [j.lookup(k, exclude=ex) for k in KEYS[:200]]
    for ring in (j, t):
        ring.remove(members[1])
        ring.add("late")
    assert t._points == j._points
    assert [t.lookup(k) for k in KEYS] == [j.lookup(k) for k in KEYS]


# ---- pool + policies -------------------------------------------------------

def _script(pool, clk, policy: str) -> list:
    """One scripted life of a pool: picks under load, ejection, half-open
    readmission, verdicts, headroom, penalties, a membership change and
    sessions.  Returns every observable: pick rids, states, snapshots."""
    out = []
    rep = {r.url: r for r in pool.replicas()}

    def pick(**kw):
        r = pool.pick(**kw)
        out.append(r.rid if r is not None else None)
        return r

    for i in range(6):
        r = pick(key=f"k{i % 3}")
        pool.acquire(r)
        if i % 2:
            pool.release(r, ok=True, latency_ms=10.0 + i)
    rep["u1"].inflight = 3
    pool.note_headroom("u2", 0.25)
    pool.note_penalty("u3", 1.5)
    for i in range(5):
        pick(key=KEYS[i])
    pool.eject(rep["u2"], "connect-error")
    pool.eject(rep["u2"], "connect-error")
    for i in range(4):
        pick(key=KEYS[i], exclude=["u1"])
    clk.t += 2.5
    r = pick(key="k0")
    out.append(pool.snapshot())
    pool.note_verdict("u2", "ok")
    pool.note_verdict("u3", "critical")
    pool.note_verdict("u4", "ok", open_breakers=("clf",))
    clk.t += 3.0
    for i in range(3):
        pick(session="sse-1")
    pick(session="sse-2", key="k1")
    pool.set_members(["u2", "u3", "u4", "u5"])
    for i in range(6):
        pick(key=KEYS[10 + i])
        pick(session="sse-1")
    assert pool.probe_due(5.0) and not pool.probe_due(5.0)
    out.append(pool.snapshot())
    return out


def _series(reg) -> list:
    return [ln for ln in reg.render().splitlines() if not ln.startswith("#")]


@pytest.mark.parametrize("policy", ["round-robin", "least-loaded",
                                    "consistent-hash"])
def test_pool_picks_and_snapshots_equal(policy):
    members = ("u1", "u2", "u3", "u4")
    runs = []
    for Pool, Config, Reg, ob in ((JPool, JConfig, JRegistry, jobserve),
                                  (TPool, TConfig, TRegistry, tobserve)):
        clk, reg = FakeClock(), Reg()
        pool = Pool("dep", config=Config(enabled=True, policy=policy),
                    members=members, metrics=reg, clock=clk)
        obs = _script(pool, clk, policy)
        decisions = [{k: v for k, v in d.items() if k != "ts"}
                     for d in ob.decision_audit().query(n=100)]
        runs.append((obs, _series(reg), decisions))
    assert runs[1] == runs[0]
    assert runs[1][2], "the script ejects and readmits"


def test_empty_pool_and_tier_fallback_equal():
    for Pool, Config in ((JPool, JConfig), (TPool, TConfig)):
        assert Pool("d", config=Config(enabled=True)).pick() is None
    picks = []
    for Pool, Config in ((JPool, JConfig), (TPool, TConfig)):
        pool = Pool("d", config=Config(enabled=True), members=("a", "b"),
                    clock=FakeClock())
        for r in pool.replicas():
            pool.eject(r, "probe-failed")
        picks.append([pool.pick().rid,
                      pool.pick(exclude={"a", "b"}).rid])
    assert picks[0] == picks[1]


def test_backoff_sequences_equal():
    for seed in (0, 1, 7):
        seqs = []
        for fn in (jbackoff, tbackoff):
            rng, prev, seq = random.Random(seed), 0.0, []
            for _ in range(50):
                prev = fn(rng, 0.05, prev)
                seq.append(prev)
            seq.append(fn(rng, 0.05, 50.0, cap_s=0.25))
            seqs.append(seq)
        assert seqs[0] == seqs[1]
        assert all(0.05 <= s <= 1.0 for s in seqs[1])


def test_autoscale_decisions_equal():
    script = [
        dict(current=1, demand_rps=20.0, capacity_rps=10.0),
        dict(current=3, demand_rps=1.0, capacity_rps=30.0),
        ("tick", 11.0),
        dict(current=3, demand_rps=1.0, capacity_rps=30.0),
        dict(current=1),
        dict(current=2, burn_critical=True),
        dict(current=3, demand_rps=1.0, capacity_rps=30.0, burn_warn=True),
        dict(current=5, demand_rps=100.0, capacity_rps=10.0),
        ("tick", 100.0),
        dict(current=4, demand_rps=8.0, capacity_rps=40.0),
        dict(current=2, demand_rps=0.0, capacity_rps=20.0),
    ]
    runs = []
    for mod, Config in ((jautoscale, JConfig), (tautoscale, TConfig)):
        clk = FakeClock()
        s = mod.Autoscaler(Config(enabled=True, replicas=1, autoscale=True,
                                  min_replicas=1, max_replicas=5,
                                  cooldown_s=10.0), clock=clk)
        out = []
        for step in script:
            if isinstance(step, tuple):
                clk.t += step[1]
                continue
            d = s.decide(**step)
            out.append((d.to_dict(), d.changed))
        runs.append(out)
    assert runs[0] == runs[1]
    assert {d["desired"] for d, _ in runs[1]} >= {1, 3, 5}


def test_fleet_body_and_registry_equal():
    def pools(Pool, Config):
        return {"a": Pool("a", config=Config(enabled=True),
                          members=("u1", "u2"), clock=FakeClock()),
                "b": None}

    jp, tp = pools(JPool, JConfig), pools(TPool, TConfig)
    for plane_j, plane_t, q in (
            (None, None, {}), (jp, tp, {}), (jp, tp, {"deployment": "a"}),
            (jp, tp, {"deployment": "nope"}), ({"b": None}, {"b": None}, {}),
            (jp["a"], tp["a"], {})):
        assert thttp.fleet_body(plane_t, q) == jhttp.fleet_body(plane_j, q)
    for reg in (jregistry, tregistry):
        reg.publish("d1", lambda: {"policy": "round-robin"})
        reg.publish("d2", lambda: 1 / 0)
    for name in ("d1", "d2", "d3"):
        assert tregistry.snapshot(name) == jregistry.snapshot(name)
    tregistry.unpublish("d1")
    assert tregistry.snapshot("d1") is None


# ---- the gateway over a LocalFleet -----------------------------------------

def _iris_dep(name: str, ann: dict, model_class: str) -> dict:
    return {"metadata": {"name": name, "annotations": {
        "seldon.io/batching": "false", **ann}},
        "spec": {"predictors": [{
            "name": "p", "replicas": 1,
            "graph": {"name": "clf", "type": "MODEL", "parameters": [{
                "name": "model_class", "value": model_class,
                "type": "STRING"}], "children": []}}]}}


TIRIS = "seldon_core_tpu_torch.models.iris:IrisClassifier"
BODY = json.dumps({"meta": {"puid": "ab" * 16},
                   "data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}).encode()


async def _token(http, base: str) -> dict:
    st, _, body = await http.request(
        "POST", base + "/oauth/token",
        b"grant_type=client_credentials&client_id=k&client_secret=s",
        {"Content-Type": "application/x-www-form-urlencoded"})
    assert st == 200
    return {"Authorization": f"Bearer {json.loads(body)['access_token']}",
            "Content-Type": "application/json"}


def test_replica_kill_failover_through_the_gateway():
    from seldon_core_tpu_torch.gateway.app import Gateway
    from seldon_core_tpu_torch.gateway.store import (
        DeploymentRecord,
        DeploymentStore,
    )
    from seldon_core_tpu_torch.operator.local import LocalFleet
    from seldon_core_tpu_torch.serving.client import HttpSession

    ann = {"seldon.io/fleet-replicas": "3",
           "seldon.io/fleet-policy": "round-robin"}

    async def go():
        fl = await LocalFleet(_iris_dep("fleet-chaos", ann, TIRIS),
                              device="cpu", seed=3).start()
        store = DeploymentStore()
        store.put(DeploymentRecord(name="fleet-chaos", oauth_key="k",
                                   oauth_secret="s", engine_urls=fl.urls(),
                                   annotations=ann))
        gw = Gateway(store)
        srv = await gw.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{srv.port}"
        http = HttpSession()
        try:
            hdr = await _token(http, base)
            answers, served = set(), []
            for _ in range(6):
                st, h, b = await http.request(
                    "POST", base + "/api/v0.1/predictions", BODY, hdr)
                assert st == 200
                served.append(h["x-seldon-replica"])
                d = json.loads(b)
                answers.add(json.dumps(d["data"]))
            assert sorted(set(served)) == ["r0", "r1", "r2"]
            st, _, b = await http.request(
                "GET", fl.replicas()[1]["url"] + "/admin/fleet")
            snap = json.loads(b)
            assert st == 200 and snap["deployment"] == "fleet-chaos"
            assert [r["replica"] for r in snap["replicas"]] == \
                ["r0", "r1", "r2"]
            await fl.kill(0)
            for _ in range(12):
                st, h, b = await http.request(
                    "POST", base + "/api/v0.1/predictions", BODY, hdr)
                assert st == 200 and h["x-seldon-replica"] != "r0"
                answers.add(json.dumps(json.loads(b)["data"]))
            assert len(answers) == 1  # every replica answers the same
            st, _, b = await http.request(
                "GET", base + "/admin/fleet?deployment=fleet-chaos")
            killed = json.loads(b)["replicas"][0]
            assert killed["ejections"] >= 1
            assert killed["ejectReason"] in ("connect-error", "probe-failed")
            st, _, b = await http.request(
                "GET", fl.replicas()[1]["url"] + "/admin/fleet")
            assert json.loads(b)["replicas"][0]["state"] == "killed"
        finally:
            await http.close()
            await gw.close()
            await fl.stop()

    _run(go())


def test_local_fleet_autoscale_as_the_reference():
    """The same signal script grows and shrinks both harnesses alike; the
    port's membership, snapshot and decision records match."""
    from seldon_core_tpu.operator.local import LocalFleet as JFleet
    from seldon_core_tpu.operator.spec import SeldonDeployment
    from seldon_core_tpu_torch.operator.local import LocalFleet as TFleet

    ann = {"seldon.io/fleet-replicas": "1",
           "seldon.io/fleet-autoscale": "true",
           "seldon.io/fleet-max-replicas": "3",
           "seldon.io/fleet-cooldown-s": "60"}
    script = [{"demandRps": 20.0, "capacityRps": 10.0},
              {"demandRps": 1.0, "capacityRps": 30.0}, "rewind",
              {"demandRps": 1.0, "capacityRps": 30.0}]

    async def drive(fl):
        await fl.start()
        out = []
        try:
            for step in script:
                if step == "rewind":
                    fl.autoscaler._last_scale -= 61.0
                    continue
                d = await fl.autoscale_tick(step)
                snap = fl.snapshot()
                out.append((d.to_dict(), len(fl), snap["desired"],
                            [r["replica"] for r in snap["replicas"]],
                            snap["policy"], snap["autoscale"]))
        finally:
            await fl.stop()
        return out

    async def go():
        j = await drive(JFleet(SeldonDeployment.from_dict(_iris_dep(
            "fleet-as", ann, "seldon_core_tpu.models.iris:IrisClassifier"))))
        t = await drive(TFleet(_iris_dep("fleet-as", ann, TIRIS),
                               device="cpu"))
        assert t == j
        assert [len_ for _, len_, *_ in t] == [3, 3, 1]
        strip = [{k: v for k, v in d.items() if k != "ts"}
                 for d in tobserve.decision_audit().query(kind="autoscale")]
        jstrip = [{k: v for k, v in d.items() if k != "ts"}
                  for d in jobserve.decision_audit().query(kind="autoscale")]
        assert strip == jstrip and len(strip) == 2
        assert tregistry.snapshot("fleet-as") is None

    _run(go(), 120)


def test_warm_respawn_answers_as_the_cold_replica(tmp_path):
    """A fused fleet on an artifact store: the replica autoscale adds boots
    from the store the first one published to, records its coverage, and
    answers bitwise as the first."""
    from seldon_core_tpu_torch.operator.local import LocalFleet
    from seldon_core_tpu_torch.serving.client import HttpSession

    ann = {"seldon.io/fleet-replicas": "1",
           "seldon.io/fleet-max-replicas": "2",
           "seldon.io/graph-plan": "fused",
           "seldon.io/artifact-store": str(tmp_path / "store")}

    async def go():
        fl = await LocalFleet(_iris_dep("warm", ann, TIRIS), device="cpu",
                              seed=1).start()
        http = HttpSession()
        try:
            d = await fl.autoscale_tick({"demandRps": 20.0,
                                         "capacityRps": 10.0})
            assert d.desired == 2 and len(fl) == 2
            outs = []
            for rep in fl.replicas():
                st, h, b = await http.request(
                    "POST", rep["url"] + "/api/v0.1/predictions", BODY,
                    {"Content-Type": "application/json"})
                assert st == 200 and h["x-seldon-replica"] == rep["rid"]
                outs.append(json.loads(b)["data"])
                assert "artifact_coverage" in rep
            assert outs[0] == outs[1]
            np.testing.assert_array_equal(outs[0]["ndarray"],
                                          outs[1]["ndarray"])
            snap = fl.snapshot()
            assert all("artifactCoverage" in r for r in snap["replicas"])
        finally:
            await http.close()
            await fl.stop()

    _run(go())


def test_a_kill_drains_a_request_whose_body_is_still_arriving():
    """A replica's kill (``LocalFleet.kill``: ``RestServer.stop(drain_s)``)
    lets every request in hand finish, and a request is in hand from its
    headers on, as the reference's aiohttp server counts it (its handler,
    and ``_request_in_progress``, start once the headers are parsed; the
    reference's kill is ``runner.cleanup()``'s graceful shutdown).  A
    large body (the fleet drill's 800 KB binTensor images) still arriving
    when the kill starts is read and answered, not cut (the gateway would
    answer that request 503: the engine may have read it)."""
    from seldon_core_tpu_torch.serving.rest import Response, RestServer

    body = b"x" * 200_000

    async def echo(req):
        return Response(200, json.dumps({"n": len(req.body)}).encode())

    async def go():
        srv = RestServer(host="127.0.0.1", port=0)
        srv.add_route("POST", "/echo", echo)
        await srv.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            writer.write(b"POST /echo HTTP/1.1\r\nHost: t\r\nContent-Length: "
                         + str(len(body)).encode() + b"\r\n\r\n"
                         + body[:1000])
            await writer.drain()
            await asyncio.sleep(0.2)  # the server holds the headers
            stopping = asyncio.ensure_future(srv.stop(drain_s=10.0))
            await asyncio.sleep(0.2)
            writer.write(body[1000:])
            await writer.drain()
            status = await asyncio.wait_for(reader.readline(), 10)
            rest = await asyncio.wait_for(reader.read(), 10)
            await stopping
            return status, rest
        finally:
            writer.close()

    status, rest = asyncio.run(go())
    assert status.startswith(b"HTTP/1.1 200"), status
    assert rest.endswith(json.dumps({"n": len(body)}).encode())
    assert b"connection: close" in rest.lower()
