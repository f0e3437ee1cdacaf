"""The port's fleet observer (``seldon_core_tpu_torch/fleet/observe.py``)
against the reference's on the CPU.

- ``skew_scores`` and ``detect_outliers`` over seeded fleets, the
  ``DecisionAudit`` ring (records without ``ts``, stats, resize),
  ``flatten_spans`` and the four mergers: EQUAL.
- ``FleetObserver`` scrapes over real sockets: three replica servers with
  seeded flight records and a dead URL, scraped by the port's observer on
  its ``HttpSession`` and by the reference's on an aiohttp session.  Every
  ``/admin/fleet/{health,flightrecorder,profile,capacity,traces}``
  envelope is EQUAL with the timing fields (``scrapeMs``, ``cached``)
  named and left out; the dead replica is ``{"unreachable": true}`` in a
  ``partial`` envelope in both, its ``error`` the same text after the
  exception's class name (``ConnectError`` beside aiohttp's
  ``ClientConnectorError``).  The exported ``seldon_fleet_obs_*`` series
  and the straggler penalty fed to the pool are EQUAL.
- The engine's and the gateway's ``/admin/fleet/*`` routes over a
  ``LocalFleet`` with a killed replica answer the same envelope, never a
  500; a fleetless engine answers the reference's 404 body and its
  decisions.
"""

import asyncio
import json
import random

import aiohttp
import pytest

from seldon_core_tpu.fleet import observe as jobs
from seldon_core_tpu.fleet.config import FleetConfig as JConfig
from seldon_core_tpu.fleet.pool import ReplicaPool as JPool
from seldon_core_tpu.utils.metrics import MetricsRegistry as JRegistry
from seldon_core_tpu_torch.fleet import observe as tobs
from seldon_core_tpu_torch.fleet.config import FleetConfig as TConfig
from seldon_core_tpu_torch.fleet.pool import ReplicaPool as TPool
from seldon_core_tpu_torch.serving.client import HttpSession
from seldon_core_tpu_torch.serving.rest import Response, RestServer
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

TIMEOUT = 60
TIMING = ("scrapeMs", "cached")


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _strip(x):
    """The envelope without its timing fields, and each unreachable
    replica's ``error`` without the exception's class name."""
    if isinstance(x, dict):
        out = {k: _strip(v) for k, v in x.items() if k not in TIMING}
        if x.get("unreachable") is True and "error" in x:
            out["error"] = x["error"].split(": ", 1)[1]
        return out
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


# ---- pure functions --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_skew_and_outliers_equal(seed):
    rng = random.Random(seed)
    n = rng.randint(1, 7)
    vals = {f"r{i}": rng.uniform(1, 20) for i in range(n)}
    if n > 2 and seed % 2:
        vals["r0"] *= 10  # a straggler
    assert tobs.skew_scores(vals) == jobs.skew_scores(vals)
    for k in (1.0, 3.5):
        assert tobs.detect_outliers(vals, mad_k=k) == \
            jobs.detect_outliers(vals, mad_k=k)


def test_decision_audit_equal():
    out = []
    for mod in (jobs, tobs):
        a = mod.DecisionAudit(capacity=4)
        for i in range(6):
            a.record("eject" if i % 2 else "autoscale", deployment="d",
                     replica=f"r{i % 3}", reason=f"why{i}", extra=i,
                     skipped=None)
        a.resize(3)
        q = [a.query(), a.query(kind="eject"), a.query(replica="r1", n=1),
             a.query(deployment="x")]
        out.append(([[{k: v for k, v in r.items() if k != "ts"}
                      for r in rs] for rs in q], a.stats()))
        with pytest.raises(ValueError):
            mod.DecisionAudit(capacity=0)
    assert out[0] == out[1]


def _tree(i):
    return {"name": "gateway", "trace_id": f"t{i}", "attributes": {},
            "children": [{"name": "hop", "kind": "hop",
                          "attributes": {"replica": f"r{i}"},
                          "children": [{"name": "leaf", "children": []}]}]}


SCRAPE = {
    "replicas": {
        "r0": {"records": [{"ts": 2.0, "status": 200}, {"ts": 5.0}],
               "folded": "a;b 3\na;c 1\nbad line x", "observedRps": 2.5,
               "achievableRps": 10, "flag": True,
               "traces": [{"trace_id": "t0", "root": _tree(0)},
                          {"trace_id": "t9", "root": _tree(9)}]},
        "r1": {"records": [{"ts": 3.0, "replica": "rX"}],
               "folded": "a;b 2", "observedRps": 1.0, "achievableRps": 5,
               "traces": [_tree(0) | {"trace_id": "t0"}]},
        "r2": {"unreachable": True, "error": "TimeoutError: "},
    },
    "statuses": {"r0": 200, "r1": 200, "r2": 0},
    "unreachable": ["r2"], "partial": True, "scrapeMs": 1.0,
}


def test_mergers_and_flatten_equal():
    for name in ("merge_flightrecorder", "merge_capacity", "merge_profile"):
        assert getattr(tobs.FleetObserver, name)(json.loads(json.dumps(
            SCRAPE))) == getattr(jobs.FleetObserver, name)(
            json.loads(json.dumps(SCRAPE))), name
    gw = [{"trace_id": "t0", "replica": "", "root": _tree(0)}]
    for tid in ("", "t0"):
        assert tobs.FleetObserver.merge_traces(SCRAPE, gw, tid) == \
            jobs.FleetObserver.merge_traces(SCRAPE, gw, tid)
    assert tobs.flatten_spans(_tree(1), "r1") == \
        jobs.flatten_spans(_tree(1), "r1")
    assert tobs.flatten_spans(None) == jobs.flatten_spans(None) == []


# ---- scrapes over sockets --------------------------------------------------

def _replica_routes(i: int, slow: bool):
    rng = random.Random(i)
    recs = [{"ts": 100.0 + k, "status": 500 if k == 3 and i == 1 else 200,
             "durationMs": rng.uniform(1, 2) * (10 if slow else 1),
             "replica": f"r{i}"} for k in range(8)]
    bodies = {
        "/admin/health": {"verdict": "ok", "level": 0, "signals": []},
        "/admin/flightrecorder": {"records": recs, "stats": {"size": 8}},
        "/admin/profile/compile": {"segments": {
            "s0": {"compiles": 1 + (i == 2)}}},
        "/admin/profile": {"folded": f"main;r{i} {i + 1}"},
        "/admin/profile/capacity": {"observedRps": 1.5 * i,
                                    "achievableRps": 10.0},
        "/trace": {"traces": [{"trace_id": "t1", "root": _tree(i)}]},
    }
    return bodies


async def _replicas(n=4, slow=0):
    servers, targets = [], []
    for i in range(n):
        srv = RestServer(host="127.0.0.1", port=0)
        for path, body in _replica_routes(i, i == slow).items():
            async def h(req, body=body):
                return Response(200, json.dumps(body).encode())

            srv.add_route("GET", path, h)
        await srv.start()
        servers.append(srv)
        targets.append((f"r{i}", f"http://127.0.0.1:{srv.port}"))
    dead = RestServer(host="127.0.0.1", port=0)
    await dead.start()
    dead_url = f"http://127.0.0.1:{dead.port}"
    await dead.stop()
    targets.append((f"r{n}", dead_url))
    return servers, targets


def _gauges(reg) -> list:
    return sorted(ln for ln in reg.render().splitlines()
                  if ln.startswith("seldon_fleet_obs_")
                  and "scrape_seconds" not in ln)


@pytest.mark.parametrize("kind", ["health", "flightrecorder", "profile",
                                  "capacity", "traces"])
def test_fleet_obs_envelopes_equal(kind):
    async def go():
        servers, targets = await _replicas()
        jsess, tsess = aiohttp.ClientSession(), HttpSession()
        try:
            out = []
            for mod, sess, Reg, Pool, Config in (
                    (jobs, jsess, JRegistry, JPool, JConfig),
                    (tobs, tsess, TRegistry, TPool, TConfig)):
                reg = Reg()
                pool = Pool("d", config=Config(enabled=True),
                            members=[u for _, u in targets])
                ob = mod.FleetObserver(
                    mod.ObserveConfig(timeout_ms=3000, mad_k=2.0),
                    metrics=reg, audit=mod.DecisionAudit())
                q = {"n": "5", "trace_id": "t1", "refresh": "1"}
                st, payload = await mod.fleet_obs_body(
                    ob, sess, targets, kind, q, deployment="d", pool=pool,
                    gateway_records=[{"trace_id": "t1",
                                      "root": _tree(7)}])
                again = None
                if kind == "health":
                    _, again = await mod.fleet_obs_body(
                        ob, sess, targets, kind, {}, deployment="d")
                out.append((st, _strip(payload), _strip(again),
                            _gauges(reg),
                            [r.penalty for r in pool.replicas()]))
            assert out[0] == out[1]
            payload = out[1][1]
            assert payload["partial"] and payload["unreachable"] == ["r4"]
            if kind == "health":
                assert out[1][2] is not None
                # r0 is ten times slower, r1 the one with a 500
                assert [(s["replica"], s["dimension"])
                        for s in payload["signals"]
                        if s["signal"] == "straggler"] == [
                            ("r0", "latency"), ("r1", "errors")]
                assert out[1][4][0] > 0
            st, _ = await tobs.fleet_obs_body(None, tsess, targets, "nope",
                                              {})
            assert st == 404
        finally:
            await jsess.close()
            await tsess.close()
            for s in servers:
                await s.stop()

    _run(go())


def test_decisions_body_equal():
    """The same decisions into a ring of each package's, one small enough
    to drop: the bodies EQUAL but for ``ts``.  Fresh rings, since the
    process-default ones carry the counts of whatever ran before."""
    bodies = []
    for mod in (jobs, tobs):
        audit = mod.DecisionAudit(capacity=4)
        for k in range(5):
            audit.record("eject", deployment="d", replica=f"r{k % 2}",
                         reason="connect-error", url="u")
        audit.record("readmit", deployment="d", replica="r1",
                     reason="probe-ok")
        for q in ({"kind": "eject", "n": "5"}, {"replica": "r1"}, {}):
            st, body = mod.decisions_body(audit, q)
            bodies.append((st, [{k: v for k, v in r.items() if k != "ts"}
                                for r in body["decisions"]], body["stats"]))
    assert bodies[:3] == bodies[3:]
    assert bodies[3][2] == {"capacity": 4, "size": 4, "recorded": 6,
                            "dropped": 2}
    recs = [mod.record_decision("eject", deployment="d", replica="r0",
                                reason="connect-error", url="u")
            for mod in (jobs, tobs)]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in recs] == \
        [{"kind": "eject", "deployment": "d", "replica": "r0",
          "reason": "connect-error", "url": "u"}] * 2
    with pytest.raises(ValueError):
        tobs.decisions_body(tobs.decision_audit(), {"n": "x"})


# ---- the engine's and the gateway's routes over a LocalFleet ---------------

def test_fleet_routes_over_a_local_fleet_with_a_dead_replica():
    from seldon_core_tpu.gateway.app import Gateway as JGateway
    from seldon_core_tpu.gateway.store import DeploymentRecord as JRecord
    from seldon_core_tpu.gateway.store import DeploymentStore as JStore
    from seldon_core_tpu_torch.gateway.app import Gateway as TGateway
    from seldon_core_tpu_torch.gateway.store import DeploymentRecord as TRec
    from seldon_core_tpu_torch.gateway.store import DeploymentStore as TStore
    from seldon_core_tpu_torch.operator.local import LocalFleet, serve
    from aiohttp import web

    ann = {"seldon.io/batching": "false", "seldon.io/fleet-replicas": "3",
           "seldon.io/health": "true", "seldon.io/fleet-policy":
           "round-robin"}
    dep = {"metadata": {"name": "obs", "annotations": ann},
           "spec": {"predictors": [{"name": "p", "graph": {
               "name": "clf", "type": "MODEL", "parameters": [{
                   "name": "model_class", "type": "STRING",
                   "value": "seldon_core_tpu_torch.models.iris:"
                            "IrisClassifier"}]}}]}}

    async def go():
        fl = await LocalFleet(dep, device="cpu").start()
        http = HttpSession()
        jstore, tstore = JStore(), TStore()
        jstore.put(JRecord(name="obs", oauth_key="k", oauth_secret="s",
                           engine_urls=fl.urls(), annotations=ann))
        tstore.put(TRec(name="obs", oauth_key="k", oauth_secret="s",
                        engine_urls=fl.urls(), annotations=ann))
        jgw, tgw = JGateway(jstore), TGateway(tstore)
        runner = web.AppRunner(jgw.build_app(), access_log=None)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        jbase = f"http://127.0.0.1:{runner.addresses[0][1]}"
        tsrv = await tgw.start("127.0.0.1", 0)
        tbase = f"http://127.0.0.1:{tsrv.port}"
        lone, _ = await serve(
            "seldon_core_tpu_torch/examples/iris.json", port=0,
            host="127.0.0.1", device="cpu")
        try:
            body = json.dumps({"data": {"ndarray": [[1, 2, 3, 4]]}}).encode()
            for rep in fl.replicas():
                for _ in range(2):
                    await http.request("POST",
                                       rep["url"] + "/api/v0.1/predictions",
                                       body,
                                       {"Content-Type": "application/json"})
            await fl.kill(2)
            views = []
            for base in (fl.replicas()[0]["url"], jbase, tbase):
                st, _, b = await http.request(
                    "GET", base + "/admin/fleet/health?refresh=1")
                assert st == 200, b
                views.append(_strip(json.loads(b)))
            for v in views:
                v.pop("deployment")
            assert views[1] == views[2] and views[0] == views[2]
            assert views[2]["partial"] and views[2]["unreachable"] == ["r2"]
            assert views[2]["replicas"]["r2"]["unreachable"] is True
            for path in ("/admin/fleet/flightrecorder?n=3",
                         "/admin/fleet/capacity", "/admin/fleet/profile"):
                st, _, b = await http.request(
                    "GET", fl.replicas()[1]["url"] + path)
                assert st == 200 and json.loads(b)["partial"], path
            st, _, b = await http.request(
                "GET", fl.replicas()[0]["url"] + "/admin/fleet/decisions")
            assert st == 200 and "decisions" in json.loads(b)
            # a fleetless engine: the reference's 404 body, decisions 200
            lbase = f"http://127.0.0.1:{lone.port}"
            st, _, b = await http.request("GET", lbase + "/admin/fleet/health")
            assert (st, json.loads(b)) == (404, jobs.OBS_DISABLED)
            st, _, b = await http.request("GET", lbase + "/admin/fleet")
            assert st == 404
            st, _, _ = await http.request(
                "GET", lbase + "/admin/fleet/decisions?n=2")
            assert st == 200
            st, _, b = await http.request(
                "GET", lbase + "/admin/fleet/decisions?n=x")
            assert st == 400
        finally:
            await lone.stop()
            await http.close()
            await runner.cleanup()
            await jgw.close()
            await tgw.close()
            await fl.stop()

    _run(go())
