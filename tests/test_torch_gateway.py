"""The port's gateway (``seldon_core_tpu_torch/gateway/``) against the
reference's on the CPU.

Each test boots both gateways over the same engine and sends the same
bytes through each with the port's HTTP client:

- the port's gateway in front of the reference's engine server, and the
  reference's gateway in front of the port's: answer bodies byte-EQUAL to
  each other and to the engine's direct answer (the gateway adds no
  arithmetic, so float answers need no tolerance), status codes and the
  ``X-Seldon-Cache``, ``Retry-After`` and ``X-Seldon-Replica`` headers
  EQUAL;
- the 400, 401, 404, 501 and 503 bodies EQUAL; signed tokens accepted
  across the two packages under one key; the token spill file and the
  deployment store's refresh and key rotation as the reference's;
- the cache tier (miss, hit, coalesced: 16 identical concurrent bodies make
  one engine forward), the QoS tier's shed body, the stream relay (events
  EQUAL, a pre-stream 501 passed through, a client that leaves at the
  gateway closes the engine's stream), the retry rule (a refused connect
  goes to the next replica, a connection that breaks after it opened is
  never replayed, a fresh one or a pooled keep-alive one), ``/metrics`` series and label sets EQUAL, and a gRPC
  ``Seldon.Predict`` forward with ``oauth_token`` EQUAL.

Every test runs under its own timeout.
"""

import asyncio
import base64
import json
import re

import numpy as np
import pytest
from aiohttp import web

from seldon_core_tpu.fleet import observe as jobserve
from seldon_core_tpu.gateway import app as japp
from seldon_core_tpu.gateway import oauth as joauth
from seldon_core_tpu.gateway.store import DeploymentRecord as JRecord
from seldon_core_tpu.gateway.store import DeploymentStore as JStore
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.messages import Status as JStatus
from seldon_core_tpu.serving.rest import build_app as jbuild_app
from seldon_core_tpu_torch.fleet import observe as tobserve
from seldon_core_tpu_torch.fleet.pool import ReplicaPool as TPool
from seldon_core_tpu_torch.gateway import app as tapp
from seldon_core_tpu_torch.gateway import oauth as toauth
from seldon_core_tpu_torch.gateway.store import DeploymentRecord as TRecord
from seldon_core_tpu_torch.gateway.store import DeploymentStore as TStore
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.messages import Status as TStatus
from seldon_core_tpu_torch.serving.client import HttpSession
from seldon_core_tpu_torch.serving.rest import RestServer

TIMEOUT = 60
PUID = "0123456789abcdef0123456789abcdef"
REPLICA = "e7"


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def basic_auth(key: str, secret: str) -> str:
    return "Basic " + base64.b64encode(f"{key}:{secret}".encode()).decode()


def _multipart(fields: dict) -> tuple:
    """A ``multipart/form-data`` body of ``fields`` and its content type."""
    boundary = "sck-form-boundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
             f'name="{k}"\r\n\r\n{v}\r\n' for k, v in fields.items()]
    body = ("".join(parts) + f"--{boundary}--\r\n").encode()
    return body, f"multipart/form-data; boundary={boundary}"


@pytest.fixture(autouse=True)
def _fresh_decision_rings(monkeypatch):
    """Each test records into its own process-default decision ring, in
    both packages: another test's leftovers cannot reach
    ``/admin/fleet/decisions``."""
    for ob in (jobserve, tobserve):
        monkeypatch.setattr(ob, "_DEFAULT_AUDIT", ob.DecisionAudit())


# ---- one fake engine, written once per package -----------------------------

def _echo_engine(Message, Status):
    """An engine answering ``2 * data`` (its request's meta kept, so a
    pinned puid comes back), ``jsonData`` echoed, 429 for ``{"shed":
    true}``, and a stream of ``n`` token events."""

    class Echo:
        replica = REPLICA

        def __init__(self):
            self.calls = 0
            self.stream_closed = asyncio.Event()
            self.delay_s = 0.0

        async def predict(self, msg):
            self.calls += 1
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            if isinstance(msg.json_data, dict) and msg.json_data.get("shed"):
                return Message(status=Status.failure(429, "queue full",
                                                     "QUEUE_FULL"))
            if msg.data is None:
                return Message(json_data=msg.json_data, meta=msg.meta)
            return Message(data=np.asarray(msg.host_data()) * 2,
                           names=list(msg.names), meta=msg.meta,
                           encoding=msg.encoding)

        async def send_feedback(self, fb):
            return Message(status=Status())

        async def stream(self, msg):
            n = int((msg.json_data or {}).get("n", 3))
            try:
                for i in range(n):
                    await asyncio.sleep(0.01)
                    yield {"token": i, "ids": list(range(i + 1))}
            finally:
                self.stream_closed.set()

    return Echo()


class Stack:
    """One engine (``kind``: which package serves it), and both gateways in
    front of it with the same record."""

    def __init__(self, kind: str, annotations=None, engine_url=None,
                 engine_urls=(), engine_grpc=""):
        self.kind = kind
        self.annotations = dict(annotations or {})
        self.engine_url = engine_url
        self.engine_urls = tuple(engine_urls)
        self.engine_grpc = engine_grpc
        self._stop = []

    async def __aenter__(self):
        if self.kind == "ref":
            self.engine = _echo_engine(JMessage, JStatus)
            runner = web.AppRunner(jbuild_app(engine=self.engine),
                                   access_log=None)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = runner.addresses[0][1]
            self._stop.append(runner.cleanup)
        else:
            self.engine = _echo_engine(TMessage, TStatus)
            srv = await RestServer(self.engine, host="127.0.0.1",
                                   port=0).start()
            port = srv.port
            self._stop.append(srv.stop)
        self.engine_base = f"http://127.0.0.1:{port}"
        url = self.engine_base if self.engine_url is None else self.engine_url
        self.jgw, self.jurl, self._jrunner = await _ref_gateway(
            self._record(JRecord, url))
        self.tgw, self.turl = await _port_gateway(self._record(TRecord, url))
        self.http = HttpSession()
        return self

    def _record(self, cls, url):
        return cls(name="dep1", oauth_key="key1", oauth_secret="sec1",
                   engine_url=url, engine_urls=self.engine_urls,
                   engine_grpc=self.engine_grpc,
                   annotations=dict(self.annotations))

    async def __aexit__(self, *exc):
        await self.http.close()
        await self._jrunner.cleanup()
        await self.jgw.close()
        await self.tgw.close()
        for stop in reversed(self._stop):
            await stop()

    async def token(self, base: str) -> str:
        st, _, body = await self.http.request(
            "POST", base + "/oauth/token", b"grant_type=client_credentials",
            {"Authorization": basic_auth("key1", "sec1"),
             "Content-Type": "application/x-www-form-urlencoded"})
        assert st == 200, body
        return json.loads(body)["access_token"]

    async def both(self, method: str, path: str, body: bytes = b"",
                   headers=None, auth: bool = True):
        """``[(status, headers, body)]`` through the reference's gateway,
        then the port's."""
        out = []
        for base in (self.jurl, self.turl):
            h = {"Content-Type": "application/json", **(headers or {})}
            if auth:
                h["Authorization"] = f"Bearer {await self.token(base)}"
            out.append(await self.http.request(method, base + path, body, h))
        return out


async def _ref_gateway(rec, **kw):
    store = JStore()
    store.put(rec)
    gw = japp.Gateway(store, **kw)
    runner = web.AppRunner(gw.build_app(), access_log=None)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    return gw, f"http://127.0.0.1:{runner.addresses[0][1]}", runner


async def _port_gateway(rec, **kw):
    store = TStore()
    store.put(rec)
    gw = tapp.Gateway(store, **kw)
    srv = await gw.start("127.0.0.1", 0)
    return gw, f"http://127.0.0.1:{srv.port}"


HEADERS = ("x-seldon-cache", "retry-after", "x-seldon-replica")


def _same(a, b):
    """Two gateways' answers: status, body bytes and the gateway headers
    EQUAL."""
    (sa, ha, ba), (sb, hb, bb) = a, b
    assert sa == sb, (ba, bb)
    assert ba == bb
    for h in HEADERS:
        assert ha.get(h) == hb.get(h), h


def _pred(data, enc="ndarray") -> bytes:
    msg = {"meta": {"puid": PUID}}
    if enc == "ndarray":
        msg["data"] = {"names": ["a", "b"], "ndarray": data}
    else:
        arr = np.asarray(data, np.float32)
        msg["data"] = {"names": ["a", "b"], "binTensor": {
            "shape": list(arr.shape), "dtype": "float32",
            "b64": base64.b64encode(arr.tobytes()).decode()}}
    return json.dumps(msg).encode()


# ---- answers ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ref", "port"])
@pytest.mark.parametrize("enc", ["ndarray", "binTensor"])
def test_answers_equal_through_both_gateways(kind, enc):
    async def go():
        async with Stack(kind) as s:
            body = _pred([[1.5, -2.25], [0.1, 3.0]], enc)
            direct = await s.http.request(
                "POST", s.engine_base + "/api/v0.1/predictions", body,
                {"Content-Type": "application/json"})
            j, t = await s.both("POST", "/api/v0.1/predictions", body)
            _same(j, t)
            assert t[0] == 200 and t[2] == direct[2]
            assert t[1]["x-seldon-replica"] == REPLICA
            fj, ft = await s.both("POST", "/api/v0.1/feedback",
                                  b'{"reward": 1.0}')
            _same(fj, ft)
            assert s.engine.calls == 3  # direct + one per gateway

    _run(go())


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_engine_429_passes_through_with_retry_after(kind):
    async def go():
        async with Stack(kind) as s:
            j, t = await s.both("POST", "/api/v0.1/predictions",
                                b'{"jsonData": {"shed": true}}')
            _same(j, t)
            assert t[0] == 429 and t[1]["retry-after"] == "1"

    _run(go())


# ---- error bodies ----------------------------------------------------------

ERRORS = {
    # name: (record url, method, path, body, auth header)
    "401-no-token": (None, "/api/v0.1/predictions", None),
    "401-bogus-token": (None, "/api/v0.1/predictions", "Bearer bogus"),
    "401-stream": (None, "/api/v0.1/stream", None),
    "404-no-engine": ("", "/api/v0.1/predictions", "token"),
    "404-stream-no-engine": ("", "/api/v0.1/stream", "token"),
    "503-refused": ("http://127.0.0.1:1", "/api/v0.1/predictions", "token"),
    "503-stream-refused": ("http://127.0.0.1:1", "/api/v0.1/stream",
                           "token"),
    "501-stream-unsupported": ("nostream", "/api/v0.1/stream", "token"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_bodies_equal(case):
    url, path, auth = ERRORS[case]

    async def go():
        async with Stack("port", engine_url=None if url == "nostream"
                         else url) as s:
            if url == "nostream":
                # an engine without a stream route answers 501
                del type(s.engine).stream
            out = []
            for base in (s.jurl, s.turl):
                h = {"Content-Type": "application/json"}
                if auth == "token":
                    h["Authorization"] = f"Bearer {await s.token(base)}"
                elif auth:
                    h["Authorization"] = auth
                out.append(await s.http.request(
                    "POST", base + path, b'{"jsonData": {"n": 2}}', h))
            _same(*out)
            assert out[1][0] == int(case[:3]), out[1][2]

    _run(go())


@pytest.mark.parametrize("form,auth,want", [
    ("grant_type=client_credentials", basic_auth("key1", "sec1"), 200),
    ("grant_type=client_credentials&client_id=key1&client_secret=sec1",
     None, 200),
    ("grant_type=client_credentials", basic_auth("key1", "WRONG"), 401),
    ("grant_type=password&client_id=key1&client_secret=sec1", None, 400),
    ("grant_type=client_credentials&client_id=nobody&client_secret=x",
     None, 401),
    # the same fields as multipart/form-data (aiohttp's request.post())
    ({"grant_type": "client_credentials", "client_id": "key1",
      "client_secret": "sec1"}, None, 200),
    ({"grant_type": "client_credentials", "client_id": "key1",
      "client_secret": "WRONG"}, None, 401),
])
def test_token_endpoint_as_the_reference(form, auth, want):
    async def go():
        async with Stack("port") as s:
            out = []
            for base in (s.jurl, s.turl):
                h = {"Content-Type": "application/x-www-form-urlencoded"}
                body = form.encode() if isinstance(form, str) else None
                if body is None:
                    body, h["Content-Type"] = _multipart(form)
                if auth:
                    h["Authorization"] = auth
                st, _, body = await s.http.request(
                    "POST", base + "/oauth/token", body, h)
                d = json.loads(body)
                d.pop("access_token", None)  # random per issue
                out.append((st, d))
            assert out[0] == out[1] and out[1][0] == want

    _run(go())


def test_admin_bodies_without_planes_equal():
    async def go():
        async with Stack("port") as s:
            for path in ("/admin/traces", "/admin/health",
                         "/admin/flightrecorder", "/admin/introspect",
                         "/admin/profile", "/admin/profile/capacity",
                         "/admin/placement", "/admin/artifacts",
                         "/admin/fleet", "/admin/fleet/health",
                         "/admin/fleet/decisions?kind=none", "/ready",
                         "/live", "/seldon.json"):
                j, t = await s.both("GET", path, auth=False)
                if path == "/seldon.json":
                    jd, td = json.loads(j[2]), json.loads(t[2])
                    jd["info"].pop("version"), td["info"].pop("version")
                    assert (j[0], jd) == (t[0], td)
                    continue
                assert (j[0], json.loads(j[2]) if j[0] != 200 or
                        path.startswith("/admin") else j[2]) == \
                    (t[0], json.loads(t[2]) if t[0] != 200 or
                     path.startswith("/admin") else t[2]), path

    _run(go())


def test_gateway_close_stops_its_pool_probes():
    """A health probe in flight when the gateway closes must not eject its
    replica (and record the decision) afterwards."""
    async def go():
        held = []

        def accept(reader, writer):
            held.append(writer)  # connected, and never answered

        member = await asyncio.start_server(accept, "127.0.0.1", 0)
        port = member.sockets[0].getsockname()[1]
        gw = tapp.Gateway(TStore())
        pool = TPool("probe-leak", members=[f"http://127.0.0.1:{port}"])
        task = asyncio.get_running_loop().create_task(gw._pool_probe(pool))
        gw._probe_tasks.add(task)
        await asyncio.sleep(0.2)
        await gw.close()
        await asyncio.sleep(2.5)  # past the probe's own 2 s timeout
        for w in held:
            w.close()
        member.close()
        assert tobserve.decision_audit().query(deployment="probe-leak") == []
        assert task.done()

    _run(go())


# ---- tokens and the store --------------------------------------------------

def test_signed_tokens_accepted_across_packages(monkeypatch):
    monkeypatch.setenv("SELDON_TOKEN_SIGNING_KEY", "shared-secret")
    jt = joauth.default_token_store()
    tt = toauth.default_token_store()
    assert isinstance(tt, toauth.SignedTokenStore)
    a, _ = jt.issue("key1")
    b, _ = tt.issue("key1")
    assert tt.principal(a) == "key1" and jt.principal(b) == "key1"
    assert tt.principal(a[:-2] + "xx") is None
    expired, _ = jt.issue("key1", ttl_s=-1.0)
    assert tt.principal(expired) is None

    async def go():
        async with Stack("port") as s:
            # a token the reference's gateway minted serves through the
            # port's, and the other way round
            ja, ta = await s.token(s.jurl), await s.token(s.turl)
            for base, tok in ((s.turl, ja), (s.jurl, ta)):
                st, _, _ = await s.http.request(
                    "POST", base + "/api/v0.1/predictions", _pred([[1, 2]]),
                    {"Authorization": f"Bearer {tok}",
                     "Content-Type": "application/json"})
                assert st == 200

    _run(go())


def test_token_spill_and_store_refresh_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("SELDON_TOKEN_SIGNING_KEY", raising=False)
    spill = str(tmp_path / "tokens.json")
    tok, _ = toauth.TokenStore(spill).issue("key1")
    assert joauth.TokenStore(spill).principal(tok) == "key1"
    tok2, _ = joauth.TokenStore(spill).issue("key2")
    toauth.TokenStore(spill).flush()
    assert toauth.TokenStore(spill).principal(tok2) == "key2"
    cfg = tmp_path / "deps.json"
    deps = {"deployments": [
        {"name": "a", "oauth_key": "ka", "oauth_secret": "sa",
         "engine_url": "http://h:1", "annotations": {"x": "1"}},
        {"name": "b", "oauth_key": "kb", "oauth_secret": "sb",
         "engine_urls": ["http://h:2", "http://h:3"], "engine_grpc": "h:4"}]}
    cfg.write_text(json.dumps(deps))
    js, ts = JStore(str(cfg)), TStore(str(cfg))

    def view(store):
        return [(n, vars(store.by_name(n))) for n in store.names()]

    assert view(ts) == view(js)
    # key rotation: the old key stops resolving, the new one does
    deps["deployments"][0]["oauth_key"] = "ka2"
    del deps["deployments"][1]
    cfg.write_text(json.dumps(deps))
    import os
    os.utime(cfg, (1, 1))
    assert ts.refresh() and js.refresh()
    assert view(ts) == view(js)
    assert ts.by_oauth_key("ka") is None and ts.by_oauth_key("ka2").name == "a"


# ---- the cache and QoS tiers -----------------------------------------------

def test_cache_tier_hit_and_single_flight():
    async def go():
        async with Stack("port", annotations={
                "seldon.io/prediction-cache": "true"}) as s:
            body = _pred([[1.0, 2.0]])
            first = await s.both("POST", "/api/v0.1/predictions", body)
            again = await s.both("POST", "/api/v0.1/predictions", body)
            for j, t in (first, again):
                _same(j, t)
            assert first[1][1]["x-seldon-cache"] == "miss"
            assert again[1][1]["x-seldon-cache"] == "hit"
            assert s.engine.calls == 2  # one miss per gateway
            # 16 identical concurrent bodies: one engine forward, through
            # each gateway
            s.engine.delay_s = 0.2
            body2 = _pred([[3.0, 4.0]])
            seen = []
            for base in (s.jurl, s.turl):
                tok = await s.token(base)
                calls = s.engine.calls
                outs = await asyncio.gather(*(s.http.request(
                    "POST", base + "/api/v0.1/predictions", body2,
                    {"Authorization": f"Bearer {tok}",
                     "Content-Type": "application/json"})
                    for _ in range(16)))
                seen.append((
                    s.engine.calls - calls,
                    sorted(h["x-seldon-cache"] for _, h, _ in outs),
                    {(st, b) for st, _, b in outs}))
            (jcalls, jstates, jouts), (tcalls, tstates, touts) = seen
            assert (tcalls, tstates) == (jcalls, jstates)
            assert tcalls == 1
            assert tstates == ["coalesced"] * 15 + ["miss"]
            assert touts == jouts and len(touts) == 1

    _run(go())


def test_admission_shed_body_equal():
    """With the controller full, both gateways answer the same 429 body
    and Retry-After without touching the engine."""
    async def go():
        async with Stack("port", annotations={
                "seldon.io/slo-p95-ms": "50"}) as s:
            for gw in (s.jgw, s.tgw):
                ctl = gw._dep_admission(gw.store.by_name("dep1"))
                while ctl.try_acquire("high"):
                    pass
            calls = s.engine.calls
            j, t = await s.both("POST", "/api/v0.1/predictions",
                                _pred([[1.0, 2.0]]),
                                headers={"X-Seldon-Priority": "low"})
            _same(j, t)
            assert t[0] == 429 and json.loads(t[2])["status"]["reason"] \
                == "ADMISSION_SHED"
            assert s.engine.calls == calls

    _run(go())


# ---- the stream relay ------------------------------------------------------

def _events(raw: bytes) -> list:
    return [json.loads(ln[6:]) for ln in raw.decode().split("\n\n")
            if ln.startswith("data: ")]


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_stream_relay_events_equal(kind):
    async def go():
        async with Stack(kind) as s:
            body = b'{"jsonData": {"n": 4}}'
            direct = await s.http.request(
                "POST", s.engine_base + "/api/v0.1/stream", body,
                {"Content-Type": "application/json"})
            j, t = await s.both("POST", "/api/v0.1/stream", body)
            assert j[0] == t[0] == 200
            assert t[1]["content-type"] == "text/event-stream"
            assert _events(t[2]) == _events(j[2]) == _events(direct[2])
            assert len(_events(t[2])) == 4

    _run(go())


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_stream_abandoned_at_the_gateway_closes_the_engine_stream(kind):
    async def go():
        async with Stack(kind) as s:
            tok = await s.token(s.turl)
            port = int(s.turl.rsplit(":", 1)[1])
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            body = b'{"jsonData": {"n": 100000}}'
            writer.write(
                b"POST /api/v0.1/stream HTTP/1.1\r\nHost: x\r\n"
                b"Content-Type: application/json\r\n"
                + f"Authorization: Bearer {tok}\r\n".encode()
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            assert b"200" in head.split(b"\r\n")[0]
            assert b"data: " in await reader.readuntil(b"\n\n")
            writer.close()
            await asyncio.wait_for(s.engine.stream_closed.wait(), 10)

    _run(go())


# ---- retries ---------------------------------------------------------------

def test_refused_replica_is_retried_on_the_next():
    async def go():
        async with Stack("port") as s:
            urls = ("http://127.0.0.1:1", s.engine_base)
            for gw, cls in ((s.jgw, JRecord), (s.tgw, TRecord)):
                gw.store.put(cls(name="dep1", oauth_key="key1",
                                 oauth_secret="sec1", engine_urls=urls,
                                 annotations={"seldon.io/fleet-policy":
                                              "round-robin"}))
            outs = [await s.both("POST", "/api/v0.1/predictions",
                                 _pred([[1.0, 2.0]])) for _ in range(3)]
            for j, t in outs:
                _same(j, t)
                assert t[0] == 200 and t[1]["x-seldon-replica"] == "r1"

    _run(go())


def test_broken_connection_is_never_replayed():
    """An engine that reads the request and drops the connection: 503,
    one attempt, nothing replayed — as the reference's gateway."""
    seen = []

    async def dropper(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        seen.append(1)
        writer.close()

    async def go():
        srv = await asyncio.start_server(dropper, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}"
        try:
            async with Stack("port", engine_url=url) as s:
                j, t = await s.both("POST", "/api/v0.1/predictions",
                                    _pred([[1.0, 2.0]]))
                _same(j, t)
                assert t[0] == 503
                assert len(seen) == 2  # one attempt per gateway
        finally:
            srv.close()

    _run(go())


def test_post_on_a_dropped_keepalive_connection_is_never_replayed():
    """An engine that answers the first request on a keep-alive connection,
    then reads the second and drops the connection: the second answers
    503 through each gateway and reaches the engine exactly once — a POST
    on a pooled connection that closes under it is not resent on a new
    one, as aiohttp's is not."""
    conns = []
    ok = json.dumps({"data": {"names": [], "ndarray": [[1.0]]}}).encode()

    async def answer_once(reader, writer):
        seen = []
        conns.append(seen)
        while True:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except asyncio.IncompleteReadError:
                break
            n = int(re.search(rb"(?i)content-length:\s*(\d+)",
                              head).group(1))
            await reader.readexactly(n)
            seen.append(head.split(b" ", 2)[1])
            if len(seen) > 1:
                break
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(ok)}\r\n\r\n".encode()
                         + ok)
            await writer.drain()
        writer.close()

    async def go():
        srv = await asyncio.start_server(answer_once, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}"
        try:
            async with Stack("port", engine_url=url) as s:
                body = _pred([[1.0, 2.0]])
                for base in (s.jurl, s.turl):
                    tok = await s.token(base)
                    h = {"Authorization": f"Bearer {tok}",
                         "Content-Type": "application/json"}
                    first = await s.http.request(
                        "POST", base + "/api/v0.1/predictions", body, h)
                    second = await s.http.request(
                        "POST", base + "/api/v0.1/predictions", body, h)
                    assert first[0] == 200 and first[2] == ok
                    if base == s.jurl:
                        jsecond = second
                _same(jsecond, second)
                assert second[0] == 503
                assert b"Server disconnected" in second[2]
                # one connection per gateway, each request on it once
                assert conns == [[b"/api/v0.1/predictions"] * 2] * 2
        finally:
            srv.close()

    _run(go())


# ---- metrics ---------------------------------------------------------------

def _series(text: bytes) -> set:
    out = set()
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            name_labels = line.split(" ")[0]
            out.add(re.sub(r'le="[^"]*"', "le", name_labels))
    return out


def test_metrics_series_and_labels_equal():
    async def go():
        async with Stack("port", annotations={
                "seldon.io/prediction-cache": "true"}) as s:
            urls = ("http://127.0.0.1:1", s.engine_base)
            for gw, cls in ((s.jgw, JRecord), (s.tgw, TRecord)):
                gw.store.put(cls(name="dep1", oauth_key="key1",
                                 oauth_secret="sec1", engine_urls=urls,
                                 annotations={
                                     "seldon.io/prediction-cache": "true",
                                     "seldon.io/fleet-policy":
                                         "round-robin"}))
                gw.fleet_probe_interval_s = 1e9  # no background sweep
            for body in (_pred([[1.0, 2.0]]), _pred([[1.0, 2.0]]),
                         _pred([[5.0, 2.0]])):
                await s.both("POST", "/api/v0.1/predictions", body)
            j, t = await s.both("GET", "/metrics", auth=False)
            assert _series(t[2]) == _series(j[2])
            assert any("seldon_fleet_ejections_total" in x
                       for x in _series(t[2]))

    _run(go())


# ---- gRPC ------------------------------------------------------------------

def test_grpc_forward_with_oauth_token_equal():
    import grpc

    from seldon_core_tpu.proto import prediction_pb2 as jpb
    from seldon_core_tpu_torch.operator.local import LocalDeployment
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.serving.grpc_api import (
        GrpcServer,
        _Stub,
        seldon_service_handler,
    )

    async def go():
        local = LocalDeployment(load_deployment(
            "seldon_core_tpu_torch/examples/iris.json"), device="cpu")
        eng = GrpcServer([seldon_service_handler(local)], port=0,
                         host="127.0.0.1")
        await eng.start()
        servers = []
        try:
            async with Stack("port", engine_grpc=f"127.0.0.1:{eng.port}") \
                    as s:
                outs = []
                for gw, base in ((s.jgw, s.jurl), (s.tgw, s.turl)):
                    gs = GrpcServer([gw.grpc_handler()], port=0,
                                    host="127.0.0.1")
                    await gs.start()
                    servers.append(gs)
                    tok = await s.token(base)
                    async with grpc.aio.insecure_channel(
                            f"127.0.0.1:{gs.port}") as ch:
                        stub = _Stub(ch, "Seldon")
                        req = jpb.SeldonMessage.FromString(
                            json_to_pb(jpb))
                        got = await stub.Predict(
                            req, metadata=(("oauth_token", tok),),
                            timeout=30)
                        try:
                            await stub.Predict(
                                req, metadata=(("oauth_token", "bad"),),
                                timeout=30)
                            code = None
                        except grpc.aio.AioRpcError as e:
                            code = e.code()
                        outs.append((got.SerializeToString(), code))
                assert outs[0] == outs[1]
                assert outs[1][1] == grpc.StatusCode.UNAUTHENTICATED
        finally:
            for gs in servers:
                await gs.stop()
            await eng.stop()
            await local.aclose()

    _run(go())


def json_to_pb(pb) -> bytes:
    from google.protobuf import json_format

    msg = json_format.ParseDict(
        {"meta": {"puid": PUID},
         "data": {"names": ["a", "b", "c", "d"],
                  "ndarray": [[5.1, 3.5, 1.4, 0.2]]}},
        pb.SeldonMessage())
    return msg.SerializeToString()
