"""Async socket load harness (port of ``seldon_core_tpu/tools/loadtest.py``).

Drives the real servers over real sockets (REST and SSE on the port's
``serving/client.py``, gRPC on ``grpc.aio``, the framed wire on
``serving/framed.py``), closed-loop with N concurrent workers or open-loop
at a Poisson rate, recording per-request latency and reporting throughput
and percentiles (req/s, p50/p75/p90/p95/p99).  ``overload_drill`` drives
an in-process engine at a fixed offered rate with a priority mix.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class LoadResult:
    protocol: str
    requests: int
    failures: int
    seconds: float
    latencies_ms: List[float] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def req_per_s(self) -> float:
        return self.requests / self.seconds if self.seconds > 0 else 0.0

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))

    def to_dict(self) -> dict:
        out = {
            "protocol": self.protocol,
            "requests": self.requests,
            "failures": self.failures,
            "seconds": round(self.seconds, 3),
            "req_per_s": round(self.req_per_s, 1),
            "latency_ms": {
                "p50": round(self.percentile(50), 3),
                "p75": round(self.percentile(75), 3),
                "p90": round(self.percentile(90), 3),
                "p95": round(self.percentile(95), 3),
                "p99": round(self.percentile(99), 3),
                "mean": round(float(np.mean(self.latencies_ms)), 3)
                if self.latencies_ms
                else 0.0,
            },
        }
        out.update(self.extra)
        return out


async def oauth_token(
    base_url: str, key: str, secret: str, session=None
) -> str:
    """Client-credentials token dance against a gateway's
    ``/oauth/token``; ``session`` is an ``HttpSession`` to reuse."""
    import base64

    from seldon_core_tpu_torch.serving.client import HttpSession

    own = session is None
    sess = session or HttpSession()
    basic = base64.b64encode(f"{key}:{secret}".encode()).decode()
    try:
        status, _, raw = await sess.request(
            "POST", f"{base_url.rstrip('/')}/oauth/token",
            b"grant_type=client_credentials",
            {"Content-Type": "application/x-www-form-urlencoded",
             "Authorization": f"Basic {basic}"})
        # status first: a 401 with an HTML body (gateway/proxy error
        # page) must surface as the auth failure, not a JSON decode error
        text = raw.decode("utf-8", "replace")
        if status != 200:
            raise RuntimeError(f"token endpoint HTTP {status}: {text[:500]}")
        return json.loads(text)["access_token"]
    finally:
        if own:
            await sess.close()


# ---------------------------------------------------------------------------
# protocol drivers: async callables, raising on failure (REST returns the
# answer's body, SSE the stream's last event; run_load ignores them)
# ---------------------------------------------------------------------------


class RestDriver:
    """POST /api/v0.1/predictions (engine/gateway) or /predict (component)."""

    def __init__(
        self,
        base_url: str,
        payload: dict,
        path: str = "/api/v0.1/predictions",
        token: str = "",
        connections: int = 128,
        drill_id: str = "",
    ):
        self.base_url = base_url.rstrip("/")
        self.path = path
        self.body = json.dumps(payload).encode()
        self.headers = {"Content-Type": "application/json"}
        if token:
            self.headers["Authorization"] = f"Bearer {token}"
        if drill_id:
            # W3C tracestate entry: the gateway/engine tracer carries it
            # through every span of every request this drill issues, so
            # /admin/traces?drill=<id> isolates the drill's traffic
            self.headers["tracestate"] = f"drill-id={drill_id}"
        self._connections = connections
        self._session = None

    async def __aenter__(self):
        from seldon_core_tpu_torch.serving.client import HttpSession

        self._session = HttpSession(limit=self._connections)
        return self

    async def __aexit__(self, *exc):
        if self._session is not None:
            await self._session.close()

    async def __call__(self) -> bytes:
        """One request; the answer's raw body."""
        status, _, raw = await self._session.request(
            "POST", self.base_url + self.path, self.body, self.headers,
            timeout_s=30)
        if status != 200:
            raise RuntimeError(f"HTTP {status}")
        return raw


class SseStreamDriver(RestDriver):
    """POST an SSE streaming endpoint (engine/gateway ``/api/v0.1/stream``
    or component ``/stream``); each request consumes the FULL event stream.

    ``run_load`` latency = whole-stream duration; the driver additionally
    tracks per-stream token counts and time-to-first-token (per-request
    quantities over every COMPLETED stream, warmup included)."""

    def __init__(self, base_url, payload, path="/api/v0.1/stream", **kw):
        super().__init__(base_url, payload, path=path, **kw)
        self.ttfts_ms: List[float] = []
        # per-stream time-per-output-token: (duration - ttft) / (n - 1),
        # the steady-state decode cadence the TTFT number excludes
        self.tpots_ms: List[float] = []
        self.tokens = 0
        self.streams_completed = 0

    #: whole-stream duration is workload-defined (no total deadline), but
    #: a wedged server that stops emitting events must not hang the tool:
    #: the gap between two reads is bounded
    READ_GAP_S = 60.0

    async def __call__(self) -> Any:
        """One whole stream; its last event."""
        t0 = time.perf_counter()
        ttft_ms: Optional[float] = None
        n = 0
        event: Any = None
        status, headers, chunks = await self._session.stream(
            "POST", self.base_url + self.path, self.body, self.headers,
            connect_timeout_s=10)
        try:
            if status != 200:
                raise RuntimeError(f"HTTP {status}")
            ctype = headers.get("content-type", "").split(";")[0].strip()
            if ctype != "text/event-stream":
                raise RuntimeError(f"not a stream: {ctype}")
            buf = b""
            while True:
                try:
                    data = await asyncio.wait_for(chunks.__anext__(),
                                                  self.READ_GAP_S)
                except StopAsyncIteration:
                    break
                buf += data
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    if ttft_ms is None:
                        ttft_ms = (time.perf_counter() - t0) * 1000.0
                    event = json.loads(line[6:])
                    if isinstance(event, dict):
                        if set(event) == {"error"}:
                            raise RuntimeError(event["error"])
                        if "token" in event:
                            n += 1
        finally:
            await chunks.aclose()
        # ALL tallies (including TTFT) only for streams that completed
        # cleanly, so mid-flight failures don't pollute any per-stream
        # quantity
        if ttft_ms is not None:
            self.ttfts_ms.append(ttft_ms)
            if n > 1:
                total_ms = (time.perf_counter() - t0) * 1000.0
                self.tpots_ms.append((total_ms - ttft_ms) / (n - 1))
        self.tokens += n
        self.streams_completed += 1
        return event

    def stream_stats(self, req_per_s: float) -> dict:
        """Stream-specific report.  ``tokens_per_s`` is derived as
        mean-tokens-per-completed-stream x measured-window req/s — raw
        token tallies span warmup and window-tail streams, so dividing
        them by the measured window alone would overestimate the rate."""
        out: dict = {"tokens": self.tokens,
                     "streams_completed": self.streams_completed}
        if self.streams_completed:
            per_stream = self.tokens / self.streams_completed
            out["tokens_per_s"] = round(per_stream * req_per_s, 1)
        if self.ttfts_ms:
            arr = np.asarray(self.ttfts_ms)
            out["ttft_ms"] = {
                "p50": round(float(np.percentile(arr, 50)), 3),
                "p90": round(float(np.percentile(arr, 90)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3),
            }
        if self.tpots_ms:
            arr = np.asarray(self.tpots_ms)
            out["tpot_ms"] = {
                "p50": round(float(np.percentile(arr, 50)), 3),
                "p90": round(float(np.percentile(arr, 90)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3),
            }
        return out


class GrpcDriver:
    """Seldon.Predict (external) or Model.Predict (component) over one
    persistent aio channel."""

    def __init__(
        self,
        target: str,
        payload: dict,
        service: str = "Seldon",
        token: str = "",
    ):
        from seldon_core_tpu_torch.messages import SeldonMessage
        from seldon_core_tpu_torch.proto.convert import message_to_proto

        self.target = target
        self.service = service
        self.request_pb = message_to_proto(SeldonMessage.from_dict(payload))
        self.token = token
        self._channel = None
        self._call = None

    async def __aenter__(self):
        import grpc.aio

        from seldon_core_tpu_torch.proto import prediction_pb2 as pb
        from seldon_core_tpu_torch.serving.grpc_api import _PKG, grpc_options

        self._channel = grpc.aio.insecure_channel(
            self.target, options=grpc_options()
        )
        self._call = self._channel.unary_unary(
            f"/{_PKG}.{self.service}/Predict",
            request_serializer=pb.SeldonMessage.SerializeToString,
            response_deserializer=pb.SeldonMessage.FromString,
        )
        return self

    async def __aexit__(self, *exc):
        if self._channel is not None:
            await self._channel.close()

    async def __call__(self) -> None:
        md = (("oauth_token", self.token),) if self.token else ()
        await self._call(self.request_pb, timeout=30, metadata=md)


class FramedDriver:
    """SELF-framed TCP path (native epoll server): a pool of event-loop
    native connections, one checked out per in-flight request."""

    def __init__(self, host: str, port: int, payload: dict, pool: int = 16):
        self.host, self.port = host, port
        self.payload = payload
        self.pool = pool
        self._clients: list = []
        self._free: Optional[asyncio.Queue] = None

    async def __aenter__(self):
        from seldon_core_tpu_torch.messages import SeldonMessage
        from seldon_core_tpu_torch.serving.framed import AsyncFramedClient

        self._msg = (
            self.payload
            if isinstance(self.payload, SeldonMessage)
            else SeldonMessage.from_dict(self.payload)
        )
        self._free = asyncio.Queue()
        for _ in range(self.pool):
            c = await AsyncFramedClient().connect(self.host, self.port)
            self._clients.append(c)
            self._free.put_nowait(c)
        return self

    async def __aexit__(self, *exc):
        for c in self._clients:
            try:
                c.close()
            except Exception:
                pass

    async def __call__(self) -> None:
        from seldon_core_tpu_torch.serving.framed import AsyncFramedClient

        client = await self._free.get()
        try:
            if client is None:  # prior failure parked a tombstone: reconnect
                client = await AsyncFramedClient().connect(self.host, self.port)
                # ownership of each client is serialized through the
                # _free queue; the list is close-time bookkeeping only
                self._clients.append(client)  # graphlint: disable=RL602
            await client.predict(self._msg)
        except BaseException:
            # the stream may be desynced mid-frame — never reuse it
            if client is not None:
                try:
                    client.close()
                except Exception:
                    pass
                if client in self._clients:
                    # same queue-serialized ownership as the append above
                    self._clients.remove(client)  # graphlint: disable=RL602
            self._free.put_nowait(None)
            raise
        else:
            self._free.put_nowait(client)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


async def run_load(
    driver: Any,
    seconds: float = 5.0,
    concurrency: int = 64,
    warmup_s: float = 0.5,
    protocol: str = "",
) -> LoadResult:
    """Closed-loop: ``concurrency`` workers each issue requests back-to-back
    for ``seconds`` after a warmup window (excluded from stats)."""
    async with driver:
        lat: List[float] = []
        failures = 0
        count = 0
        t_start = time.perf_counter() + warmup_s
        t_end = t_start + seconds

        async def worker():
            nonlocal failures, count
            while True:
                now = time.perf_counter()
                if now >= t_end:
                    return
                t0 = now
                try:
                    await driver()
                except Exception:
                    if t0 >= t_start:
                        failures += 1
                    continue
                t1 = time.perf_counter()
                if t0 >= t_start:
                    count += 1
                    lat.append((t1 - t0) * 1000.0)

        # worker() catches per-request errors into `failures`; the gather
        # can only fail-fast on a driver bug
        await asyncio.gather(  # graphlint: disable=RL605
            *(worker() for _ in range(concurrency)))
        measured = time.perf_counter() - t_start
        return LoadResult(
            protocol=protocol or type(driver).__name__,
            requests=count,
            failures=failures,
            seconds=min(measured, seconds) or seconds,
            latencies_ms=lat,
        )


async def run_open_loop(
    driver: Any,
    rate: float,
    seconds: float = 5.0,
    warmup_s: float = 0.5,
    seed: int = 0,
    max_inflight: int = 2000,
    protocol: str = "",
) -> LoadResult:
    """OPEN-loop load: Poisson arrivals at ``rate`` req/s that never wait
    for completions — latency at a fixed OFFERED load.

    Closed-loop harnesses cannot produce this number: their p50 at
    saturation is queueing delay (~concurrency/throughput), which says
    nothing about service latency under sane load (the reference's
    "median 4 ms" style numbers, docs/benchmarking.md:44).  Inter-arrival
    gaps are exponential (seeded), so bursts happen like real traffic.

    If the server falls behind, in-flight grows; past ``max_inflight``
    arrivals are counted in ``dropped`` instead of being issued —
    ``dropped > 0`` means the offered rate exceeds capacity (report the
    latency numbers at a lower rate instead of quoting unbounded queue
    growth).
    """
    rng = np.random.default_rng(seed)
    async with driver:
        lat: List[float] = []
        failures = 0
        count = 0
        dropped = 0
        inflight = 0
        tasks: set = set()
        t_start = time.perf_counter() + warmup_s
        t_end = t_start + seconds

        async def one(t0: float) -> None:
            nonlocal failures, count, inflight
            try:
                await driver()
            except Exception:
                if t0 >= t_start:
                    failures += 1
                return
            finally:
                inflight -= 1
            t1 = time.perf_counter()
            # throughput counts completions OBSERVED in the measured
            # window (t1), not arrivals scheduled in it (t0): a long
            # stream admitted during warmup that finishes mid-window is
            # real served work, and gating on t0 reports 0 req/s for
            # runs whose every arrival predates t_start.  Latency stays
            # t0-gated — a warmup arrival's duration is not a sample of
            # the offered-rate service time.
            if t1 >= t_start:
                count += 1
            if t0 >= t_start:
                lat.append((t1 - t0) * 1000.0)

        loop = asyncio.get_running_loop()
        next_t = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if next_t > now:
                await asyncio.sleep(next_t - now)
            # latency is measured from the SCHEDULED arrival, not the
            # (possibly late) dispatch — timing from dispatch would hide
            # the catch-up queueing delay exactly when the system is
            # stressed (the coordinated-omission error open-loop
            # harnesses exist to avoid)
            sched = next_t
            if inflight >= max_inflight:
                if sched >= t_start:
                    dropped += 1
            else:
                inflight += 1
                t = loop.create_task(one(sched))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            next_t += rng.exponential(1.0 / rate)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        measured = time.perf_counter() - t_start
        return LoadResult(
            protocol=protocol or type(driver).__name__,
            requests=count,
            failures=failures,
            seconds=min(measured, seconds) or seconds,
            latencies_ms=lat,
            extra={
                "mode": "open-loop",
                "offered_rate": rate,
                "dropped": dropped,
            },
        )


def run_load_sync(driver, **kw) -> LoadResult:
    return asyncio.run(run_load(driver, **kw))


# ---------------------------------------------------------------------------
# QoS overload drill (docs/qos.md)
# ---------------------------------------------------------------------------


async def overload_drill(
    predict: Any,
    payload: Any,
    rate: float,
    seconds: float = 3.0,
    priority_mix: Optional[Dict[str, float]] = None,
    deadline_ms: float = 0.0,
    seed: int = 0,
    warmup_s: float = 0.2,
    max_inflight: int = 10_000,
    drill_id: str = "",
) -> dict:
    """Open-loop overload drill against an in-process async
    ``predict(msg) -> SeldonMessage`` (a GraphEngine / LocalDeployment,
    typically chaos-wrapped) at a FIXED offered rate, with a priority mix
    and a per-request deadline — the reproducible harness the QoS
    subsystem is tested and benchmarked with.

    Per priority class it reports offered/completed counts, **goodput**
    (completions within the deadline / offered — the number overload
    control exists to protect), shed counts and the shed answer's
    latency percentiles (a shed must be a *fast* no), and completion
    latency percentiles.  Arrivals are seeded Poisson; latency is
    measured from the scheduled arrival (no coordinated omission).

    ``payload`` is a SeldonMessage or a zero-arg factory returning one.

    ``drill_id`` (when set) binds a ``drill-id`` tracestate entry onto
    every issued request, so a tracing-enabled engine's collector can be
    queried for exactly this drill's traces afterwards.
    """
    from seldon_core_tpu_torch.qos.context import Deadline, QosContext, qos_scope
    from seldon_core_tpu_torch.utils.tracing import (
        TraceContext,
        new_trace_id,
        trace_scope,
    )

    rng = np.random.default_rng(seed)
    pri_rng = np.random.default_rng(seed + 1)
    mix = priority_mix or {"normal": 1.0}
    names = sorted(mix)
    weights = np.asarray([mix[n] for n in names], dtype=np.float64)
    weights /= weights.sum()

    class _Tally:
        __slots__ = ("offered", "completed", "good", "shed", "expired",
                     "failed", "lat_ms", "shed_ms")

        def __init__(self):
            self.offered = 0
            self.completed = 0
            self.good = 0
            self.shed = 0
            self.expired = 0
            self.failed = 0
            self.lat_ms: List[float] = []
            self.shed_ms: List[float] = []

    tallies = {n: _Tally() for n in names}
    inflight = 0
    tasks: set = set()
    t_origin = time.perf_counter()
    t_start = t_origin + warmup_s
    t_end = t_start + seconds

    def _payload():
        return payload() if callable(payload) else payload

    async def one(sched: float, priority: str) -> None:
        nonlocal inflight
        tally = tallies[priority] if sched >= t_start else None
        if tally is not None:
            tally.offered += 1
        ctx = QosContext(
            priority=priority,
            deadline=Deadline.after_ms(deadline_ms) if deadline_ms else None,
        )
        tctx = (TraceContext(trace_id=new_trace_id(),
                             state=(("drill-id", drill_id),))
                if drill_id else None)
        try:
            with qos_scope(ctx), trace_scope(tctx):
                out = await predict(_payload())
        except Exception:
            if tally is not None:
                tally.failed += 1
            return
        finally:
            inflight -= 1
        lat = (time.perf_counter() - sched) * 1000.0
        if tally is None:
            return
        code = out.status.code if out.status is not None else 200
        ok = out.status is None or out.status.status == "SUCCESS"
        if ok:
            tally.completed += 1
            tally.lat_ms.append(lat)
            if not deadline_ms or lat <= deadline_ms:
                tally.good += 1
        elif code == 429:
            tally.shed += 1
            tally.shed_ms.append(lat)
        elif code == 504:
            tally.expired += 1
        else:
            tally.failed += 1

    loop = asyncio.get_running_loop()
    next_t = time.perf_counter()
    dropped = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if next_t > now:
            await asyncio.sleep(next_t - now)
        sched = next_t
        priority = names[int(pri_rng.choice(len(names), p=weights))]
        if inflight >= max_inflight:
            if sched >= t_start:
                dropped += 1
        else:
            inflight += 1
            t = loop.create_task(one(sched, priority))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        next_t += rng.exponential(1.0 / rate)
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)

    def _pcts(vals: List[float]) -> dict:
        if not vals:
            return {}
        arr = np.asarray(vals)
        return {
            "p50": round(float(np.percentile(arr, 50)), 3),
            "p95": round(float(np.percentile(arr, 95)), 3),
            "p99": round(float(np.percentile(arr, 99)), 3),
        }

    out: dict = {
        "offered_rate": rate,
        "seconds": seconds,
        "deadline_ms": deadline_ms,
        "dropped": dropped,
        "priorities": {},
    }
    for n in names:
        t = tallies[n]
        out["priorities"][n] = {
            "offered": t.offered,
            "completed": t.completed,
            "goodput": round(t.good / t.offered, 4) if t.offered else None,
            "shed": t.shed,
            "expired": t.expired,
            "failed": t.failed,
            "latency_ms": _pcts(t.lat_ms),
            "shed_latency_ms": _pcts(t.shed_ms),
        }
    return out
