"""Gateway server: REST + gRPC front door with OAuth and firehose (port of
``seldon_core_tpu/gateway/app.py``).

Reference call path (``api-frontend/.../RestClientController.java:128-177``):
resolve OAuth principal → look up deployment → forward the RAW request body
to the engine (no parse on the hot path,
``service/InternalPredictionService.java:112-185``) → fire-and-forget
firehose publish → metrics.  The gRPC server forwards to the engine's gRPC
port with a channel cache per deployment
(``api-frontend/.../grpc/SeldonGrpcServer.java``).

The port serves on its own ``serving/rest.py`` :class:`RestServer` and
forwards with ``serving/client.py`` :class:`HttpSession`, both on the
standard library, where the reference runs on aiohttp.  Routes, status
codes, error bodies, headers (``X-Seldon-Cache``, ``X-Seldon-Replica``,
``Retry-After``), metric series and the flight records are the
reference's.  Two points of the transport:

- a forward is replayed on the next replica only after a
  :class:`~seldon_core_tpu_torch.serving.client.ConnectError`, a
  connection that was never opened (aiohttp's ``ClientConnectorError``):
  a connection that broke later may have delivered the request, so its
  failure answers 503 and is never replayed;
- ``/api/v0.1/stream`` relays the engine's bytes as they arrive
  (:class:`~seldon_core_tpu_torch.serving.rest.RelayStream`) with no total
  deadline; a JSON answer before the stream (501 ``STREAM_UNSUPPORTED``)
  passes through with its status; a failure after the headers ends the
  stream; a client that leaves closes the engine connection, which frees
  an LLM request's slot and pages there.

    python -m seldon_core_tpu_torch.gateway.app --config deployments.json \\
        --port 8080 --grpc-port 5000 [--firehose jsonl --firehose-dir D]
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import random
import time
from email import policy as email_policy
from email.parser import BytesParser
from typing import Optional
from urllib.parse import parse_qsl

from seldon_core_tpu_torch.caching import (
    PredictionCache,
    SingleFlight,
    config_from_annotations,
    raw_key,
)
from seldon_core_tpu_torch.fleet import (
    FleetConfig,
    ReplicaPool,
    fleet_body,
    fleet_config_from_annotations,
)
from seldon_core_tpu_torch.gateway.firehose import NullFirehose, make_firehose
from seldon_core_tpu_torch.gateway.oauth import (
    OAuthProvider,
    default_token_store,
)
from seldon_core_tpu_torch.gateway.store import DeploymentStore
from seldon_core_tpu_torch.qos import (
    AdmissionController,
    AdmissionShedError,
    QosContext,
    qos_from_annotations,
    qos_from_headers,
)
from seldon_core_tpu_torch.qos.admission import AdmissionConfig
from seldon_core_tpu_torch.qos.context import forward_headers
from seldon_core_tpu_torch.serving.client import (
    ConnectError,
    HttpError,
    HttpSession,
)
from seldon_core_tpu_torch.serving.rest import (
    RelayStream,
    Request,
    Response,
    RestServer,
)
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch.utils.tracing import (
    FileSpanSink,
    SpanCollector,
    Tracer,
    current_trace,
    trace_config_from_annotations,
    trace_from_headers,
    trace_headers,
    trace_scope,
)

__all__ = ["Gateway", "main", "SESSION_HEADER"]

logger = logging.getLogger(__name__)


def _shed_reason(body: bytes) -> str:
    """Best-effort extraction of the FAILURE reason from an error body so
    the shed event on the gateway root span carries it (ADMISSION_SHED,
    DEADLINE_EXCEEDED, ...)."""
    try:
        d = json.loads(body)
        return str(d["status"]["reason"])
    except Exception:
        return "UNKNOWN"


WATCH_INTERVAL_S = 5.0  # reference @Scheduled(fixedDelay=5000)

# retry backoff never sleeps longer than this regardless of how the
# decorrelated jitter walks (the deadline budget caps it further)
RETRY_BACKOFF_CAP_S = 1.0
# at most one active health sweep over a deployment's replicas per window
FLEET_PROBE_INTERVAL_S = 2.0
# SSE session-affinity key: streams carrying it pin to one replica
SESSION_HEADER = "X-Seldon-Session"
# the forward's whole-exchange budget without a request deadline (the
# reference session's ClientTimeout(total=30))
FORWARD_TIMEOUT_S = 30.0

def _decorrelated_backoff(rng: random.Random, base_s: float, prev_s: float,
                          cap_s: float = RETRY_BACKOFF_CAP_S) -> float:
    """Decorrelated-jitter backoff (Exponential Backoff And Jitter, AWS
    architecture blog): ``sleep = min(cap, U(base, prev * 3))``.  Unlike
    the plain ``base * 2**attempt`` ladder, concurrent retries against a
    recovering engine spread out instead of arriving in synchronized
    waves that knock it straight back over."""
    hi = max(base_s, prev_s * 3.0)
    return min(cap_s, rng.uniform(base_s, hi))


def _json_response(payload, status: int = 200) -> Response:
    return Response(status, json.dumps(payload).encode())


def _failure_body(code: int, info: str, reason: str = "") -> bytes:
    status = {"code": code, "status": "FAILURE"}
    if reason:
        status["reason"] = reason
    status["info"] = info
    return json.dumps({"status": status}).encode()


_UNAUTHORIZED = {"error": "invalid_token",
                 "error_description": "missing or expired bearer token"}


def _form(req: Request) -> dict:
    """The form fields of a token request, as aiohttp's ``request.post()``
    reads them (urlencoded, multipart or no content type; any other type is
    no form); the first value of a repeated field."""
    raw = req.headers.get("content-type", "")
    ctype = raw.split(";")[0].strip().lower()
    out: dict = {}
    if ctype == "multipart/form-data":
        for k, v in _multipart_fields(raw, req.body):
            out.setdefault(k, v)
        return out
    if ctype not in ("", "application/x-www-form-urlencoded"):
        return {}
    for k, v in parse_qsl(req.body.rstrip().decode("utf-8", "replace"),
                          keep_blank_values=True):
        out.setdefault(k, v)
    return out


def _multipart_fields(content_type: str, body: bytes) -> list:
    """``(name, value)`` of each named part of a ``multipart/form-data``
    body (its boundary in ``content_type``), values decoded as text in the
    part's charset (UTF-8 when it names none)."""
    msg = BytesParser(policy=email_policy.default).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1", "replace")
        + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        return []
    out = []
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True) or b""
        out.append((str(name), payload.decode(
            part.get_content_charset() or "utf-8", "replace")))
    return out


class Gateway:
    def __init__(
        self,
        store: DeploymentStore,
        firehose=None,
        token_spill: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        retries: int = 2,
        retry_backoff_s: float = 0.05,
        tracer: Optional[Tracer] = None,
        health=None,
        profiler=None,
        placement=None,
        artifacts=None,
    ):
        self.store = store
        # SELDON_TOKEN_SIGNING_KEY selects stateless signed tokens so any
        # gateway replica honors any replica's tokens; the spill file
        # remains the single-replica restart-persistence knob
        self.oauth = OAuthProvider(store, default_token_store(token_spill))
        self.firehose = firehose or NullFirehose()
        self.registry = registry or MetricsRegistry()
        # connection-failure retries on the engine forward (reference apife
        # HttpRetryHandler.java); retries=2 → 3 attempts total
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self._session: Optional[HttpSession] = None
        self._grpc_channels: dict[str, object] = {}
        # deployment-level prediction cache (gateway tier): content-
        # addressed over the RAW request body — the forward path still
        # never parses — keyed per deployment, enabled by the
        # seldon.io/prediction-cache annotation on the deployment record.
        # Concurrent identical bodies coalesce onto one engine forward.
        self._caches: dict[str, Optional[PredictionCache]] = {}
        self._flight = SingleFlight()
        # per-deployment QoS admission: adaptive AIMD concurrency limit
        # against the seldon.io/slo-p95-ms annotation, priority classes
        # from X-Seldon-Priority — low sheds first, 429 + Retry-After, in
        # microseconds (the shed path never queues).  Keyed like _caches;
        # rebuilt when the annotation changes.
        self._admission: dict[str, tuple[float,
                                         Optional[AdmissionController]]] = {}
        # Fleet plane: one ReplicaPool per deployment whose record lists
        # engine replicas (or sets seldon.io/fleet-*), keyed like _caches —
        # rebuilt on annotation change, membership reconciled in place on
        # URL-list change so stats survive.
        self._pools: dict[str, tuple] = {}
        # strong refs to in-flight background probes: the event loop only
        # weak-refs its tasks, so a bare create_task can be GC'd mid-probe
        self._probe_tasks: set = set()
        self._retry_rng = random.Random()
        self.fleet_probe_interval_s = FLEET_PROBE_INTERVAL_S
        self._server: Optional[RestServer] = None
        # Distributed tracing: the gateway is the ingress — it accepts
        # inbound W3C traceparent or mints a fresh 128-bit context with
        # the head-sampling decision, opens the root "gateway" span, and
        # stamps the context onto the engine hop.  Env knobs:
        # SELDON_TRACING / SELDON_TRACE_SAMPLE / SELDON_TRACE_EXPORT.
        # Served from /admin/traces.
        if tracer is not None:
            self.tracer: Optional[Tracer] = tracer
        else:
            self.tracer = None
            try:
                tcfg = trace_config_from_annotations({}, "gateway")
            except ValueError as e:
                logger.warning("tracing disabled (bad env config): %s", e)
                tcfg = None
            if tcfg is not None and tcfg.enabled:
                sink = (FileSpanSink(tcfg.export_path)
                        if tcfg.export_path else None)
                self.tracer = Tracer(
                    max_traces=tcfg.max_traces,
                    sample_rate=tcfg.sample_rate,
                    collector=SpanCollector(service="gateway",
                                            slow_ms=tcfg.slow_ms, sink=sink),
                )
        # Health plane: unconditional flight recording of every forward,
        # SLO burn monitoring, and the introspection sampler.  Env knobs:
        # SELDON_HEALTH / SELDON_HEALTH_SAMPLE_MS / SELDON_SLO_AVAILABILITY.
        # Served from /admin/{health,flightrecorder,introspect}.
        if health is not None:
            self.health = health
        else:
            self.health = None
            try:
                from seldon_core_tpu_torch.health import (
                    HealthPlane,
                    health_config_from_annotations,
                )

                hcfg = health_config_from_annotations({}, "gateway")
            except ValueError as e:
                logger.warning("health plane disabled (bad env config): %s",
                               e)
                hcfg = None
            if hcfg is not None and hcfg.enabled:
                self.health = HealthPlane(hcfg, metrics=self.registry,
                                          service="gateway")
        # Profiling plane: host sampling profiler for the gateway process —
        # the forward path is pure Python/asyncio, exactly what wall-clock
        # flamegraphs explain.  Env knobs: SELDON_PROFILE /
        # SELDON_PROFILE_HZ.  Served from /admin/profile*.
        if profiler is not None:
            self.profiler = profiler
        else:
            self.profiler = None
            try:
                from seldon_core_tpu_torch.profiling import (
                    ProfilePlane,
                    profile_config_from_annotations,
                )

                pcfg = profile_config_from_annotations({}, "gateway")
            except ValueError as e:
                logger.warning(
                    "profiling plane disabled (bad env config): %s", e)
                pcfg = None
            if pcfg is not None and pcfg.enabled:
                self.profiler = ProfilePlane(pcfg, metrics=self.registry,
                                             service="gateway")
        # Placement and artifact planes live in the ENGINE runtimes — the
        # gateway only forwards — so none is built here; a colocated
        # harness may hand one in.  Without one the endpoints answer 404
        # with the enablement hint.
        self.placement = placement
        self.artifacts = artifacts
        # Fleet observability: scatter-gather scraper + differential
        # straggler analysis over the pooled deployments, served from
        # /admin/fleet/* and feeding straggler penalties back into each
        # pool's routing policy.
        from seldon_core_tpu_torch.fleet import FleetObserver

        self.observer = FleetObserver(metrics=self.registry)
        if self.health is not None:
            from seldon_core_tpu_torch.health import (
                device_memory_probe,
                device_registry_probe,
            )

            self.health.sampler.add_probe("device", device_memory_probe())
            self.health.sampler.add_probe("device_registry",
                                          device_registry_probe())
            self.health.sampler.add_probe("gateway", self._gateway_probe)
            if self.profiler is not None:
                from seldon_core_tpu_torch.health import profile_probe

                self.health.profiler = self.profiler
                self.health.sampler.add_probe(
                    "profile", profile_probe(self.profiler))

    def _gateway_probe(self) -> dict:
        """Sampler probe over the gateway's per-deployment runtime state
        (caches + admission controllers, summed across deployments)."""
        out: dict = {}
        caches = [c for c in self._caches.values() if c is not None]
        if caches:
            out["cache_bytes"] = float(
                sum(c.stats.get("bytes", 0) for c in caches))
            out["cache_entries"] = float(
                sum(c.stats.get("entries", 0) for c in caches))
        admissions = [a for _, a in self._admission.values()
                      if a is not None]
        if admissions:
            out["admission_limit"] = float(
                sum(a.limit for a in admissions))
            out["admission_inflight"] = float(
                sum(a.inflight for a in admissions))
            out["shed_level"] = float(
                max(a.shed_level for a in admissions))
        pools = [p for _, _, p in self._pools.values() if p is not None]
        if pools:
            out["fleet_replicas"] = float(
                sum(len(p) for p in pools))
            out["fleet_healthy"] = float(
                sum(p.snapshot()["healthy"] for p in pools))
        return out

    # ------------------------------------------------------------------
    # shared forwarding client (pooled, apife parity: 150 conns per host)
    # ------------------------------------------------------------------
    def session(self) -> HttpSession:
        if self._session is None:
            self._session = HttpSession(limit=150)
        return self._session

    async def close(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None
        # a pool probe still in flight would eject (and record the
        # decision) after the gateway is gone: stop it first
        probes = list(self._probe_tasks)
        for task in probes:
            task.cancel()
        await asyncio.gather(*probes, return_exceptions=True)
        if self.health is not None:
            await self.health.aclose()
        if self.profiler is not None:
            await self.profiler.aclose()
        if self._session is not None:
            await self._session.close()
            self._session = None
        for ch in self._grpc_channels.values():
            await ch.close()
        # shutdown path, called once after the server stops accepting —
        # no concurrent coroutine mutates the pool here
        self._grpc_channels.clear()  # graphlint: disable=RL602
        # drain the firehose sink (NetworkFirehose buffers + batches;
        # records still queued at shutdown would otherwise vanish)
        closer = getattr(self.firehose, "close", None)
        if callable(closer):
            await asyncio.get_running_loop().run_in_executor(None, closer)

    # ------------------------------------------------------------------
    # REST app
    # ------------------------------------------------------------------
    def build_app(self, host: str = "0.0.0.0", port: int = 8080
                  ) -> RestServer:
        """The gateway's routes on a :class:`RestServer` (not started)."""
        app = RestServer(host=host, port=port)
        app.add_route("POST", "/oauth/token", self._handle_token)
        app.add_route("POST", "/api/v0.1/predictions", self._handle_predict)
        app.add_stream("/api/v0.1/stream", self._handle_stream)
        app.add_route("POST", "/api/v0.1/feedback", self._handle_feedback)
        app.add_route("GET", "/ready", self._handle_ready)
        app.add_route("GET", "/live", self._handle_ready)
        app.add_route("GET", "/metrics", self._handle_metrics)
        app.add_route("GET", "/seldon.json", self._handle_openapi)
        app.add_route("GET", "/admin/traces", self._handle_traces)
        app.add_route("GET", "/admin/introspect", self._handle_introspect)
        app.add_route("GET", "/admin/flightrecorder",
                      self._handle_flightrecorder)
        app.add_route("GET", "/admin/health", self._handle_health)
        app.add_route("GET", "/admin/profile", self._handle_profile)
        app.add_route("GET", "/admin/profile/capture",
                      self._handle_profile_capture)
        app.add_route("GET", "/admin/profile/compile",
                      self._handle_profile_compile)
        app.add_route("GET", "/admin/profile/capacity",
                      self._handle_profile_capacity)
        app.add_route("GET", "/admin/placement", self._handle_placement)
        app.add_route("GET", "/admin/artifacts", self._handle_artifacts)
        app.add_route("GET", "/admin/fleet", self._handle_fleet)
        for kind in ("traces", "health", "flightrecorder", "profile",
                     "capacity", "decisions"):
            app.add_route("GET", f"/admin/fleet/{kind}",
                          self._fleet_obs_route(kind))
        return app

    async def start(self, host: str = "0.0.0.0", port: int = 8080
                    ) -> RestServer:
        """Build and start the REST server; ``close()`` stops it."""
        self._server = await self.build_app(host, port).start()
        return self._server

    async def _handle_token(self, req: Request) -> Response:
        status, body = self.oauth.token_request(
            req.headers.get("authorization"), _form(req))
        return _json_response(body, status)

    def _principal(self, req: Request) -> Optional[str]:
        return self.oauth.principal_for_bearer(
            req.headers.get("authorization"))

    def _deployment(self, req: Request):
        """``(principal, record, None)`` or ``(.., .., error Response)``:
        401 without a live token, 404 without a deployment."""
        principal = self._principal(req)
        if principal is None:
            return None, None, _json_response(_UNAUTHORIZED, 401)
        rec = self.store.by_oauth_key(principal)
        if rec is None or not rec.engine_url:
            return principal, rec, _json_response(
                {"status": {"code": 404, "status": "FAILURE",
                            "info": f"no deployment for client {principal}"}},
                404)
        return principal, rec, None

    async def _forward(self, req: Request, path: str) -> Response:
        t0 = time.perf_counter()
        principal, rec, err = self._deployment(req)
        if err is not None:
            return err
        body = req.body
        content_type = req.headers.get("content-type", "application/json")
        # QoS: priority + deadline ride in from the client's
        # X-Seldon-Priority / X-Seldon-Deadline-Ms headers and out to the
        # engine hop (remaining budget restamped at send).
        qctx = qos_from_headers(req.headers)
        admission = (
            self._dep_admission(rec) if path.endswith("/predictions")
            else None
        )
        # Tracing: accept the client's W3C context or mint one (head
        # sampling decided here, at ingress).  The gateway root span wraps
        # the whole forward — admission shed, cache hit, engine hop.
        tctx = None
        if self.tracer is not None:
            tctx = (trace_from_headers(req.headers)
                    or self.tracer.new_context())
        # Prediction cache (annotation seldon.io/prediction-cache on the
        # deployment record): a byte-identical repeat of a /predictions
        # body never re-traverses gateway→engine→model; concurrent
        # identical bodies coalesce onto ONE in-flight engine forward.
        # Feedback is stateful (MAB rewards) and never cached.  Cache hits
        # and coalesced followers never consume an admission slot.
        cache_state: Optional[str] = None
        # every engine attempt (including connect-failed ones) leaves one
        # record here: the "hop log" behind the X-Seldon-Replica header
        # and the hop spans /admin/fleet/traces stitches by
        hops: list[dict] = []
        with contextlib.ExitStack() as stack:
            root = None
            if tctx is not None:
                stack.enter_context(trace_scope(tctx))
                root = stack.enter_context(self.tracer.trace(
                    tctx.trace_id, name="gateway",
                    deployment=rec.name, path=path,
                ))
            cache = (
                self._dep_cache(rec) if path.endswith("/predictions")
                else None
            )
            if cache is not None:
                key = raw_key(rec.name, path, body)
                hit = cache.get(key)
                if hit is not None:
                    out_status, out_body = hit
                    cache_state = "hit"
                else:

                    async def compute():
                        st, bd = await self._admitted_forward(
                            rec, path, body, content_type, qctx, admission,
                            hops=hops,
                        )
                        if st == 200:
                            cache.put(key, (st, bd), len(bd) + len(key))
                        return st, bd

                    (out_status, out_body), coalesced = await self._flight.run(
                        key, compute
                    )
                    if coalesced:
                        cache.note_coalesced(1)
                        cache_state = "coalesced"
                    else:
                        cache_state = "miss"
            else:
                out_status, out_body = await self._admitted_forward(
                    rec, path, body, content_type, qctx, admission,
                    hops=hops,
                )
            if path.endswith("/predictions") and not isinstance(
                self.firehose, NullFirehose
            ):
                # parse only for the firehose, never on the forward path,
                # and publish off the event loop — fire-and-forget like the
                # reference's 20ms-max-block Kafka send
                # (apife RestClientController.java:165)
                def _publish(principal=principal, body=body,
                             out_body=out_body):
                    try:
                        self.firehose.publish(
                            principal, json.loads(body), json.loads(out_body)
                        )
                    except Exception:
                        logger.exception("firehose publish failed")

                asyncio.get_running_loop().run_in_executor(None, _publish)
            # apife metric parity: seldon_api_server_ingress_* timer tagged
            # by deployment, observed INSIDE the trace scope so the latency
            # histogram attaches this trace's ID as its exemplar
            self.registry.observe(
                "seldon_api_server_ingress_seconds",
                time.perf_counter() - t0,
                {"deployment": rec.name, "path": path},
            )
            if root is not None:
                if cache_state:
                    root.attributes["cache"] = cache_state
                if out_status >= 400:
                    root.status = f"ERROR: HTTP_{out_status}"
                    if out_status in (429, 503, 504):
                        root.add_event(
                            "shed", reason=_shed_reason(out_body),
                            status=out_status,
                        )
        # the replica that actually answered (last hop that got a
        # response); killed/ejected attempts precede it in the hop log
        served = next((h["replica"] for h in reversed(hops)
                       if h.get("status") and h.get("replica")), "")
        if self.health is not None:
            # unconditional flight record (unlike sampled traces): raw
            # body kept so a replay can re-issue the request verbatim
            self.health.ensure_started()
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            self.health.recorder.record(
                trace_id=tctx.trace_id if tctx is not None else "",
                deployment=rec.name,
                route=(path,),
                status=out_status,
                reason=_shed_reason(out_body) if out_status >= 400 else "",
                duration_ms=elapsed_ms,
                replica=served,
                flags={
                    "shed": out_status == 429,
                    "cache": cache_state or "off",
                    "path": path,
                    "attempts": len(hops),
                },
                request={
                    "body": body.decode("utf-8", "replace"),
                    "contentType": content_type,
                    "path": path,
                },
                request_bytes=len(body),
            )
            self.health.note_request(elapsed_ms, out_status)
        headers: dict[str, str] = {}
        if cache_state:
            headers["X-Seldon-Cache"] = cache_state
        if served:
            headers["X-Seldon-Replica"] = served
        if out_status == 429:
            # every 429 leaving the gateway carries a Retry-After —
            # admission sheds (ours) and engine queue-full sheds alike
            retry_s = (
                admission.retry_after_s() if admission is not None else 1.0
            )
            headers["Retry-After"] = str(max(1, round(retry_s)))
        return Response(out_status, out_body, "application/json", headers)

    async def _admitted_forward(
        self,
        rec,
        path: str,
        body: bytes,
        content_type: str,
        qctx: Optional[QosContext] = None,
        admission: Optional[AdmissionController] = None,
        hops: Optional[list] = None,
    ) -> tuple[int, bytes]:
        """Admission gate around one engine forward.

        A refused request answers 429 ADMISSION_SHED immediately — the
        whole point of shedding at the gateway is that the "no" costs
        microseconds and zero engine work.  Admitted requests release
        their slot with the observed latency, feeding the AIMD limit."""
        if admission is None:
            return await self._forward_engine(rec, path, body, content_type,
                                              qctx, hops=hops)
        priority = qctx.priority if qctx is not None else "normal"
        if not admission.try_acquire(priority):
            retry_s = admission.retry_after_s()
            shed = AdmissionShedError(
                f"shed at gateway admission (priority {priority}, "
                f"concurrency limit {admission.limit}); retry after "
                f"{retry_s:.1f}s", retry_s)
            return shed.status_code, _failure_body(
                shed.status_code, str(shed), shed.reason)
        t0 = time.perf_counter()
        ok = False
        try:
            st, bd = await self._forward_engine(rec, path, body,
                                                content_type, qctx,
                                                hops=hops)
            ok = st == 200
            return st, bd
        finally:
            admission.release(time.perf_counter() - t0, ok)

    def _note_failed_hop(self, rec, path: str, rid: str, url: str,
                         attempt: int, reason: str,
                         elapsed_ms: float) -> None:
        """A connect-failed / timed-out attempt is observable, not silent:
        it leaves a flight record (status 503, its own reason) beside the
        request's final record."""
        if self.health is None:
            return
        ctx = current_trace()
        self.health.ensure_started()
        self.health.recorder.record(
            trace_id=ctx.trace_id if ctx is not None else "",
            deployment=rec.name,
            route=(path,),
            status=503,
            reason=reason,
            duration_ms=elapsed_ms,
            replica=rid,
            flags={"attempt": attempt, "retryHop": True, "url": url},
        )

    async def _forward_engine(
        self, rec, path: str, body: bytes, content_type: str,
        qctx: Optional[QosContext] = None,
        hops: Optional[list] = None,
    ) -> tuple[int, bytes]:
        """One engine forward with connection-failure retries (reference
        apife HttpRetryHandler.java: 3 attempts).  POST predict is safe to
        retry ONLY when the request never reached the engine — a
        :class:`ConnectError` qualifies; once a response (any status)
        arrives it passes through, and a connection that broke after it
        opened answers 503 unretried.  Persistent unreachability becomes
        the 503 FAILURE body (never cached: the caller only stores 200s).

        With a fleet pool each attempt picks a replica under the routing
        policy, and a connection failure EXCLUDES the observed replica and
        tries the next one; the failed replica is ejected from membership
        and re-probed half-open-style.  Retries live inside the request's
        deadline budget (each attempt's timeout is the REMAINING budget;
        decorrelated-jitter backoff; a retry that cannot fit answers 504
        at once)."""
        sess = self.session()
        deadline = qctx.deadline if qctx is not None else None
        pool = self._dep_pool(rec)
        route_key = (
            raw_key(rec.name, path, body)
            if pool is not None and pool.config.policy == "consistent-hash"
            else None
        )
        if pool is not None and pool.probe_due(self.fleet_probe_interval_s):
            # active health sweep, off this request's critical path; keep a
            # strong ref until done (RL603: bare tasks can be GC'd mid-flight)
            task = asyncio.get_running_loop().create_task(
                self._pool_probe(pool))
            self._probe_tasks.add(task)
            task.add_done_callback(self._probe_tasks.discard)
        last_err: Optional[Exception] = None
        excluded: list[str] = []
        out_body, out_status = b"", 0
        backoff = 0.0
        for attempt in range(self.retries + 1):
            if attempt:
                backoff = _decorrelated_backoff(
                    self._retry_rng, self.retry_backoff_s, backoff
                )
                if (deadline is not None
                        and deadline.remaining_s() <= backoff):
                    # budget exhausted: the retry could never answer in
                    # time — stop burning engine capacity on it
                    return 504, _failure_body(
                        504, "deadline budget exhausted before retry "
                             f"{attempt} (engine error: {last_err})",
                        "DEADLINE_EXCEEDED")
                await asyncio.sleep(backoff)
                self.registry.counter_inc(
                    "seldon_api_gateway_retries_total",
                    {"deployment": rec.name, "path": path},
                )
            url = rec.engine_url
            replica = None
            if pool is not None:
                replica = pool.pick(key=route_key, exclude=excluded)
                if replica is not None:
                    url = replica.url
            hop_headers = {"Content-Type": content_type}
            if qctx is not None:
                hop_headers.update(forward_headers(qctx))
            # W3C context propagation: the gateway root span (ambient via
            # trace_scope in _forward) parents the engine hop
            hop_headers.update(trace_headers(current_trace()))
            timeout_s = FORWARD_TIMEOUT_S
            if deadline is not None:
                timeout_s = deadline.remaining_s()
                if timeout_s <= 0:
                    return 504, _failure_body(
                        504, "deadline budget exhausted at the gateway",
                        "DEADLINE_EXCEEDED")
            if replica is not None:
                pool.acquire(replica)
            rid = replica.rid if replica is not None else ""
            t_attempt = time.perf_counter()
            # hop span: one per ATTEMPT, failed ones included — the unit
            # /admin/fleet/traces stitches a failover journey from
            with contextlib.ExitStack() as hop_stack:
                hop_sp = None
                if self.tracer is not None and self.tracer.enabled:
                    hop_sp = hop_stack.enter_context(self.tracer.span(
                        "hop", kind="hop", replica=rid, url=url,
                        attempt=attempt,
                    ))
                try:
                    out_status, resp_headers, out_body = await sess.request(
                        "POST", url.rstrip("/") + path, body, hop_headers,
                        timeout_s=timeout_s)
                    if not rid:
                        # direct (poolless) forward: the engine says who it
                        # is in its own response header
                        rid = resp_headers.get("x-seldon-replica", "")
                    last_err = None
                    if hop_sp is not None:
                        if rid and not hop_sp.attributes.get("replica"):
                            hop_sp.attributes["replica"] = rid
                        if out_status >= 500:
                            hop_sp.status = f"ERROR: HTTP_{out_status}"
                    if replica is not None:
                        pool.release(
                            replica, ok=out_status < 500,
                            latency_ms=(time.perf_counter() - t_attempt)
                            * 1000.0,
                        )
                    if hops is not None:
                        hops.append({"replica": rid, "url": url,
                                     "attempt": attempt,
                                     "status": out_status})
                    break
                except ConnectError as e:
                    # connection never established — the request cannot
                    # have reached the engine, so replaying it is safe; a
                    # pooled replica is excluded for this request AND
                    # ejected from membership (half-open re-probe
                    # readmits it)
                    last_err = e
                    if hop_sp is not None:
                        hop_sp.status = "ERROR: CONNECT_FAILED"
                        hop_sp.attributes["eject_reason"] = "connect-error"
                    if replica is not None:
                        pool.release(replica, ok=False)
                        pool.eject(replica, "connect-error")
                        excluded.append(replica.url)
                    if hops is not None:
                        hops.append({"replica": rid, "url": url,
                                     "attempt": attempt, "status": 0,
                                     "error": "CONNECT_FAILED"})
                    self._note_failed_hop(
                        rec, path, rid, url, attempt, "CONNECT_FAILED",
                        (time.perf_counter() - t_attempt) * 1000.0)
                except asyncio.TimeoutError:
                    # the budget expired mid-forward: the engine may still
                    # be computing, but the answer is already worthless
                    if hop_sp is not None:
                        hop_sp.status = "ERROR: DEADLINE_EXCEEDED"
                    if replica is not None:
                        pool.release(replica, ok=False)
                    if hops is not None:
                        hops.append({"replica": rid, "url": url,
                                     "attempt": attempt, "status": 0,
                                     "error": "DEADLINE_EXCEEDED"})
                    self._note_failed_hop(
                        rec, path, rid, url, attempt, "DEADLINE_EXCEEDED",
                        (time.perf_counter() - t_attempt) * 1000.0)
                    return 504, _failure_body(
                        504, "deadline budget exhausted while forwarding "
                             "to the engine", "DEADLINE_EXCEEDED")
                except (HttpError, OSError) as e:
                    # the connection broke after it opened: the engine may
                    # have executed the (non-idempotent) request before
                    # dying — a replay could e.g. apply a MAB feedback
                    # reward twice
                    last_err = e
                    if hop_sp is not None:
                        hop_sp.status = f"ERROR: {type(e).__name__}"
                    if replica is not None:
                        pool.release(replica, ok=False)
                    if hops is not None:
                        hops.append({"replica": rid, "url": url,
                                     "attempt": attempt, "status": 0,
                                     "error": type(e).__name__})
                    break
        if last_err is not None:
            return 503, _failure_body(503,
                                      f"engine unreachable: {last_err}")
        return out_status, out_body

    def _dep_admission(self, rec) -> Optional[AdmissionController]:
        """The deployment's gateway-tier admission controller, built (and
        rebuilt on annotation change) from ``seldon.io/slo-p95-ms``.
        Invalid values log once and leave admission off — the gateway must
        keep serving; admission rejects them upstream."""
        try:
            cfg = qos_from_annotations(rec.annotations, rec.name)
        except ValueError as e:
            if rec.name not in self._admission or \
                    self._admission[rec.name][1] is not None:
                logger.warning("deployment %s: %s — admission disabled",
                               rec.name, e)
            self._admission[rec.name] = (0.0, None)
            return None
        if cfg is None or not cfg.admission_enabled:
            self._admission.pop(rec.name, None)
            return None
        cur = self._admission.get(rec.name)
        if cur is not None and cur[0] == cfg.slo_p95_ms:
            return cur[1]
        ctl = AdmissionController(
            AdmissionConfig(target_p95_ms=cfg.slo_p95_ms),
            name=rec.name, metrics=self.registry,
        )
        self._admission[rec.name] = (cfg.slo_p95_ms, ctl)
        return ctl

    def _dep_cache(self, rec) -> Optional[PredictionCache]:
        """The deployment's gateway-tier cache, built (and rebuilt on
        annotation change) from its ``seldon.io/prediction-cache*``
        annotations.  Invalid values log once and leave the tier off —
        admission rejects them upstream; the gateway must keep serving."""
        try:
            cfg = config_from_annotations(rec.annotations, rec.name)
        except ValueError as e:
            if rec.name not in self._caches or \
                    self._caches[rec.name] is not None:
                logger.warning("deployment %s: %s — cache disabled",
                               rec.name, e)
            self._caches[rec.name] = None
            return None
        if cfg is None:
            self._caches.pop(rec.name, None)
            return None
        cur = self._caches.get(rec.name)
        if cur is not None and cur.config == cfg:
            return cur
        cache = PredictionCache(cfg, metrics=self.registry)
        self._caches[rec.name] = cache
        return cache

    def _dep_pool(self, rec) -> Optional[ReplicaPool]:
        """The deployment's replica pool, built (and rebuilt on annotation
        or membership change) from its ``seldon.io/fleet-*`` annotations
        and the record's ``engine_urls``.  Invalid values log once and
        route with defaults.  Single-URL records without fleet annotations
        return None: the direct-forward path."""
        urls = rec.urls
        try:
            cfg = fleet_config_from_annotations(rec.annotations, rec.name)
        except ValueError as e:
            cur = self._pools.get(rec.name)
            if cur is None or cur[0] is not None:
                logger.warning("deployment %s: %s — fleet defaults in "
                               "effect", rec.name, e)
            cfg = None
        effective = cfg if cfg is not None else FleetConfig(enabled=True)
        if len(urls) <= 1 and not effective.enabled:
            self._pools.pop(rec.name, None)
            return None
        cur = self._pools.get(rec.name)
        if cur is not None and cur[0] == cfg:
            pool = cur[2]
            if cur[1] != urls:
                pool.set_members(urls)
                self._pools[rec.name] = (cfg, urls, pool)
            return pool
        pool = ReplicaPool(
            rec.name, config=effective, members=urls,
            metrics=self.registry,
        )
        self._pools[rec.name] = (cfg, urls, pool)
        return pool

    async def _pool_probe(self, pool: ReplicaPool) -> None:
        """Active health sweep: every member's ``/admin/health`` verdict
        (breaker state rides along) and ``/admin/profile/capacity``
        headroom feed the pool's eject/readmit and least-loaded scoring.
        Replicas that refuse the connection are ejected; half-open
        re-probes readmit them once the verdict clears.  Best-effort per
        replica — a probe failure must never take the data path down."""
        sess = self.session()
        for rep in pool.replicas():
            base = rep.url.rstrip("/")
            try:
                status, payload = await sess.get_json(
                    base + "/admin/health", timeout_s=2.0)
                if status == 200:
                    pool.note_verdict(
                        rep.url,
                        payload.get("verdict", ""),
                        payload.get("openBreakers") or (),
                    )
            except (ConnectError, asyncio.TimeoutError):
                pool.eject(rep, "probe-failed")
                continue
            except (HttpError, OSError, ValueError, AttributeError):
                pass  # plane off / malformed body: no verdict signal
            try:
                status, payload = await sess.get_json(
                    base + "/admin/profile/capacity", timeout_s=2.0)
                if status == 200:
                    pool.note_headroom(rep.url, payload.get("headroom"))
            except (HttpError, OSError, asyncio.TimeoutError, ValueError,
                    AttributeError):
                pass  # capacity signal is optional for routing

    async def _handle_predict(self, req: Request) -> Response:
        return await self._forward(req, "/api/v0.1/predictions")

    async def _handle_stream(self, req: Request):
        """Streaming proxy: auth → engine ``/api/v0.1/stream`` → bytes
        relayed to the client as they arrive (no buffering, no firehose —
        SSE events are not request/response pairs).  Retries only apply
        before the engine connection is established; once bytes flow a
        failure terminates the stream (SSE convention)."""
        t0 = time.perf_counter()
        principal, rec, err = self._deployment(req)
        if err is not None:
            return err

        def observe() -> None:
            # once per request (not per relay attempt), after the stream
            # ends, as the reference observes its handler's whole life
            self.registry.observe(
                "seldon_api_server_ingress_seconds",
                time.perf_counter() - t0,
                {"deployment": rec.name, "path": "/api/v0.1/stream"},
            )

        # session affinity: SSE consumers resume against the SAME replica
        # (KV/stream state is replica-local); the session key is the
        # caller-provided header, falling back to the oauth principal
        pool = self._dep_pool(rec)
        session_key = req.headers.get(SESSION_HEADER.lower()) or principal
        last_err: Optional[Exception] = None
        excluded: list[str] = []
        backoff = 0.0
        out = None
        try:
            for attempt in range(self.retries + 1):
                if attempt:
                    backoff = _decorrelated_backoff(
                        self._retry_rng, self.retry_backoff_s, backoff
                    )
                    await asyncio.sleep(backoff)
                    self.registry.counter_inc(
                        "seldon_api_gateway_retries_total",
                        {"deployment": rec.name, "path": "/api/v0.1/stream"},
                    )
                url = rec.engine_url
                replica = None
                if pool is not None:
                    replica = pool.pick(session=session_key,
                                        exclude=excluded)
                    if replica is not None:
                        url = replica.url
                t_attempt = time.perf_counter()
                try:
                    out = await self._relay_stream(req, rec, body=req.body,
                                                   url=url, on_end=observe)
                    return out
                except ConnectError as e:
                    last_err = e
                    if replica is not None:
                        pool.eject(replica, "connect-error")
                        excluded.append(replica.url)
                    self._note_failed_hop(
                        rec, "/api/v0.1/stream",
                        replica.rid if replica is not None else "", url,
                        attempt, "CONNECT_FAILED",
                        (time.perf_counter() - t_attempt) * 1000.0)
            out = _json_response(
                {"status": {"code": 503, "status": "FAILURE",
                            "info": f"engine unreachable: {last_err}"}},
                503)
            return out
        finally:
            if not isinstance(out, RelayStream):
                observe()

    async def _relay_stream(self, req: Request, rec, body: bytes,
                            url: str = "", on_end=None):
        """One relay attempt: a :class:`RelayStream` over the engine's
        stream, the engine's pre-stream JSON answer with its status, or a
        503.  A :class:`ConnectError` propagates (the caller retries)."""
        target = (url or rec.engine_url).rstrip("/") + "/api/v0.1/stream"
        try:
            # streams are deadline-free by design (a total timeout would
            # kill a long generation MID-STREAM); the connect is bounded
            status, headers, chunks = await self.session().stream(
                "POST", target, body,
                {"Content-Type": req.headers.get("content-type",
                                                 "application/json")},
                connect_timeout_s=10.0)
        except ConnectError:
            raise  # retried by the caller (never reached the engine)
        except (HttpError, OSError, asyncio.IncompleteReadError) as e:
            return _json_response(
                {"status": {"code": 503, "status": "FAILURE",
                            "info": f"engine unreachable: {e}"}}, 503)
        ctype = headers.get("content-type", "").split(";")[0].strip()
        if ctype != "text/event-stream":
            # pre-stream error (e.g. 501 STREAM_UNSUPPORTED): pass the
            # JSON through with its status
            try:
                data = b"".join([c async for c in chunks])
            except (HttpError, OSError, asyncio.IncompleteReadError) as e:
                return _json_response(
                    {"status": {"code": 503, "status": "FAILURE",
                                "info": f"engine unreachable: {e}"}}, 503)
            finally:
                await chunks.aclose()
            return Response(status, data, "application/json")
        try:
            first = await chunks.__anext__()
        except StopAsyncIteration:
            first = b""
        except (HttpError, OSError, asyncio.IncompleteReadError):
            # the engine went away right after its headers: the stream
            # ends empty (headers go out, nothing follows), as the
            # reference's relay does
            await chunks.aclose()
            first = b""
        return RelayStream(first, _relay_chunks(chunks), on_end=on_end)

    async def _handle_feedback(self, req: Request) -> Response:
        return await self._forward(req, "/api/v0.1/feedback")

    async def _handle_ready(self, req: Request) -> Response:
        return Response(200, b"ready", "text/plain")

    async def _handle_openapi(self, req: Request) -> Response:
        from seldon_core_tpu_torch.serving import openapi

        return _json_response(openapi.gateway_spec())

    async def _handle_metrics(self, req: Request) -> Response:
        return Response(200, self.registry.render().encode(), "text/plain")

    async def _handle_traces(self, req: Request) -> Response:
        """Collected-trace query endpoint: filter exported traces by
        deployment / status / min duration / drill id.

        ``GET /admin/traces?deployment=d&status=error&min_ms=50&drill=x
        &trace_id=...&replica=r1&n=20`` — ``replica`` matches either the
        record's own replica or any hop span that attempted one.
        """
        collector = getattr(self.tracer, "collector", None)
        if collector is None:
            return _json_response(
                {"error": "tracing disabled",
                 "hint": "set SELDON_TRACING=true on the gateway"}, 404)
        q = req.query
        if "stats" in q:
            return _json_response({"collector": collector.stats()})
        try:
            min_ms = float(q["min_ms"]) if "min_ms" in q else None
            n = int(q.get("n", "50"))
        except ValueError:
            return _json_response(
                {"error": "min_ms and n must be numeric"}, 400)
        traces = collector.query(
            deployment=q.get("deployment"),
            status=q.get("status"),
            min_duration_ms=min_ms,
            drill=q.get("drill"),
            trace_id=q.get("trace_id"),
            replica=q.get("replica"),
            n=n,
        )
        return _json_response({"traces": traces, "stats": collector.stats()})

    def _plane_endpoint(self, plane, body_fn, query) -> Response:
        """Shared wrapper for the plane admin routes: 404 + hint when the
        plane is off, 400 on malformed numerics (the /admin/traces
        contract)."""
        try:
            status, payload = body_fn(plane, query)
        except ValueError:
            return _json_response(
                {"error": "numeric query parameter expected"}, 400)
        return _json_response(payload, status)

    async def _handle_introspect(self, req: Request) -> Response:
        from seldon_core_tpu_torch.health.http import introspect_body

        return self._plane_endpoint(self.health, introspect_body, req.query)

    async def _handle_flightrecorder(self, req: Request) -> Response:
        from seldon_core_tpu_torch.health.http import flightrecorder_body

        return self._plane_endpoint(self.health, flightrecorder_body,
                                    req.query)

    async def _handle_health(self, req: Request) -> Response:
        from seldon_core_tpu_torch.health.http import health_body

        return self._plane_endpoint(self.health, health_body, req.query)

    async def _handle_profile(self, req: Request) -> Response:
        from seldon_core_tpu_torch.profiling.http import profile_body

        return self._plane_endpoint(self.profiler, profile_body, req.query)

    async def _handle_profile_capture(self, req: Request) -> Response:
        from seldon_core_tpu_torch.profiling.http import capture_body

        return self._plane_endpoint(self.profiler, capture_body, req.query)

    async def _handle_profile_compile(self, req: Request) -> Response:
        from seldon_core_tpu_torch.profiling.http import compile_body

        return self._plane_endpoint(self.profiler, compile_body, req.query)

    async def _handle_profile_capacity(self, req: Request) -> Response:
        from seldon_core_tpu_torch.profiling.http import capacity_body

        return self._plane_endpoint(self.profiler, capacity_body, req.query)

    async def _handle_artifacts(self, req: Request) -> Response:
        from seldon_core_tpu_torch.artifacts.http import artifacts_body

        status, payload = artifacts_body(self.artifacts, req.query)
        return _json_response(payload, status)

    async def _handle_placement(self, req: Request) -> Response:
        """``/admin/placement`` over the plane handed in (``placement=``),
        the 404 body without one."""
        from seldon_core_tpu_torch.placement.http import placement_body

        try:
            status, payload = placement_body(self.placement, req.query)
        except ValueError:
            return _json_response(
                {"error": "numeric query parameter expected"}, 400)
        return _json_response(payload, status)

    def _all_pools(self) -> dict:
        """Every pooled deployment; pools materialize lazily on first
        forward, so they are built here too and the admin views reflect
        the store even before traffic arrives."""
        for name in self.store.names():
            rec = self.store.by_name(name)
            if rec is not None:
                self._dep_pool(rec)
        return {name: entry[2] for name, entry in self._pools.items()
                if entry[2] is not None}

    async def _handle_fleet(self, req: Request) -> Response:
        """Per-replica fleet view of every pooled deployment: membership,
        health state, in-flight load, hash-ring arcs, session bindings.
        ``?deployment=name`` narrows to one pool."""
        try:
            status, payload = fleet_body(self._all_pools(), req.query)
        except ValueError:
            return _json_response(
                {"error": "numeric query parameter expected"}, 400)
        return _json_response(payload, status)

    def _fleet_obs_route(self, kind: str):
        async def handler(req: Request) -> Response:
            return await self._handle_fleet_obs(req, kind)

        return handler

    async def _handle_fleet_obs(self, req: Request, kind: str) -> Response:
        """``/admin/fleet/{traces,health,flightrecorder,profile,capacity,
        decisions}``: cross-replica aggregation over one pooled
        deployment (``?deployment=`` — optional when exactly one pool
        exists).  Dead replicas come back as ``unreachable`` inside a
        ``partial: true`` envelope, never as a 500 and never touching the
        data path."""
        from seldon_core_tpu_torch.fleet.observe import (
            OBS_DISABLED,
            decisions_body,
            fleet_obs_body,
        )

        try:
            if kind == "decisions":
                status, payload = decisions_body(self.observer.audit,
                                                 req.query)
                return _json_response(payload, status)
            pools = self._all_pools()
            want = req.query.get("deployment")
            if want is None and len(pools) == 1:
                want = next(iter(pools))
            pool = pools.get(want) if want else None
            if pool is None:
                return _json_response(
                    {**OBS_DISABLED, "deployments": sorted(pools)}, 404)
            targets = [(rep.rid, rep.url) for rep in pool.replicas()]
            gateway_records: list = []
            if kind == "traces":
                collector = getattr(self.tracer, "collector", None)
                if collector is not None:
                    gateway_records = collector.query(
                        trace_id=req.query.get("trace_id"),
                        deployment=want,
                        n=int(req.query.get("n", 20)),
                    )
            status, payload = await fleet_obs_body(
                self.observer, self.session(), targets, kind,
                req.query, deployment=want, pool=pool,
                gateway_records=gateway_records,
            )
        except ValueError:
            return _json_response(
                {"error": "numeric query parameter expected"}, 400)
        return _json_response(payload, status)

    # ------------------------------------------------------------------
    # gRPC front (Seldon service, forwards to engine gRPC)
    # ------------------------------------------------------------------
    def grpc_handler(self):
        import grpc
        import grpc.aio

        from seldon_core_tpu_torch.proto import prediction_pb2 as pb
        from seldon_core_tpu_torch.serving.grpc_api import (
            _PKG,
            _Stub,
            grpc_options,
        )

        def _target(md: dict) -> Optional[str]:
            principal = self.oauth.principal_for_token(md.get("oauth_token"))
            if principal is None:
                return None
            rec = self.store.by_oauth_key(principal)
            if rec is None or not rec.engine_grpc:
                return None
            return rec.engine_grpc

        stubs: dict[str, _Stub] = {}

        def _stub(target: str) -> _Stub:
            # one channel+stub per engine target (reference apife keeps a
            # channel cache per deployment, grpc/SeldonGrpcServer.java)
            stub = stubs.get(target)
            if stub is None:
                ch = grpc.aio.insecure_channel(target, options=grpc_options())
                self._grpc_channels[target] = ch
                stub = stubs[target] = _Stub(ch, "Seldon")
            return stub

        async def _forward_unary(method, resp_cls, request_pb, context):
            md = {k: v for k, v in (context.invocation_metadata() or [])}
            target = _target(md)
            if target is None:
                await context.abort(
                    grpc.StatusCode.UNAUTHENTICATED,
                    "invalid oauth_token or unknown deployment",
                )
                return resp_cls()
            return await getattr(_stub(target), method)(request_pb,
                                                        timeout=30.0)

        async def predict(request_pb, context):
            return await _forward_unary(
                "Predict", pb.SeldonMessage, request_pb, context
            )

        async def send_feedback(request_pb, context):
            return await _forward_unary(
                "SendFeedback", pb.SeldonMessage, request_pb, context
            )

        return grpc.method_handlers_generic_handler(
            f"{_PKG}.Seldon",
            {
                "Predict": grpc.unary_unary_rpc_method_handler(
                    predict,
                    request_deserializer=pb.SeldonMessage.FromString,
                    response_serializer=pb.SeldonMessage.SerializeToString,
                ),
                "SendFeedback": grpc.unary_unary_rpc_method_handler(
                    send_feedback,
                    request_deserializer=pb.Feedback.FromString,
                    response_serializer=pb.SeldonMessage.SerializeToString,
                ),
            },
        )

    # ------------------------------------------------------------------
    # store refresh loop (the CRD-watch analog)
    # ------------------------------------------------------------------
    async def watch_loop(self) -> None:
        while True:
            try:
                self.store.refresh()
            except Exception:
                logger.exception("deployment store refresh failed")
            await asyncio.sleep(WATCH_INTERVAL_S)


async def _relay_chunks(chunks):
    """The engine stream's remaining bytes; an engine failure mid-stream
    ends it quietly (the headers are out, so no second response can
    follow), and closing this closes the engine connection."""
    try:
        async for data in chunks:
            yield data
    except (HttpError, OSError, asyncio.IncompleteReadError):
        return
    finally:
        await chunks.aclose()


def build_parser():
    import argparse
    import os

    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.gateway.app",
        description="seldon-core-tpu API gateway")
    ap.add_argument("--config",
                    default=os.environ.get("SELDON_GATEWAY_CONFIG") or None,
                    help="deployments JSON (see DeploymentStore.refresh); "
                         "env SELDON_GATEWAY_CONFIG; without it the gateway "
                         "starts empty and picks up deployments on refresh")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("GATEWAY_PORT", "8080")))
    ap.add_argument("--grpc-port", type=int,
                    default=int(os.environ.get("GATEWAY_GRPC_PORT", "5000")))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--firehose",
                    choices=["none", "jsonl", "segmented", "memory",
                             "network", "kafka"],
                    default="none")
    ap.add_argument("--firehose-dir", default="./firehose")
    ap.add_argument("--firehose-target", default="",
                    help="broker host:port for --firehose network "
                         "(default 127.0.0.1:7788, gateway/firehose_net.py)"
                         " or kafka bootstrap for --firehose kafka "
                         "(default 127.0.0.1:9092, "
                         "gateway/firehose_kafka.py)")
    ap.add_argument("--token-spill", default="")
    return ap


def main(argv: Optional[list] = None) -> None:
    import signal

    args = build_parser().parse_args(argv)
    store = DeploymentStore(args.config)
    gw = Gateway(
        store,
        firehose=make_firehose(
            args.firehose if args.firehose != "none" else "",
            args.firehose_dir, target=args.firehose_target,
        ),
        token_spill=args.token_spill or None,
    )

    async def serve():
        server = await gw.start(args.host, args.port)
        gserver = None
        if args.grpc_port:
            from seldon_core_tpu_torch.serving.grpc_api import GrpcServer

            gserver = GrpcServer([gw.grpc_handler()], port=args.grpc_port,
                                 host=args.host)
            await gserver.start()
            print(f"gateway gRPC on {args.host}:{gserver.port}", flush=True)
        print(f"gateway REST on {args.host}:{server.port} "
              f"({len(store.names())} deployments)", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        watch = loop.create_task(gw.watch_loop())
        try:
            await stop.wait()
        finally:
            watch.cancel()
            await asyncio.gather(watch, return_exceptions=True)
            if gserver is not None:
                await gserver.stop()
            # SIGINT/SIGTERM path: drain the firehose sink + close pools
            # (a buffered NetworkFirehose batch would otherwise vanish on
            # every rolling restart)
            await gw.close()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
