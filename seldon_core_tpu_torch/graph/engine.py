"""Graph runtime: the per-request walk of an inference graph (port of the
walk and feedback of ``seldon_core_tpu/graph/engine.py``).

Each node runs, in the reference's order: the ``requestPath`` stamp,
transformInput (``predict`` for a MODEL), return at a leaf, route (a
ROUTER's branch goes into ``meta.routing``; -1 fans out to every child),
the children concurrently (``asyncio.gather``), aggregate (a COMBINER) or
the first child's output, then transformOutput (an OUTPUT_TRANSFORMER).
Feedback replays the routing recorded in the response down the branch that
was taken, children first.  A ``metrics_sink`` (``utils.metrics.
EngineMetrics``) observes every node call (its seconds, "ok" or "error"),
takes the custom ``meta.metrics`` of each component response, and counts
feedback and its reward, as the reference's engine does.
:meth:`GraphEngine.stream` serves the token stream of a graph whose root
is a single streaming node.  A component
error becomes a FAILURE status: a :class:`SeldonComponentError` with its
own code, anything else 500 ``INTERNAL``.

QoS (``qos/``, given as an ``EngineQos``): the request's context (its
``meta.tags``, else the ambient one the server bound from the headers) is
restamped on the request for remote hops and bound for the walk; a request
whose budget has already run out answers 504 ``DEADLINE_EXCEEDED`` before
any model work; admission control answers 429 ``ADMISSION_SHED``; the walk
is bounded by the tighter of ``walk_timeout_s`` and the remaining budget
(504); and while a breaker is open, or the shed level has reached the
configured one, the ``seldon.io/qos-fallback`` subtree serves instead of
the root, with ``meta.tags.degraded`` saying why.

Fused plans (``plan_mode="fused"``, ``graph/plan.py``): the engine
compiles maximal static subgraphs into segments at construction and walks
the segment DAG instead of the node tree; a segment is one call per
request (one CUDA graph replay per batch on the card), optionally through
a dynamic batcher of its own (``plan_batcher``).  A graph in which nothing
fuses warns and keeps the plain walk.  Requests without a tensor payload
walk the nodes beneath a segment.

The prediction cache (``cache``, a ``caching.PredictionCache``): in walk
mode the engine memoises maximal deterministic-pure subtrees (one key,
one stored result, the subtree's meta delta replayed per request); in plan
mode it caches per segment, and a hit skips the segment entirely.
``cache_version`` (the ``seldon.io/spec-hash`` annotation) is folded into
every key.  Identical concurrent requests coalesce through one
single-flight table before any batcher: N arrivals, one computation, one
batch row.  A request refused by QoS never reaches the cache.

The artifact plane (``artifacts``, an ``artifacts.ArtifactPlane``, fused
plans only): attached to the plan at construction, which captures every
stored bucket whose key matches before any traffic; every response
carries ``meta.tags["artifact-source"]``, ``aot-cache`` when every bucket
this replica served was captured at boot from the store, else ``live``.

The device plane (``device_plane``, a ``runtime.device_plane.
DevicePlane``): a meta-only router (``ModelSignature.routes_on ==
"meta"``) routes on a message without its tensor, so a tensor on the card
is never copied to the host for it; a cache entry computed on the host is
kept as a CUDA tensor (never a downcast copy); every response carries
``meta.tags["device-plane"] = "on"``.  Torch tensors, unlike jax arrays,
can be changed in place, so an interior consumer of a shared cache entry
still gets a copy, made on the card.

Tracing (``tracer``, a ``utils.tracing.Tracer``): every request is a
root span keyed by its puid, with one span per node (its type as the
kind), per fused segment (``FUSED_SEGMENT``) and per cache hit or
coalesced follower (``CACHE_HIT``, ``CACHE_COALESCED``); the trace context
comes from the message's tags, else the one the server bound from
``traceparent``, else a new one whose trace id is the puid, and its
parity-safe part (``trace-id``, ``trace-flags``, ``trace-state``) is
stamped on the request and the response.  A traced request's segment
span carries ``host_dispatch_ms`` and ``device_block_ms``: a CUDA event
recorded after the replay is waited on, which an untraced request never
does.  Sheds get a root span with the reason as an event.

The health plane (``health``, a ``health.HealthPlane``): every exit path
of :meth:`predict` leaves one flight-recorder record (per-node ms, status,
flags) and one burn-monitor observation.  The profiling plane
(``profiler``, a ``profiling.ProfilePlane``): fused segments report their
captures into its ledger, and each request's share of every segment
batch's counted cost is attributed to it (``flags.flops`` in its flight
record).

The placement plane (``placement``, a ``placement.PlacementPlane``) is
attached to the plan after the profiling plane and before the artifact
plane: it arms the sharded executor on every segment that passes its
gate (``graph/plan.py``), its mesh spec keys the artifact store, flight
records carry ``flags["mesh"]``, and segment spans ``mesh`` and
``sharded``.  A
remote node (``serving.client.RemoteComponent``, ``serving.grpc_api.
GrpcComponentClient``) has the same method surface as a local one, async.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.graph.builtins import make_builtin
from seldon_core_tpu_torch.health.flightrecorder import (
    node_times_scope,
    note_node_time,
)
from seldon_core_tpu_torch.graph.spec import (
    PredictiveUnit,
    check_plan_mode,
    parse_graph,
    validate_graph,
)
from seldon_core_tpu_torch.messages import (
    Feedback,
    Meta,
    SeldonMessage,
    Status,
    new_puid,
)
from seldon_core_tpu_torch.qos.admission import AdmissionShedError
from seldon_core_tpu_torch.qos.context import (
    DEGRADED_TAG,
    current_qos,
    qos_from_meta,
    qos_scope,
    stamp_meta,
)
from seldon_core_tpu_torch.profiling.attribution import attribution_scope
from seldon_core_tpu_torch.runtime.component import (
    ComponentHandle,
    SeldonComponentError,
)
from seldon_core_tpu_torch.utils import maybe_await as _maybe_await
from seldon_core_tpu_torch.utils.tracing import (
    NULL_TRACER,
    TRACE_ID_TAG,
    current_trace,
    profile_annotation,
    stamp_trace_meta,
    trace_from_meta,
    trace_scope,
)

__all__ = ["GraphEngine"]

logger = logging.getLogger(__name__)


class _Node:
    __slots__ = ("unit", "impl", "children", "type", "meta_only_route")

    def __init__(self, unit: PredictiveUnit, impl: Any,
                 children: list["_Node"]):
        self.unit = unit
        self.impl = impl
        self.children = children
        self.type = unit.resolved_type
        self.meta_only_route = routes_on_meta(unit)


def routes_on_meta(unit: PredictiveUnit) -> bool:
    """A ROUTER whose registered signature declares that its decision
    reads meta and names only (``ModelSignature.routes_on``)."""
    if unit.resolved_type != "ROUTER":
        return False
    from seldon_core_tpu_torch import models as _models

    if unit.implementation:
        sig = _models.BUILTIN_SIGNATURES.get(unit.implementation)
    else:
        model_class = (unit.parameters or {}).get("model_class")
        sig = _models.signature_for(model_class) if model_class else None
    return sig is not None and sig.routes_on == "meta"


class GraphEngine:
    """One predictor's graph with its components resolved once.

    ``resolver(unit)`` supplies the implementation of every node that is
    not a built-in.  ``qos`` is an ``EngineQos`` or None; a fallback node it
    names must be in the graph and not its root.
    """

    def __init__(self, graph: Any,
                 resolver: Optional[Callable[[PredictiveUnit], Any]] = None,
                 name: str = "predictor",
                 metrics_sink: Optional[Any] = None,
                 qos: Optional[Any] = None,
                 walk_timeout_s: Optional[float] = None,
                 plan_mode: str = "walk",
                 plan_batcher: Optional[Any] = None,
                 cache: Optional[Any] = None,
                 cache_version: str = "",
                 artifacts: Optional[Any] = None,
                 device_plane: Optional[Any] = None,
                 tracer: Optional[Any] = None,
                 health: Optional[Any] = None,
                 profiler: Optional[Any] = None,
                 placement: Optional[Any] = None):
        self.name = name
        self.metrics = metrics_sink
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.spec = parse_graph(graph)
        validate_graph(self.spec)
        self._resolver = resolver
        self._nodes: dict[str, _Node] = {}
        self.root = self._build(self.spec)
        self.plan_mode = plan_mode = check_plan_mode(plan_mode)
        self.plan = None
        if plan_mode == "fused":
            from seldon_core_tpu_torch.graph.plan import compile_plan

            self.plan = compile_plan(
                self.root, batcher_config=plan_batcher,
                metrics=getattr(metrics_sink, "registry", None))
            if not self.plan.segments:
                # the plan walk would be the walk with extra indirection
                logger.warning(
                    "graph %s: plan mode requested but no segment fused "
                    "(%s); falling back to interpreted walk",
                    name, self.plan.boundaries)
                self.plan = None
            else:
                # segment batchers emit one span per batch, linked to each
                # member request's trace
                for seg in self.plan.segments:
                    if seg.batcher is not None:
                        seg.batcher.tracer = self.tracer
        # every request leaves a flight record and a burn observation; the
        # sampler starts on the first request (the loop exists by then)
        self.health = health
        # fused segments report their captures into the profiling plane's
        # ledger: wired before the artifact plane captures at boot, so
        # those land on it (as aot-cache rows)
        self.profiler = profiler
        if profiler is not None and self.plan is not None:
            for seg in self.plan.segments:
                seg.compile_watch = profiler.compile
        # the placement plane arms the sharded executor (its gates' first
        # runs land on the ledger, so after the profiling plane); before
        # the artifact plane, whose keys carry the mesh spec and whose
        # stored sharded buckets go only to a segment armed on their slice
        self.placement = placement
        if placement is not None and self.plan is not None:
            placement.attach_plan(self.plan)
        # the artifact plane captures every stored bucket of the plan's
        # segments now, before any traffic (a walk has nothing to store)
        self.artifacts = artifacts if self.plan is not None else None
        if self.artifacts is not None:
            self.artifacts.attach_plan(
                self.plan, mesh_spec=(placement.config.spec()
                                      if placement is not None else ""))
            self.artifacts.hydrate_plan(self.plan)
        self.device_plane = device_plane
        self.cache = cache
        self.cache_version = cache_version
        self._flight = None
        self._cache_roots: set[int] = set()
        if cache is not None:
            from seldon_core_tpu_torch.caching import SingleFlight

            self._flight = SingleFlight()
            if self.plan is None:
                from seldon_core_tpu_torch.caching.policy import (
                    maximal_cacheable_roots,
                )

                self._cache_roots = {
                    id(n) for n in maximal_cacheable_roots(self.root)}
        self.qos = qos
        self.walk_timeout_s = walk_timeout_s
        # the serving replica's identity (SELDON_REPLICA), stamped on root
        # spans, meta.tags["replica"] and flight records
        self.replica = os.environ.get("SELDON_REPLICA", "")
        self._fallback_node: Optional[_Node] = None
        if qos is not None and qos.config.fallback_node:
            node = self._nodes.get(qos.config.fallback_node)
            if node is None:
                raise ValueError(
                    f"qos fallback node {qos.config.fallback_node!r} not in "
                    f"graph {name!r} (GL802)")
            if node is self.root:
                raise ValueError(
                    f"qos fallback node {qos.config.fallback_node!r} is the "
                    f"graph root of {name!r}: falling back to the primary "
                    "is not a degraded mode (GL803)")
            self._fallback_node = node

    def _build(self, unit: PredictiveUnit) -> _Node:
        if unit.implementation:
            impl = ComponentHandle(
                make_builtin(unit.implementation, unit.parameters),
                name=unit.name, service_type=unit.resolved_type)
        elif self._resolver is not None:
            impl = self._resolver(unit)
        else:
            raise SeldonComponentError(
                f"no implementation for node {unit.name!r} and no resolver",
                status_code=500)
        node = _Node(unit, impl, [self._build(c) for c in unit.children])
        self._nodes[unit.name] = node
        return node

    def node_impl(self, name: str) -> Any:
        return self._nodes[name].impl

    # ------------------------------------------------------------------
    async def predict(self, request: SeldonMessage) -> SeldonMessage:
        """Assign a puid, bind the trace, apply QoS (budget, admission,
        degraded routing), walk the graph, stamp the merged meta on the
        response; every exit leaves a flight record (health plane on)."""
        meta = request.meta.copy()
        if not meta.puid:
            meta.puid = new_puid()
        health = self.health
        ht0 = time.perf_counter()
        htoken = None
        if health is not None:
            health.ensure_started()
            htoken = node_times_scope()
        ptoken = None
        if self.profiler is not None:
            self.profiler.ensure_started()
            ptoken = attribution_scope()
        # the message's tags (a framed hop) win over the context the
        # server bound from traceparent; else a new context whose trace id
        # is the puid, so walk and fused runs of one request share it
        tctx = trace_from_meta(request.meta) or current_trace()
        if tctx is None and self.tracer.enabled:
            tctx = self.tracer.new_context(trace_hint=meta.puid)
        if tctx is not None:
            stamp_trace_meta(request.meta, tctx)
            stamp_trace_meta(meta, tctx)
        if self.replica:
            meta.tags["replica"] = self.replica
        if self.artifacts is not None:
            meta.tags["artifact-source"] = self.artifacts.source_tag()
        if self._plane_on():
            meta.tags["device-plane"] = "on"
        # the message's tags win over the ambient context; restamped on the
        # request so remote hops see the remaining budget (the response's
        # meta was copied above: a client that sent no tags gets none back)
        qctx = qos_from_meta(request.meta) or current_qos()
        if qctx is not None:
            stamp_meta(request.meta, qctx)
            if qctx.deadline is not None and qctx.deadline.expired:
                return self._flight_done(SeldonMessage(
                    status=Status.failure(
                        504, "deadline budget exhausted before the graph "
                        "walk started", "DEADLINE_EXCEEDED"), meta=meta),
                    meta, ht0, htoken, ptoken=ptoken)
        admission = self.qos.admission if self.qos is not None else None
        if admission is not None:
            pri = qctx.priority if qctx is not None else "normal"
            if not admission.try_acquire(pri):
                retry_s = admission.retry_after_s()
                shed = AdmissionShedError(
                    f"shed at admission (priority {pri}, concurrency limit "
                    f"{admission.limit}); retry after {retry_s:.1f}s",
                    retry_s)
                if self.tracer.enabled:
                    # a shed request still gets a (tiny) trace, its root
                    # span carrying the reason; the error status keeps it
                    # through tail sampling
                    with trace_scope(tctx), self.tracer.trace(
                            meta.puid, graph=self.name,
                            **self._replica_attr()) as root:
                        root.status = f"ERROR: {shed.reason}"
                        root.add_event("shed", reason=shed.reason,
                                       priority=pri, limit=admission.limit)
                return self._flight_done(SeldonMessage(
                    status=Status.failure(shed.status_code, str(shed),
                                          shed.reason), meta=meta),
                    meta, ht0, htoken, shed=True, ptoken=ptoken)
        t0 = time.perf_counter()
        ok = False
        try:
            with trace_scope(tctx), qos_scope(qctx):
                out = await self._predict_qos(request, meta, qctx)
            ok = out.status is None or out.status.status == "SUCCESS"
        finally:
            if admission is not None:
                admission.release(time.perf_counter() - t0, ok)
        return self._flight_done(out, meta, ht0, htoken, ptoken=ptoken)

    def _replica_attr(self) -> dict:
        return {"replica": self.replica} if self.replica else {}

    async def _predict_qos(self, request: SeldonMessage, meta: Meta,
                           qctx: Optional[Any]) -> SeldonMessage:
        """The walk of an admitted request under its root span, bounded by
        the tighter of ``walk_timeout_s`` and the request's remaining
        budget."""
        timeout_s = self.walk_timeout_s or None
        if qctx is not None and qctx.deadline is not None:
            rem = qctx.deadline.remaining_s()
            timeout_s = rem if timeout_s is None else min(timeout_s, rem)
        degrade = (self.qos.should_degrade()
                   if self._fallback_node is not None else None)
        try:
            with self.tracer.trace(meta.puid, graph=self.name,
                                   **self._replica_attr()) as root_sp:
                if degrade is not None:
                    # the primary is sick (a breaker is open) or shedding
                    # past the configured level: the fallback subtree serves
                    meta.tags[DEGRADED_TAG] = degrade
                    if self.tracer.enabled:
                        root_sp.add_event("degraded", reason=degrade)
                    reg = getattr(self.metrics, "registry", None)
                    if reg is not None:
                        reg.counter_inc("seldon_qos_degraded_total",
                                        {"graph": self.name,
                                         "reason": degrade})
                    coro = self._walk(self._fallback_node, request, meta)
                elif self.plan is not None:
                    coro = self._plan_walk(self.plan.root, request, meta)
                else:
                    coro = self._walk(self.root, request, meta)
                if timeout_s is None:
                    out = await coro
                else:
                    out, timed_out = await self._await_with_deadline(
                        coro, timeout_s)
                    if timed_out:
                        if self.tracer.enabled:
                            root_sp.status = "ERROR: DEADLINE_EXCEEDED"
                            root_sp.add_event("shed",
                                              reason="DEADLINE_EXCEEDED",
                                              timeout_s=timeout_s)
                        return SeldonMessage(status=Status.failure(
                            504, f"graph walk exceeded {timeout_s:.3f}s "
                            "deadline", "DEADLINE_EXCEEDED"), meta=meta)
        except SeldonComponentError as e:
            return SeldonMessage(
                status=Status.failure(e.status_code, str(e), e.reason),
                meta=meta)
        except Exception as e:
            logger.exception("predict failed in graph %s", self.name)
            return SeldonMessage(
                status=Status.failure(500, f"{type(e).__name__}: {e}",
                                      "INTERNAL"),
                meta=meta)
        if out is request:
            # a pass-through graph: leave the caller's request untouched
            out = SeldonMessage(data=out.data, names=list(out.names),
                                bin_data=out.bin_data, str_data=out.str_data,
                                json_data=out.json_data,
                                encoding=out.encoding)
        out.meta = meta
        if out.status is None:
            out.status = Status()
        return out

    @staticmethod
    async def _await_with_deadline(coro, timeout_s: float) -> tuple:
        """``(result, timed_out)``: only the walk's own deadline counts as
        timed out; a ``TimeoutError`` raised inside a component is that
        component's error (500)."""
        cm = asyncio.timeout(timeout_s)
        try:
            async with cm:
                return await coro, False
        except TimeoutError:
            if not cm.expired():
                raise
            return None, True

    async def _walk(self, node: _Node, msg: SeldonMessage,
                    meta: Meta) -> SeldonMessage:
        """Maximal cacheable subtree roots take the memoised path; every
        other node, and every node below a cache root on its cold
        computation, runs the plain per-node walk."""
        if (self.cache is not None and id(node) in self._cache_roots
                and msg.data is not None):
            return await self._walk_cached(node, msg, meta)
        return await self._walk_node(node, msg, meta)

    async def _walk_node(self, node: _Node, msg: SeldonMessage,
                         meta: Meta) -> SeldonMessage:
        unit, impl = node.unit, node.impl
        meta.request_path[unit.name] = unit.implementation or type(
            getattr(impl, "user", impl)).__name__
        with self.tracer.span(unit.name, kind=node.type):
            return await self._walk_traced(node, msg, meta)

    async def _walk_traced(self, node: _Node, msg: SeldonMessage,
                           meta: Meta, child_walks: Optional[list] = None
                           ) -> SeldonMessage:
        """One node after its stamp.  ``child_walks`` (coroutine factories
        aligned with ``node.children``) lets the plan walk descend into
        plan nodes below an interpreter boundary."""
        unit, impl = node.unit, node.impl
        if child_walks is None:
            child_walks = [(lambda m, _c=c: self._walk(_c, m, meta))
                           for c in node.children]

        # 1. transformInput: MODEL.predict / TRANSFORMER.transform_input
        t0 = time.perf_counter()
        try:
            if node.type == "MODEL":
                transformed = await _maybe_await(impl.predict(msg))
            elif node.type == "TRANSFORMER":
                transformed = await _maybe_await(impl.transform_input(msg))
            elif node.type == "OUTPUT_TRANSFORMER" and not node.children:
                # a leaf OUTPUT_TRANSFORMER applies here or never
                transformed = await _maybe_await(impl.transform_output(msg))
            else:
                transformed = msg
        except BaseException:
            self._observe(unit.name, time.perf_counter() - t0, "error")
            raise
        if transformed is not msg:
            self._merge_meta(meta, transformed, unit.name,
                             time.perf_counter() - t0)
        else:
            self._observe(unit.name, time.perf_counter() - t0)

        # 2. a leaf returns
        if not node.children:
            return transformed

        # 3. route (ROUTER only); -1 means every child
        selected = child_walks
        if node.type == "ROUTER":
            route_msg = transformed
            if node.meta_only_route and self._plane_on() \
                    and transformed.data is not None:
                # the decision reads no values: route on a message
                # without the tensor, so nothing is copied from the card
                if transformed.is_device_resident:
                    self.device_plane.note_avoided(
                        "d2h", int(transformed.nbytes or 0))
                route_msg = SeldonMessage(names=list(transformed.names),
                                          meta=transformed.meta)
            branch = int(await _maybe_await(impl.route(route_msg)))
            meta.routing[unit.name] = branch
            if branch >= 0:
                if branch >= len(node.children):
                    raise SeldonComponentError(
                        f"router {unit.name} chose branch {branch} of "
                        f"{len(node.children)}",
                        status_code=500, reason="ROUTING_ERROR")
                selected = [child_walks[branch]]

        # 4. the children, concurrently
        if len(selected) == 1:
            child_outputs = [await selected[0](transformed)]
        else:
            # fail-fast on the first child error, as the reference's walk;
            # siblings are cancelled by the walk deadline
            child_outputs = list(
                await asyncio.gather(  # graphlint: disable=RL605
                    *(w(transformed) for w in selected)))

        # 5. aggregate: a COMBINER's, else the first child's output
        if node.type == "COMBINER":
            t0 = time.perf_counter()
            try:
                merged = await _maybe_await(impl.aggregate(child_outputs))
            except BaseException:
                self._observe(unit.name, time.perf_counter() - t0, "error")
                raise
            self._merge_meta(meta, merged, unit.name,
                             time.perf_counter() - t0)
        else:
            merged = child_outputs[0]

        # 6. transformOutput (OUTPUT_TRANSFORMER)
        if node.type == "OUTPUT_TRANSFORMER":
            t0 = time.perf_counter()
            try:
                new = await _maybe_await(impl.transform_output(merged))
            except BaseException:
                self._observe(unit.name, time.perf_counter() - t0, "error")
                raise
            if new is not merged:
                self._merge_meta(meta, new, unit.name,
                                 time.perf_counter() - t0)
            merged = new
        return merged

    def _merge_meta(self, meta: Meta, out: SeldonMessage, node_name: str,
                    elapsed: float) -> None:
        """Merge a component's fresh response meta into the walk's meta
        (never pass the request itself: its meta was copied at entry) and
        its custom metrics into the sink."""
        if out is None:
            return
        meta.merge(out.meta)
        if self.metrics is not None and out.meta.metrics:
            self.metrics.merge_custom(node_name, out.meta.metrics)
        out.meta = Meta()  # consumed
        self._observe(node_name, elapsed)

    def _observe(self, node_name: str, elapsed: float,
                 status: str = "ok") -> None:
        # the request's node times for its flight record (a no-op without
        # the health plane's scope)
        note_node_time(node_name, elapsed * 1000.0)
        if self.metrics is not None:
            self.metrics.observe_node(self.name, node_name, elapsed,
                                      status=status)

    def _flight_done(self, out: SeldonMessage, meta: Meta, ht0: float,
                     htoken, shed: bool = False,
                     ptoken=None) -> SeldonMessage:
        """Every exit of :meth:`predict` ends here: the request's
        attributed cost (profiling plane), one flight record and one
        burn-monitor observation (health plane), sheds and failures
        included.  Never raises."""
        cost = None
        if ptoken is not None:
            try:
                cost = ptoken.close()
                if self.profiler is not None and cost["flops"] > 0:
                    self.profiler.attribution.note_request(cost["flops"])
            except Exception:
                cost = None
        health = self.health
        if health is None:
            return out
        try:
            node_ms = htoken.close() if htoken is not None else {}
            elapsed_ms = (time.perf_counter() - ht0) * 1000.0
            status = out.status
            code = 200 if status is None else int(status.code or 200)
            reason = "" if status is None else status.reason
            flags = {
                "shed": shed or reason == "ADMISSION_SHED",
                "degraded": meta.tags.get(DEGRADED_TAG, False),
                "mode": "fused" if self.plan is not None else "walk",
            }
            if self.placement is not None:
                # the topology that served the request
                flags["mesh"] = self.placement.mesh_shape()
            if self.artifacts is not None:
                flags["artifactSource"] = self.artifacts.source_tag()
            if meta.routing:
                flags["routing"] = dict(meta.routing)
            if cost is not None and cost["flops"] > 0:
                # the bucket's counted cost x this request's batch share
                flags["flops"] = round(cost["flops"], 3)
                flags["hbmBytes"] = round(cost["hbmBytes"], 3)
                flags["segmentFlops"] = {
                    k: round(v, 3) for k, v in cost["segments"].items()}
            health.recorder.record(
                puid=meta.puid,
                trace_id=str(meta.tags.get(TRACE_ID_TAG, "")),
                deployment=health.deployment or self.name,
                route=tuple(meta.request_path),
                node_ms=node_ms,
                status=code,
                reason=reason,
                duration_ms=elapsed_ms,
                flags=flags,
                replica=self.replica,
            )
            health.note_request(elapsed_ms, code)
        except Exception:
            logger.exception("flight recording failed in graph %s",
                             self.name)
        return out

    # ------------------------------------------------------------------
    # prediction cache (walk mode): maximal-subtree memoisation
    # ------------------------------------------------------------------
    async def _walk_cached(self, node: _Node, msg: SeldonMessage,
                           meta: Meta) -> SeldonMessage:
        """Serve one maximal cacheable subtree from the cache.

        An entry is ``(data, names, delta)``, ``delta`` being the Meta the
        subtree's cold walk produced (requestPath stamps in walk order,
        component tags, custom metrics), replayed into each caller's meta
        so hit and coalesced responses are byte-identical to the cold path
        (per-request meta aside).  A payload that cannot be keyed (an
        object array) takes the cold path, counted as a bypass.
        """
        from seldon_core_tpu_torch.caching.key import message_key

        name = node.unit.name
        key = message_key(msg, node=name, graph=self.name,
                          version=self.cache_version)
        if key is None:
            self.cache.note_bypass()
            return await self._walk_node(node, msg, meta)
        t0 = time.perf_counter()
        entry = self.cache.get(key)
        if entry is not None:
            with self.tracer.span(name, kind="CACHE_HIT"):
                out = self._replay_entry(entry, meta, node)
            self._observe(name, time.perf_counter() - t0)
            return out

        async def compute():
            sub = Meta()
            cold = await self._walk_node(node, msg, sub)
            data = self._promote_device(cold.data)
            e = (data, list(cold.names), sub)
            self.cache.put(key, e, _entry_nbytes(data, cold.names, sub))
            return e

        entry, coalesced = await self._flight.run(key, compute)
        if coalesced:
            self.cache.note_coalesced()
            with self.tracer.span(name, kind="CACHE_COALESCED"):
                out = self._replay_entry(entry, meta, node)
        else:
            out = self._replay_entry(entry, meta, node)
        self._observe(name, time.perf_counter() - t0)
        return out

    def _plane_on(self) -> bool:
        return self.device_plane is not None and self.device_plane.enabled

    def _promote_device(self, data: Any) -> Any:
        """With the device plane on, a cache entry computed on the host is
        kept on the card, so every hit hands out a CUDA tensor.  Torch
        keeps the dtype (a float64 array stays float64), so the entry is
        never a downcast copy; an array torch cannot hold stays on the
        host.  Without a card there is nowhere to promote to."""
        if not self._plane_on() or not isinstance(data, np.ndarray):
            return data
        from seldon_core_tpu_torch.runtime.device_registry import registry

        dev = registry.resolve_device()
        if dev.type != "cuda":
            return data
        try:
            t = torch.from_numpy(np.ascontiguousarray(data))
        except TypeError:  # object, string or other non-numeric arrays
            return data
        return t.to(dev)

    def _replay_entry(self, entry: tuple, meta: Meta,
                      node: _Node) -> SeldonMessage:
        """A cache entry as this request's response fragment: the stored
        delta is copied before merging, and below the root the payload is
        copied too (tensors are mutable: a parent component changing its
        input in place must never reach the shared entry)."""
        data, names, delta = entry
        meta.merge(delta.copy())
        if node is not self.root:
            data = _private(data)
        return SeldonMessage(data=data, names=list(names))

    # ------------------------------------------------------------------
    # plan mode: walk the segment DAG instead of the node tree
    # ------------------------------------------------------------------
    async def _plan_walk(self, pnode: Any, msg: SeldonMessage,
                         meta: Meta) -> SeldonMessage:
        """One node of the plan walk (``graph/plan.py`` PlanNode): fused
        segments run as one call; interpreter boundaries run the standard
        per-node path but descend into plan children."""
        if pnode.segment is not None:
            if msg.data is None:
                # segments are tensor-in/tensor-out; binData/strData/
                # jsonData requests walk the nodes beneath the segment
                return await self._walk(pnode.node, msg, meta)
            out = await self._run_segment(pnode.segment, msg, meta,
                                          interior=bool(pnode.children))
            if pnode.children:
                # chain segment: the fused prefix feeds the interpreted rest
                return await self._plan_walk(pnode.children[0], out, meta)
            return out
        node = pnode.node
        unit, impl = node.unit, node.impl
        meta.request_path[unit.name] = unit.implementation or type(
            getattr(impl, "user", impl)).__name__
        walks = [(lambda m, _p=p: self._plan_walk(_p, m, meta))
                 for p in pnode.children]
        with self.tracer.span(unit.name, kind=node.type):
            return await self._walk_traced(node, msg, meta,
                                           child_walks=walks)

    async def _run_segment(self, seg: Any, msg: SeldonMessage, meta: Meta,
                           interior: bool = False) -> SeldonMessage:
        """One fused segment: one call (through its batcher when it has
        one), or none when the cache holds its result for this input.
        Either way its meta script replays per request, so requestPath,
        tags and custom metrics are byte-identical to the walk's.  One
        ``observe_node`` for the whole segment."""
        t0 = time.perf_counter()
        y, names = await self._segment_result(seg, msg, interior)
        for ev in seg.meta_events:
            if ev.op == "stamp":
                meta.request_path[ev.name] = ev.label
            else:
                cm = ev.handle._component_meta()
                meta.merge(cm)
                if self.metrics is not None and cm.metrics:
                    self.metrics.merge_custom(ev.name, cm.metrics)
        self._observe(seg.label, time.perf_counter() - t0)
        return SeldonMessage(data=y, names=names)

    async def _segment_result(self, seg: Any, msg: SeldonMessage,
                              interior: bool) -> tuple:
        """``(y, names)`` for one segment input: a cache hit (no call), a
        coalesced duplicate riding the leader's call (one call and one
        batch row for the whole group), else one fresh call."""
        x = msg.data
        key = None
        if self.cache is not None and seg.cacheable:
            from seldon_core_tpu_torch.caching.key import array_key

            key = array_key(x, msg.names, node=seg.label, graph=self.name,
                            version=self.cache_version)
            if key is None:
                self.cache.note_bypass()
        if key is None:
            return await self._dispatch_segment(seg, x, msg.names)
        entry = self.cache.get(key)
        if entry is not None:
            with self.tracer.span(seg.label, kind="CACHE_HIT"):
                pass
            return self._segment_entry(entry, interior)

        async def compute():
            y, names = await self._dispatch_segment(seg, x, msg.names)
            e = (self._promote_device(y), names)
            self.cache.put(key, e, _entry_nbytes(e[0], e[1]))
            return e

        entry, coalesced = await self._flight.run(key, compute)
        if coalesced:
            self.cache.note_coalesced()
            with self.tracer.span(seg.label, kind="CACHE_COALESCED"):
                pass
        return self._segment_entry(entry, interior)

    async def _dispatch_segment(self, seg: Any, x: Any, in_names) -> tuple:
        """One segment call (through its batcher when it has one), under
        a ``FUSED_SEGMENT`` span and a profiler range.  A traced request
        waits on a CUDA event recorded after the call: the wait is the
        span's ``device_block_ms`` (an untraced request never waits).  With
        the profiling plane on, this request's share of the bucket's
        counted cost is attributed to it."""
        traced = self.tracer.enabled
        with self.tracer.span(seg.label, kind="FUSED_SEGMENT") as sp:
            calls_before = seg.n_calls
            t0 = time.perf_counter()
            with profile_annotation(f"seldon.segment.{seg.label}"):
                if seg.batcher is not None:
                    y, _ = await seg.batcher(x)
                else:
                    y = seg(x)
            t_dispatch = time.perf_counter() - t0
            if traced:
                t1 = time.perf_counter()
                if isinstance(y, torch.Tensor) and y.is_cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(y.device))
                    done.synchronize()
                sp.attributes.update(
                    host_dispatch_ms=round(t_dispatch * 1e3, 4),
                    device_block_ms=round(
                        (time.perf_counter() - t1) * 1e3, 4),
                    dispatch_count=seg.n_calls,
                    compile_cache_hit=calls_before > 0,
                    members=",".join(s.name for s in seg.members))
                if self.placement is not None:
                    sp.attributes.update(mesh=self.placement.mesh_shape(),
                                         sharded=seg.shard_rows > 1)
            if self.profiler is not None:
                # this request's rows x the bucket's per-row cost: the
                # shares of a coalesced batch sum to the bucket's total
                try:
                    shape = getattr(x, "shape", None)
                    rows = int(shape[0]) if shape else 1
                    est = seg.cost_for_rows(rows)
                    if est is not None:
                        self.profiler.attribution.note_dispatch(
                            seg.label, est["flops"], est["hbm_bytes"])
                except Exception:
                    logger.debug("cost attribution failed for %s",
                                 seg.label, exc_info=True)
            names = seg.out_names(x, in_names)
        return y, list(names)

    @staticmethod
    def _segment_entry(entry: tuple, interior: bool) -> tuple:
        """A chain segment feeds an interpreted (possibly mutating)
        remainder: interior consumers get a private copy of the result."""
        y, names = entry
        if interior:
            y = _private(y)
        return y, list(names)

    # ------------------------------------------------------------------
    def stream(self, request: SeldonMessage):
        """The async generator of events of a STREAMING graph: its root is
        a single node with ``stream`` (an LLM MODEL).  Streaming through
        routers, combiners or transformers has no defined composition, so
        any other graph raises a 501 ``STREAM_UNSUPPORTED`` error, before
        any event."""
        impl = self.root.impl
        fn = getattr(impl, "stream", None)
        has = getattr(impl, "has", None)
        declared = (not callable(has)) or has("stream")
        if not callable(fn) or self.root.children or not declared:
            raise SeldonComponentError(
                f"graph {self.name!r} is not streamable (root must be a "
                "single streaming node)",
                status_code=501, reason="STREAM_UNSUPPORTED")
        return fn(request)

    # ------------------------------------------------------------------
    async def send_feedback(self, fb: Feedback) -> SeldonMessage:
        """Reward propagation: replay ``response.meta.routing`` down the
        branch taken, children first, then credit the node."""
        try:
            await self._feedback_walk(self.root, fb)
        except SeldonComponentError as e:
            return SeldonMessage(
                status=Status.failure(e.status_code, str(e), e.reason))
        except Exception as e:
            logger.exception("send_feedback failed in graph %s", self.name)
            return SeldonMessage(status=Status.failure(
                500, f"{type(e).__name__}: {e}", "INTERNAL"))
        if self.metrics is not None:
            self.metrics.observe_feedback(self.name, fb.reward)
        return SeldonMessage(status=Status())

    async def _feedback_walk(self, node: _Node, fb: Feedback) -> None:
        routing = -1
        if fb.response is not None:
            routing = fb.response.meta.routing.get(node.unit.name, -1)
        if node.children:
            if 0 <= routing < len(node.children):
                targets = [node.children[routing]]
            else:
                targets = node.children
            # every branch gets its feedback before a failure propagates
            results = await asyncio.gather(
                *(self._feedback_walk(c, fb) for c in targets),
                return_exceptions=True)
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        has = getattr(node.impl, "has", None)
        if has is not None:
            deliver = has("send_feedback")
        else:
            deliver = callable(getattr(node.impl, "send_feedback", None))
        if deliver:
            await _maybe_await(node.impl.send_feedback(fb))

    # ------------------------------------------------------------------
    # sync calls, for tools and tests
    # ------------------------------------------------------------------
    def predict_sync(self, request: SeldonMessage) -> SeldonMessage:
        return _run_sync(self.predict(request))

    def send_feedback_sync(self, fb: Feedback) -> SeldonMessage:
        return _run_sync(self.send_feedback(fb))


def _run_sync(coro):
    """``coro``'s result on a loop of its own; refused (and closed) when
    the caller is inside a running loop, whose thread it would block."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    coro.close()
    raise RuntimeError(
        "predict_sync called from within an event loop; use await")


def _private(data: Any) -> Any:
    """A copy of a payload shared through the cache."""
    if isinstance(data, np.ndarray):
        return data.copy()
    if isinstance(data, torch.Tensor):
        return data.clone()
    return data


def _entry_nbytes(data: Any, names, delta: Optional[Meta] = None) -> int:
    """Byte cost of one cache entry for the store's budget (the
    reference's charge: the payload's bytes, names, a flat overhead per
    meta item)."""
    n = int(getattr(data, "nbytes", 0) or 0) + 64
    n += sum(len(str(x)) + 8 for x in names or ())
    if delta is not None:
        n += 64 * (len(delta.request_path) + len(delta.tags)
                   + len(delta.metrics))
    return n
