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

Not in this slice: the prediction cache, QoS, fused plans, the health,
profiling, placement, artifact and device planes, and the tracer
(ROADMAP.md, slices 4 and 5).  A remote node (``serving.client.
RemoteComponent``) has the same method surface as a local one, async.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from typing import Any, Callable, Optional

from seldon_core_tpu_torch.graph.builtins import make_builtin
from seldon_core_tpu_torch.graph.spec import (
    PredictiveUnit,
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
from seldon_core_tpu_torch.runtime.component import (
    ComponentHandle,
    SeldonComponentError,
)

__all__ = ["GraphEngine"]

logger = logging.getLogger(__name__)


async def _maybe_await(x: Any) -> Any:
    """Components may be sync (ComponentHandle) or async (BatchedModel,
    LLMComponent) with the same method surface."""
    if inspect.isawaitable(x):
        return await x
    return x


class _Node:
    __slots__ = ("unit", "impl", "children", "type")

    def __init__(self, unit: PredictiveUnit, impl: Any,
                 children: list["_Node"]):
        self.unit = unit
        self.impl = impl
        self.children = children
        self.type = unit.resolved_type


class GraphEngine:
    """One predictor's graph with its components resolved once.

    ``resolver(unit)`` supplies the implementation of every node that is
    not a built-in.
    """

    def __init__(self, graph: Any,
                 resolver: Optional[Callable[[PredictiveUnit], Any]] = None,
                 name: str = "predictor",
                 metrics_sink: Optional[Any] = None):
        self.name = name
        self.metrics = metrics_sink
        self.spec = parse_graph(graph)
        validate_graph(self.spec)
        self._resolver = resolver
        self._nodes: dict[str, _Node] = {}
        self.root = self._build(self.spec)

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
        """Assign a puid, walk the graph, stamp the merged meta on the
        response."""
        meta = request.meta.copy()
        if not meta.puid:
            meta.puid = new_puid()
        try:
            out = await self._walk(self.root, request, meta)
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

    async def _walk(self, node: _Node, msg: SeldonMessage,
                    meta: Meta) -> SeldonMessage:
        unit, impl = node.unit, node.impl
        meta.request_path[unit.name] = unit.implementation or type(
            getattr(impl, "user", impl)).__name__

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
        selected = node.children
        if node.type == "ROUTER":
            branch = int(await _maybe_await(impl.route(transformed)))
            meta.routing[unit.name] = branch
            if branch >= 0:
                if branch >= len(node.children):
                    raise SeldonComponentError(
                        f"router {unit.name} chose branch {branch} of "
                        f"{len(node.children)}",
                        status_code=500, reason="ROUTING_ERROR")
                selected = [node.children[branch]]

        # 4. the children, concurrently
        if len(selected) == 1:
            child_outputs = [await self._walk(selected[0], transformed, meta)]
        else:
            child_outputs = list(await asyncio.gather(
                *(self._walk(c, transformed, meta) for c in selected)))

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
        if self.metrics is not None:
            self.metrics.observe_node(self.name, node_name, elapsed,
                                      status=status)

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
