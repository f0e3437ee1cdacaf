"""Distributed trace spans, W3C context propagation and device-trace
windows (port of ``seldon_core_tpu/utils/tracing.py``).

- :class:`Tracer` records a span tree per request (graph-node enter/exit
  with wall time and attributes), keyed by puid, kept in a bounded ring;
- spans nest via contextvars, so the async graph walk's concurrent child
  fan-out attributes children to the right parent without explicit plumbing;
- :class:`TraceContext` carries 128-bit trace IDs / 64-bit span IDs across
  process hops via W3C ``traceparent``/``tracestate`` headers (REST hops),
  and via ``meta.tags`` on the framed transport;
- :class:`SpanCollector` applies head sampling (``seldon.io/trace-sample``)
  with a tail buffer that always keeps error and slow-outlier traces, and
  exports OTLP-shaped JSON lines through a rotating :class:`FileSpanSink`;
- :func:`device_profile` (alias :func:`xla_profile`, the reference's name)
  runs ``torch.profiler`` over CPU and CUDA activity around any serving
  window and writes a Chrome trace into its ``logdir`` at close;
  :func:`profile_annotation` opens ``torch.profiler.record_function`` and
  an NVTX range inside an open window, so device timelines line up with
  spans;
- export: JSON dict per trace (the ``/trace`` engine endpoint);
- the LLM engines' records (:class:`JobRecord`, :class:`RequestRecord`):
  one per device job and one per request, always on, in two bounded
  process-wide rings (:func:`job_records`, :func:`request_records`), stamped
  on ``time.perf_counter()``; :func:`add_request_spans` makes a request's
  spans from its record.

One clock: spans, span events and records read ``time.perf_counter``;
span stamps are its nanoseconds plus :data:`EPOCH_OFFSET_NS`, taken once
per process, so they read as Unix-epoch nanoseconds (what OTLP and
``/trace`` export, and what ``torch.profiler``'s events are stamped in)
and :func:`epoch_ns` maps a record's time onto them.  On Linux
``perf_counter`` is ``CLOCK_MONOTONIC``, which NTP slews at the wall
clock's rate, so the offset holds until the wall clock is stepped (by
hand, by a time daemon's step, at a leap second); after a step
the exported stamps are off from other processes' by the step, until the
process restarts.

Trace IDs derive from the puid exactly as the reference derives them
(:meth:`Tracer.new_context`), so one puid names one trace in both packages.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import random
import secrets
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "Span",
    "Tracer",
    "xla_profile",
    "device_profile",
    "profiler_active",
    "warm_device_profile",
    "profile_annotation",
    "all_threads_config",
    "NULL_TRACER",
    "TraceContext",
    "current_trace",
    "current_span",
    "trace_scope",
    "trace_from_headers",
    "trace_from_meta",
    "stamp_trace_meta",
    "trace_headers",
    "parse_traceparent",
    "format_traceparent",
    "new_trace_id",
    "new_span_id",
    "SpanCollector",
    "FileSpanSink",
    "TraceConfig",
    "trace_config_from_annotations",
    "otlp_trace",
    "TRACEPARENT_HEADER",
    "TRACESTATE_HEADER",
    "TRACE_ID_TAG",
    "TRACE_FLAGS_TAG",
    "TRACE_STATE_TAG",
    "TRACE_PARENT_TAG",
    "SAMPLE_ANNOTATION",
    "EXPORT_ANNOTATION",
    "SLOW_MS_ANNOTATION",
    "TRACING_ANNOTATION",
    "TRACING_MAX_ANNOTATION",
    "EPOCH_OFFSET_NS",
    "now_ns",
    "epoch_ns",
    "JobRecord",
    "RequestRecord",
    "RecordRing",
    "JOBS",
    "REQUESTS",
    "job_records",
    "request_records",
    "add_request_spans",
]

# -- wire / tag channel names ------------------------------------------------
TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"
# Only the trace-id (and flags/state, both deterministic per request) ride
# meta.tags: span IDs differ between walk and fused-plan executions of the
# same request, so stamping them into the payload would break response
# parity between the two modes.  The full traceparent (TRACE_PARENT_TAG) is
# injected only into transport-side copies by the framed clients.
TRACE_ID_TAG = "trace-id"
TRACE_FLAGS_TAG = "trace-flags"
TRACE_STATE_TAG = "trace-state"
TRACE_PARENT_TAG = "trace-parent"

# -- annotations (validated at admission + graphlint GL9xx) ------------------
TRACING_ANNOTATION = "seldon.io/tracing"
TRACING_MAX_ANNOTATION = "seldon.io/tracing-max"
SAMPLE_ANNOTATION = "seldon.io/trace-sample"
EXPORT_ANNOTATION = "seldon.io/trace-export"
SLOW_MS_ANNOTATION = "seldon.io/trace-slow-ms"

_HEX = set("0123456789abcdef")


def new_trace_id() -> str:
    """128-bit trace ID, lowercase hex (same material as ``new_puid``)."""
    return secrets.token_hex(16)


def new_span_id() -> str:
    """64-bit span ID, lowercase hex."""
    return secrets.token_hex(8)


def _is_hex(s: object, n: int) -> bool:
    return (
        isinstance(s, str)
        and len(s) == n
        and set(s) <= _HEX
        and set(s) != {"0"}
    )


@dataclass(frozen=True)
class TraceContext:
    """Immutable ambient trace context (the W3C trace-context triple plus
    ``tracestate``).  ``span_id`` names the currently-active span — the one
    a downstream hop should use as its parent; empty means "trace exists
    but no span is open yet" (a freshly-minted context)."""

    trace_id: str
    span_id: str = ""
    sampled: bool = True
    state: tuple = ()  # ordered (key, value) pairs, W3C tracestate

    def child(self, span_id: str) -> "TraceContext":
        """Same trace, new active span (what a just-opened span publishes
        so its downstream hops parent correctly)."""
        return TraceContext(self.trace_id, span_id, self.sampled, self.state)

    def with_state(self, key: str, value: str) -> "TraceContext":
        """Prepend/replace a tracestate entry (W3C: mutators move their key
        to the front)."""
        rest = tuple((k, v) for k, v in self.state if k != key)
        return TraceContext(
            self.trace_id, self.span_id, self.sampled,
            ((key, value),) + rest,
        )

    def state_get(self, key: str) -> Optional[str]:
        for k, v in self.state:
            if k == key:
                return v
        return None


def format_traceparent(ctx: TraceContext) -> str:
    span = ctx.span_id if _is_hex(ctx.span_id, 16) else new_span_id()
    return "00-{}-{}-{}".format(
        ctx.trace_id, span, "01" if ctx.sampled else "00"
    )


def parse_traceparent(value: str) -> Optional[TraceContext]:
    """Strict W3C parse; returns None (caller mints fresh) on any defect."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or set(version) - _HEX or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if not _is_hex(trace_id, 32) or not _is_hex(span_id, 16):
        return None
    if len(flags) != 2 or set(flags) - _HEX:
        return None
    sampled = bool(int(flags, 16) & 0x01)
    return TraceContext(trace_id, span_id, sampled)


def _parse_tracestate(value: str) -> tuple:
    entries = []
    for item in value.split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        k, _, v = item.partition("=")
        if k and v:
            entries.append((k.strip(), v.strip()))
        if len(entries) >= 32:  # W3C cap
            break
    return tuple(entries)


def _format_tracestate(state: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in state)


# -- ambient context (mirrors qos/context.py) --------------------------------
_current_ctx: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("seldon-trace-ctx", default=None)
)


def current_trace() -> Optional[TraceContext]:
    return _current_ctx.get()


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Bind a trace context for the duration of a request.  ``None`` passes
    through (no-op), so callers can bind unconditionally."""
    if ctx is None:
        yield
        return
    token = _current_ctx.set(ctx)
    try:
        yield
    finally:
        _current_ctx.reset(token)


def trace_from_headers(headers) -> Optional[TraceContext]:
    """Parse inbound W3C headers; None when absent or malformed."""
    try:
        raw = headers.get(TRACEPARENT_HEADER) or headers.get("Traceparent")
    except AttributeError:
        return None
    if not raw:
        return None
    ctx = parse_traceparent(raw)
    if ctx is None:
        return None
    state_raw = headers.get(TRACESTATE_HEADER) or headers.get("Tracestate")
    if state_raw:
        ctx = TraceContext(
            ctx.trace_id, ctx.span_id, ctx.sampled, _parse_tracestate(state_raw)
        )
    return ctx


def trace_headers(ctx: Optional[TraceContext]) -> dict:
    """Headers to stamp on a downstream hop."""
    if ctx is None:
        return {}
    h = {TRACEPARENT_HEADER: format_traceparent(ctx)}
    if ctx.state:
        h[TRACESTATE_HEADER] = _format_tracestate(ctx.state)
    return h


def trace_from_meta(meta) -> Optional[TraceContext]:
    """Recover context from ``meta.tags`` (framed transport / payload
    channel).  Prefers the full ``trace-parent`` stamped by framed clients;
    falls back to the parity-safe ``trace-id`` tag."""
    tags = getattr(meta, "tags", None)
    if not isinstance(tags, dict):
        return None
    full = tags.get(TRACE_PARENT_TAG)
    if full:
        ctx = parse_traceparent(full)
        if ctx is not None:
            state = tags.get(TRACE_STATE_TAG)
            if isinstance(state, str) and state:
                ctx = TraceContext(ctx.trace_id, ctx.span_id, ctx.sampled,
                                   _parse_tracestate(state))
            return ctx
    tid = tags.get(TRACE_ID_TAG)
    if not _is_hex(tid, 32):
        return None
    sampled = str(tags.get(TRACE_FLAGS_TAG, "01")) != "00"
    state_raw = tags.get(TRACE_STATE_TAG)
    state = (_parse_tracestate(state_raw)
             if isinstance(state_raw, str) and state_raw else ())
    return TraceContext(tid, "", sampled, state)


def stamp_trace_meta(meta, ctx: Optional[TraceContext]) -> None:
    """Stamp the parity-safe subset (trace-id / flags / state — everything
    deterministic for a given request) onto ``meta.tags`` so walk and
    fused-plan executions emit identical payloads."""
    if ctx is None or not hasattr(meta, "tags"):
        return
    meta.tags[TRACE_ID_TAG] = ctx.trace_id
    meta.tags[TRACE_FLAGS_TAG] = "01" if ctx.sampled else "00"
    if ctx.state:
        meta.tags[TRACE_STATE_TAG] = _format_tracestate(ctx.state)


# -- the one clock ------------------------------------------------------------
def _epoch_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of a
    few paired reads."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


#: added to ``time.perf_counter_ns()`` it gives Unix-epoch nanoseconds;
#: taken once, when this module is imported
EPOCH_OFFSET_NS = _epoch_offset_ns()


def now_ns() -> int:
    """Now, in the spans' nanoseconds (Unix epoch, from the monotonic
    ``perf_counter``)."""
    return time.perf_counter_ns() + EPOCH_OFFSET_NS


def epoch_ns(t: float) -> int:
    """A ``time.perf_counter()`` reading in the spans' nanoseconds, which
    are also ``torch.profiler``'s event stamps."""
    return round(t * 1e9) + EPOCH_OFFSET_NS


# -- spans -------------------------------------------------------------------
@dataclass
class Span:
    name: str
    kind: str = ""
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    status: str = "OK"
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    links: list[dict] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def add_event(self, name: str, **attributes) -> None:
        self.events.append({
            "name": name,
            "time_ns": now_ns(),
            "attributes": dict(attributes),
        })

    def add_link(self, trace_id: str, span_id: str, **attributes) -> None:
        self.links.append({
            "trace_id": trace_id,
            "span_id": span_id,
            "attributes": dict(attributes),
        })

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "kind": self.kind,
            "start_ns": self.start_ns,
            "duration_ms": self.duration_ms,
            "status": self.status,
            "attributes": dict(self.attributes),
            "children": [c.to_dict() for c in self.children],
        }
        if self.trace_id:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
            if self.parent_span_id:
                d["parent_span_id"] = self.parent_span_id
        if self.links:
            d["links"] = [dict(link) for link in self.links]
        if self.events:
            d["events"] = [dict(ev) for ev in self.events]
        return d


_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "seldon_current_span", default=None
)


def current_span() -> Optional[Span]:
    """The innermost open span in this context (None outside any span)."""
    sp = _current_span.get()
    return None if sp is _DUMMY else sp


# -- OTLP-shaped export ------------------------------------------------------
def _otlp_attr_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: dict) -> list:
    return [{"key": k, "value": _otlp_attr_value(v)} for k, v in attrs.items()]


def _otlp_span(sp: Span) -> dict:
    d = {
        "traceId": sp.trace_id,
        "spanId": sp.span_id,
        "name": sp.name,
        "startTimeUnixNano": str(sp.start_ns),
        "endTimeUnixNano": str(sp.end_ns),
        "attributes": _otlp_attrs({"seldon.kind": sp.kind, **sp.attributes}),
        "status": (
            {"code": 2, "message": sp.status}
            if sp.status != "OK" else {"code": 1}
        ),
    }
    if sp.parent_span_id:
        d["parentSpanId"] = sp.parent_span_id
    if sp.links:
        d["links"] = [
            {
                "traceId": link["trace_id"],
                "spanId": link["span_id"],
                "attributes": _otlp_attrs(link.get("attributes", {})),
            }
            for link in sp.links
        ]
    if sp.events:
        d["events"] = [
            {
                "name": ev["name"],
                "timeUnixNano": str(ev.get("time_ns", 0)),
                "attributes": _otlp_attrs(ev.get("attributes", {})),
            }
            for ev in sp.events
        ]
    return d


def _flatten(sp: Span, out: list) -> None:
    out.append(sp)
    for c in sp.children:
        _flatten(c, out)


def otlp_trace(root: Span, service: str = "seldon-core-tpu") -> dict:
    """One trace as an OTLP/JSON ``resourceSpans`` envelope (the shape an
    OTLP-HTTP collector ingests), with the span tree flattened to the flat
    span list + parentSpanId references OTLP uses."""
    spans: list[Span] = []
    _flatten(root, spans)
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _otlp_attrs({"service.name": service})
                },
                "scopeSpans": [
                    {
                        # the reference's scope name: collectors and
                        # queries keyed on it read the port's spans too
                        "scope": {"name": "seldon_core_tpu.utils.tracing"},
                        "spans": [_otlp_span(s) for s in spans],
                    }
                ],
            }
        ]
    }


class FileSpanSink:
    """Append-only JSON-lines sink with size-based rotation.

    One OTLP envelope per line; rotation renames ``path`` → ``path.1`` →
    ... → ``path.N`` and starts fresh, so the sink is bounded at roughly
    ``max_bytes * (backups + 1)`` on disk."""

    def __init__(self, path: str, max_bytes: int = 8 << 20, backups: int = 2):
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def _rotate_locked(self) -> None:
        for i in range(self.backups, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            dst = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        if self.backups == 0 and os.path.exists(self.path):
            os.remove(self.path)

    def write(self, envelope: dict) -> None:
        line = json.dumps(envelope, separators=(",", ":")) + "\n"
        with self._lock:
            try:
                if (os.path.exists(self.path)
                        and os.path.getsize(self.path) + len(line)
                        > self.max_bytes):
                    self._rotate_locked()
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
            except OSError as e:  # export must never fail a request
                logger.warning("trace sink write failed: %s", e)


def _tree_has_error(sp: Span) -> bool:
    if sp.status != "OK":
        return True
    return any(_tree_has_error(c) for c in sp.children)


class SpanCollector:
    """Head sampling + tail buffer + export.

    ``offer`` is called once per finished root span.  Head-sampled traces
    (the ingress sampling decision, carried on the context's ``sampled``
    flag) are always kept; unsampled traces are still kept when they
    errored or ran slower than ``slow_ms`` — the tail buffer that makes a
    1% head rate safe to run in production without losing the traces that
    matter."""

    def __init__(self, service: str = "seldon-core-tpu",
                 max_traces: int = 512, slow_ms: float = 250.0,
                 sink: Optional[FileSpanSink] = None):
        self.service = service
        self.slow_ms = slow_ms
        self.sink = sink
        self._lock = threading.Lock()
        self._kept: deque = deque(maxlen=max_traces)
        self.offered = 0
        self.kept_head = 0
        self.kept_tail = 0
        self.dropped = 0

    def offer(self, root: Span, sampled: bool = True,
              extra: Optional[dict] = None) -> bool:
        """Returns True when the trace was kept (head or tail)."""
        err = _tree_has_error(root)
        slow = root.duration_ms >= self.slow_ms
        if sampled:
            kept_by = "head"
        elif err:
            kept_by = "tail-error"
        elif slow:
            kept_by = "tail-slow"
        else:
            kept_by = ""
        with self._lock:
            self.offered += 1
            if not kept_by:
                self.dropped += 1
                return False
            if kept_by == "head":
                self.kept_head += 1
            else:
                self.kept_tail += 1
            rec = {
                "trace_id": root.trace_id,
                "status": "ERROR" if err else "OK",
                "duration_ms": root.duration_ms,
                "kept_by": kept_by,
                "root": root.to_dict(),
            }
            dep = root.attributes.get("deployment")
            if dep:
                rec["deployment"] = str(dep)
            rep = root.attributes.get("replica")
            if rep:
                # stable stitching key for fleet-level trace merges
                # (/admin/fleet/traces; fleet/observe.py)
                rec["replica"] = str(rep)
            if extra:
                rec.update(extra)
            self._kept.append(rec)
        if self.sink is not None:
            self.sink.write(otlp_trace(root, self.service))
        return True

    @staticmethod
    def _span_has_attr(d: dict, key: str, value: str) -> bool:
        if str(d.get("attributes", {}).get(key, "")) == value:
            return True
        return any(SpanCollector._span_has_attr(c, key, value)
                   for c in d.get("children", ()))

    def query(self, deployment: Optional[str] = None,
              status: Optional[str] = None,
              min_duration_ms: Optional[float] = None,
              drill: Optional[str] = None,
              trace_id: Optional[str] = None,
              replica: Optional[str] = None,
              n: int = 50) -> list[dict]:
        with self._lock:
            recs = list(self._kept)
        out = []
        for rec in reversed(recs):  # newest first
            if deployment and rec.get("deployment") != deployment:
                continue
            if status and rec.get("status", "").upper() != status.upper():
                continue
            if (min_duration_ms is not None
                    and rec.get("duration_ms", 0.0) < min_duration_ms):
                continue
            if trace_id and rec.get("trace_id") != trace_id:
                continue
            if replica:
                # matches the serving replica (root attribute) OR any
                # hop span that touched it (gateway retry journeys)
                if (rec.get("replica") != replica
                        and not self._span_has_attr(
                            rec.get("root", {}), "replica", replica)):
                    continue
            if drill:
                state = rec.get("tracestate", {})
                if (state.get("drill-id") != drill
                        and not self._span_has_attr(
                            rec.get("root", {}), "drill-id", drill)):
                    continue
            out.append(rec)
            if len(out) >= n:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "offered": self.offered,
                "kept_head": self.kept_head,
                "kept_tail": self.kept_tail,
                "dropped": self.dropped,
                "buffered": len(self._kept),
                "slow_ms": self.slow_ms,
            }

    def clear(self) -> None:
        with self._lock:
            self._kept.clear()


# -- tracer ------------------------------------------------------------------
class Tracer:
    """Collects span trees per request into a bounded LRU ring, minting and
    propagating W3C context, optionally feeding a :class:`SpanCollector`."""

    def __init__(self, max_traces: int = 256, enabled: bool = True,
                 sample_rate: float = 1.0,
                 collector: Optional[SpanCollector] = None):
        self.enabled = enabled
        self.max_traces = max_traces
        self.sample_rate = sample_rate
        self.collector = collector
        self._traces: OrderedDict[str, Span] = OrderedDict()
        self._lock = threading.Lock()

    # -- context --------------------------------------------------------
    def new_context(self, trace_hint: Optional[str] = None) -> TraceContext:
        """Mint a fresh root context, applying the head-sampling decision.
        ``trace_hint`` (the request puid, already 128-bit hex) becomes the
        trace ID when well-formed, so trace IDs are deterministic per
        request — walk and fused-plan runs of one request share one ID."""
        tid = trace_hint if _is_hex(trace_hint, 32) else new_trace_id()
        sampled = (self.sample_rate >= 1.0
                   or random.random() < self.sample_rate)
        return TraceContext(tid, "", sampled)

    # -- span API -------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, kind: str = "", **attributes) -> Iterator[Span]:
        """Open a child span of the context's current span.  Works across
        await boundaries: each asyncio task inherits the parent's context
        snapshot, so concurrent siblings attach to the same parent."""
        if not self.enabled:
            yield _DUMMY
            return
        sp = Span(name=name, kind=kind, attributes=dict(attributes),
                  start_ns=now_ns(), span_id=new_span_id())
        parent = _current_span.get()
        ctx = _current_ctx.get()
        if parent is not None:
            # list.append is atomic under the GIL; concurrent siblings are safe
            sp.trace_id = parent.trace_id
            sp.parent_span_id = parent.span_id
            parent.children.append(sp)
        elif ctx is not None:
            # root of this process's tree: parent is the remote caller's
            # span (the inbound traceparent's span-id)
            sp.trace_id = ctx.trace_id
            sp.parent_span_id = ctx.span_id
        token = _current_span.set(sp)
        # publish this span as the active one, so downstream hops (remote
        # clients, batcher enqueue) parent/link to it
        ctx_token = (_current_ctx.set(ctx.child(sp.span_id))
                     if ctx is not None else None)
        try:
            yield sp
        except BaseException as e:
            sp.status = f"ERROR: {type(e).__name__}"
            raise
        finally:
            sp.end_ns = now_ns()
            if ctx_token is not None:
                _current_ctx.reset(ctx_token)
            _current_span.reset(token)

    @contextlib.contextmanager
    def trace(self, puid: str, name: str = "predict", **attributes
              ) -> Iterator[Span]:
        """Open (and on exit, record) a root span for one request.  Joins
        the ambient :class:`TraceContext` when one is bound, else mints one
        (trace ID derived from the puid)."""
        if not self.enabled:
            yield _DUMMY
            return
        ctx = _current_ctx.get()
        scope = (trace_scope(self.new_context(trace_hint=puid))
                 if ctx is None else contextlib.nullcontext())
        with scope:
            bound = _current_ctx.get()
            root_sp: Optional[Span] = None
            try:
                with self.span(name, kind="request", puid=puid,
                               **attributes) as root:
                    root_sp = root
                    try:
                        yield root
                    finally:
                        # record even on failure — error traces are the
                        # useful ones (the ring holds a reference, so the
                        # status set on exception is still visible)
                        self._record(puid, root)
            finally:
                # offer only after the span closed: end_ns and the error
                # status are final by now, and the collector snapshots
                if root_sp is not None and self.collector is not None:
                    sampled = bound.sampled if bound is not None else True
                    extra = None
                    if bound is not None and bound.state:
                        # tracestate rides the record so /admin/traces can
                        # filter by drill-id without walking every span
                        extra = {"tracestate": dict(bound.state)}
                    self.collector.offer(root_sp, sampled=sampled,
                                         extra=extra)

    def _record(self, puid: str, root: Span) -> None:
        with self._lock:
            self._traces[puid] = root
            self._traces.move_to_end(puid)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    # -- query ----------------------------------------------------------
    def get(self, puid: str) -> Optional[Span]:
        with self._lock:
            return self._traces.get(puid)

    def recent(self, n: int = 20) -> list[dict]:
        with self._lock:
            spans = list(self._traces.items())[-n:]
        return [{"puid": p, **s.to_dict()} for p, s in reversed(spans)]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_DUMMY = Span(name="disabled")

NULL_TRACER = Tracer(enabled=False)


# -- the LLM engines' job and request records --------------------------------
_IDS = itertools.count(1)


@dataclass(slots=True, eq=False)
class JobRecord:
    """One device job of an LLM engine (its worker thread runs one at a
    time, in submission order).  Times are ``time.perf_counter()``
    seconds; the device fields are None off the card, and until the
    engine has read them (at its next tick, once the job's end event has
    completed).

    - ``kind``: ``tick``, ``spec``, ``prefill``, ``extend``, ``insert``,
      ``draft_prefill`` or ``prefix_hit``; ``key`` its program's
      shape key where it has one: (rows, bucket) of a prefill, (prefix
      rows, suffix bucket) of an extend, the true length of an insert
    - ``captured``: a program captured a CUDA graph in this job
    - ``device_ms``: the job's span on the worker's stream, between two
      CUDA events recorded as the job starts and after it returns: its
      device work and whatever idle the host leaves inside the job (input
      uploads, launches, the sync that reads its answer), so not the
      card's busy time; ``gap_ms``: the stream's span from the previous
      job's end event to this job's start event, the idle between jobs
    - ``rows``, ``context``: a tick's active rows and the context tokens
      they attend (each row's position + 1: the work of kernel K2)
    - ``tokens``, ``padded``: a prefill's or extend's true and padded
      tokens (rows x bucket)
    """

    kind: str
    engine: int
    t_submit: float
    key: Any = None
    id: int = field(default_factory=lambda: next(_IDS))
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    captured: bool = False
    device_ms: Optional[float] = None
    gap_ms: Optional[float] = None
    rows: Optional[int] = None
    context: Optional[int] = None
    tokens: Optional[int] = None
    padded: Optional[int] = None

    @property
    def t(self) -> float:
        """The time the job ring orders and selects by: its start, or its
        submission while it waits."""
        return self.t_submit if self.t_start is None else self.t_start

    @property
    def label(self) -> str:
        """Its name on a profiler's timeline: ``llm.<kind>(<key>)``, or
        ``llm.<kind>`` for a job with no key."""
        key = self.key
        if key is None:
            return f"llm.{self.kind}"
        if not isinstance(key, tuple):
            key = f"({key})"
        return f"llm.{self.kind}{key}"


@dataclass(slots=True, eq=False)
class RequestRecord:
    """One request to an LLM engine, from its arrival in ``stream`` to its
    end (``time.perf_counter()`` seconds; None where it never got there).

    - ``t_slot``: a slot held; ``t_reserved``: its KV pages held (the slab
      engine reserves none: then as soon as the slot is held)
    - ``jobs``: the :class:`JobRecord` of each job that ran its prefill at
      admission (a preempted request's re-prefill is not among them)
    - ``t_first``: its first token emitted; ``t_done``: its stream ended
    - ``bucket``: the padded row length of its (last) prefill job: the
      prompt's bucket, or the suffix's after a prefix hit (None where no
      prefill ran); ``variant``: ``solo``, ``batched``, ``prefix`` (the
      whole prompt a registered prefix), ``extend`` (a prefix hit, the
      suffix run) or ``chunked``
    - ``outcome``: ``ok``, ``shed`` (an admission deadline), ``cancelled``
      (the consumer walked away) or ``error``
    """

    engine: int
    t_arrive: float
    prompt: int
    id: int = field(default_factory=lambda: next(_IDS))
    t_slot: Optional[float] = None
    t_reserved: Optional[float] = None
    jobs: list = field(default_factory=list)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    bucket: Optional[int] = None
    variant: Optional[str] = None
    tokens: int = 0
    outcome: Optional[str] = None

    @property
    def t(self) -> float:
        return self.t_arrive


class RecordRing:
    """A bounded ring of records (each with a time ``t``) in the order they
    were made.  A reader asking from a time the ring may have dropped
    records at or after gets None, not a part."""

    def __init__(self, size: int):
        self.size = int(size)
        self._items: deque = deque()
        self._lost: Optional[float] = None  # the latest t of a dropped record
        self._lock = threading.Lock()

    def add(self, rec) -> None:
        with self._lock:
            if len(self._items) >= self.size:
                t = self._items.popleft().t
                self._lost = t if self._lost is None else max(self._lost, t)
            self._items.append(rec)

    def between(self, t0: float = float("-inf"),
                t1: float = float("inf")) -> Optional[list]:
        """The records with ``t0 <= t < t1``; None when the ring no longer
        holds all of them."""
        with self._lock:
            if self._lost is not None and self._lost >= t0:
                return None
            items = list(self._items)
        return [r for r in items if t0 <= r.t < t1]


#: every LLM engine's job records (a 51 s window of 64-row decode holds
#: about 3000 jobs) and request records, process-wide, so that a reader
#: still reaches them once the engine is closed
JOBS = RecordRing(1 << 15)
REQUESTS = RecordRing(1 << 13)


def job_records(t0: float = float("-inf"),
                t1: float = float("inf")) -> Optional[list]:
    """The job records of every engine started (waiting: submitted) in
    ``[t0, t1)`` of ``time.perf_counter()``; None when the ring no longer
    holds them all."""
    return JOBS.between(t0, t1)


def request_records(t0: float = float("-inf"),
                    t1: float = float("inf")) -> Optional[list]:
    """The request records of every engine that arrived in ``[t0, t1)``;
    None when the ring no longer holds them all."""
    return REQUESTS.between(t0, t1)


def _child(parent: Span, name: str, t0: Optional[float],
           t1: Optional[float], **attributes) -> None:
    if t0 is None or t1 is None:
        return
    parent.children.append(Span(
        name=name, kind="llm", start_ns=epoch_ns(t0), end_ns=epoch_ns(t1),
        attributes={k: v for k, v in attributes.items() if v is not None},
        trace_id=parent.trace_id, span_id=new_span_id(),
        parent_span_id=parent.span_id))


def add_request_spans(parent: Span, req: RequestRecord) -> None:
    """``req``'s phases as children of ``parent``: ``llm.slot_wait``,
    ``llm.page_wait``, ``llm.prefill_queued`` (its first prefill job's
    submission to its start), ``llm.prefill`` (the prefill jobs' first
    start to their last end) and ``llm.decode`` (first token to the
    stream's end); a phase the request never reached is left out."""
    _child(parent, "llm.slot_wait", req.t_arrive, req.t_slot)
    _child(parent, "llm.page_wait", req.t_slot, req.t_reserved)
    if req.jobs:
        first, last = req.jobs[0], req.jobs[-1]
        times = [j.device_ms for j in req.jobs]
        _child(parent, "llm.prefill_queued", first.t_submit, first.t_start)
        _child(parent, "llm.prefill", first.t_start, last.t_end,
               variant=req.variant, bucket=req.bucket, tokens=req.prompt,
               device_ms=None if None in times else sum(times))
    _child(parent, "llm.decode", req.t_first, req.t_done, tokens=req.tokens)


# -- annotation config (admission-validated; see graphlint GL9xx) ------------
@dataclass(frozen=True)
class TraceConfig:
    enabled: bool = False
    sample_rate: float = 1.0
    export_path: str = ""
    slow_ms: float = 250.0
    max_traces: int = 256


def trace_config_from_annotations(ann: dict, where: str = "") -> TraceConfig:
    """Parse + validate the tracing annotation family; raises ``ValueError``
    with a path-prefixed message on any malformed knob (the same contract
    ``qos_from_annotations`` honors, so admission and graphlint share it)."""
    at = f" at {where}" if where else ""

    flag = str(ann.get(TRACING_ANNOTATION,
                       os.environ.get("SELDON_TRACING", ""))).lower()
    enabled = flag in ("1", "true", "yes")

    raw = ann.get(SAMPLE_ANNOTATION, os.environ.get("SELDON_TRACE_SAMPLE"))
    sample_rate = 1.0
    if raw is not None:
        try:
            sample_rate = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{SAMPLE_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"{SAMPLE_ANNOTATION}{at}: {sample_rate} outside [0, 1]"
            )

    export_path = str(
        ann.get(EXPORT_ANNOTATION, os.environ.get("SELDON_TRACE_EXPORT", ""))
        or ""
    )

    raw = ann.get(SLOW_MS_ANNOTATION)
    slow_ms = 250.0
    if raw is not None:
        try:
            slow_ms = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{SLOW_MS_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if slow_ms <= 0:
            raise ValueError(f"{SLOW_MS_ANNOTATION}{at}: must be > 0")

    raw = ann.get(TRACING_MAX_ANNOTATION)
    max_traces = 256
    if raw is not None:
        try:
            max_traces = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{TRACING_MAX_ANNOTATION}{at}: {raw!r} is not an integer"
            ) from None
        if max_traces <= 0:
            raise ValueError(f"{TRACING_MAX_ANNOTATION}{at}: must be > 0")

    return TraceConfig(enabled=enabled, sample_rate=sample_rate,
                       export_path=export_path, slow_ms=slow_ms,
                       max_traces=max_traces)


# -- device trace windows ----------------------------------------------------
_profile_lock = threading.Lock()
_profile_active = False


def profiler_active() -> bool:
    """Whether a :func:`device_profile` window is open."""
    return _profile_active


@contextlib.contextmanager
def profile_annotation(name: str):
    """Named range on the host and device timelines while a
    :func:`device_profile` window is open (``torch.profiler.
    record_function`` plus an NVTX range when a card is visible); a free
    no-op otherwise (a module flag, no torch call on the hot path).  The
    window records the ranges of every thread where torch can
    (:func:`all_threads_config`).  The NVTX range is a start/end pair, not
    a push/pop, so ranges of coroutines that interleave across ``await``
    stay apart."""
    if not _profile_active:
        yield
        return
    import torch

    nvtx = None
    if torch.cuda.is_available():
        nvtx = torch.cuda.nvtx.range_start(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx is not None:
            torch.cuda.nvtx.range_end(nvtx)


_warmed = False


def warm_device_profile() -> None:
    """Pay the profiler's first start now: ``torch.profiler``'s first
    session imports several hundred modules (``torch._dynamo`` and sympy
    among them: seconds on an idle host, many times that while another
    thread holds the GIL), which would otherwise land inside the first
    capture window a user opens.  One host-only session, started and stopped on
    this thread, once per process (the profiling plane calls it when it
    is built); a no-op while a window is open."""
    global _warmed
    import torch

    with _profile_lock:
        if _warmed or _profile_active:
            return
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        prof.stop()
        _warmed = True


def all_threads_config():
    """``torch.profiler``'s configuration that records the host ranges of
    every thread, not only the one that starts the session; None where
    the installed torch has no such setting."""
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class _ProfilerSession:
    """One ``torch.profiler`` session on a thread of its own.

    ``torch.profiler`` keeps its session in the state of the thread that
    started it, so a stop from another thread fails; a capture window may
    be closed by the host sampler's thread or a request handler, never by
    the one that opened it.  The session thread starts the profiler, waits
    for :meth:`close`, stops it and writes the Chrome trace.  CUDA activity
    (CUPTI) is recorded for the whole process either way; host-side ranges
    of every thread (the LLM engines' device workers, the event loop's
    segments) where torch can (:func:`all_threads_config`), else of the
    session's own thread only."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run,
                                        name="device-profile", daemon=True)

    def _run(self) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities,
                                      experimental_config=all_threads_config())
        try:
            prof.start()
        except BaseException as e:
            # a start can fail after activating part of the session: tear
            # it down so the next window can start cleanly
            with contextlib.suppress(Exception):
                prof.stop()
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            path = os.path.join(
                self.logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            self.path = path
        except BaseException as e:
            self._error = e

    def open(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._thread.join()
            raise self._error

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            logger.warning("device_profile(%s): trace not written: %s",
                           self.logdir, self._error)


@contextlib.contextmanager
def device_profile(logdir: str):
    """``torch.profiler`` trace of CPU and CUDA activity around a serving
    window (CUPTI records every kernel of the process, whichever thread
    launched it, the ctypes-launched kernels included); at close the
    Chrome trace lands in ``logdir`` as ``trace-<pid>-<ns>.json``.  Yields
    the session, whose ``path`` names the trace once the window closed.

    One session per process: a nested call while a window is open warns
    and does nothing (yields None), and a start that raises is torn down
    before the error propagates, so the next window starts cleanly.
    """
    global _profile_active
    with _profile_lock:
        already = _profile_active
        if not already:
            _profile_active = True
    if already:
        logger.warning(
            "device_profile(%s): a profiler trace is already active; "
            "nested call is a no-op", logdir,
        )
        yield None
        return
    session = None
    try:
        os.makedirs(logdir, exist_ok=True)
        session = _ProfilerSession(logdir)
        try:
            session.open()
        except BaseException:
            session = None
            raise
        yield session
    finally:
        try:
            if session is not None:
                session.close()
        finally:
            with _profile_lock:
                _profile_active = False


#: the reference's name, so callers read the same
xla_profile = device_profile
