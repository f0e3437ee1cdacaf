"""ASCII trace viewer: waterfall + time-attribution summary.

Renders traces exported by the tracing subsystem (docs/observability.md) —
either the OTLP JSON-lines file a ``FileSpanSink`` writes, or the nested
span trees the ``/trace`` (engine) and ``/admin/traces`` (gateway)
endpoints return — as a terminal waterfall, and summarizes where the
request's wall-clock went: host dispatch, device compute
(``block_until_ready``), network/queue (time inside a span but outside
any child), and shed/degraded/chaos events.

With ``--introspect`` pointing at an ``/admin/introspect`` dump (the
health plane's runtime timelines), ``--lanes`` adds sparkline lanes
under the waterfalls — device memory and batch-queue depth over the
same wall-clock the traces cover — so a latency spike can be eyeballed
against HBM pressure or queue buildup without leaving the terminal.

Usage::

    python -m seldon_core_tpu_torch.tools.traceview /tmp/traces.jsonl
    python -m seldon_core_tpu_torch.tools.traceview traces.jsonl --trace-id 0af7...
    curl -s engine:8000/trace | python -m seldon_core_tpu_torch.tools.traceview -
    python -m seldon_core_tpu_torch.tools.traceview traces.jsonl \
        --introspect introspect.json --lanes memory,queue
    curl -s 'gw:8080/admin/fleet/traces?trace_id=0af7...' | \\
        python -m seldon_core_tpu_torch.tools.traceview -

The last form renders a stitched fleet journey: the gateway root with
one indented ``-> hop rN`` lane per forward attempt (connect-failed
hops show the ``eject_reason`` that pulled the replica from rotation),
followed by each replica's own server-side trace.

No external dependencies: the OTLP envelope is parsed right back into the
plain span dicts the renderer consumes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Iterable, Optional

#: span kinds whose self-time is engine-side host work (the graph walk)
_ENGINE_KINDS = {
    "MODEL", "ROUTER", "COMBINER", "TRANSFORMER", "OUTPUT_TRANSFORMER",
    "FUSED_SEGMENT", "CACHE_HIT", "CACHE_COALESCED",
}


# ---------------------------------------------------------------------------
# parsing: OTLP JSON-lines / nested to_dict trees → uniform span dicts
# ---------------------------------------------------------------------------

def _attr_value(v: dict) -> Any:
    """Invert tracing._otlp_attr_value: typed OTLP value → plain Python."""
    if "boolValue" in v:
        return v["boolValue"]
    if "intValue" in v:
        return int(v["intValue"])
    if "doubleValue" in v:
        return v["doubleValue"]
    return v.get("stringValue", "")


def _from_otlp_span(s: dict) -> dict:
    attrs = {a["key"]: _attr_value(a.get("value", {}))
             for a in s.get("attributes", [])}
    kind = attrs.pop("seldon.kind", "")
    start = int(s.get("startTimeUnixNano", 0))
    end = int(s.get("endTimeUnixNano", 0))
    status = s.get("status", {})
    return {
        "name": s.get("name", "?"),
        "kind": kind,
        "start_ns": start,
        "duration_ms": (end - start) / 1e6,
        "status": ("OK" if status.get("code") == 1
                   else status.get("message", "ERROR")),
        "attributes": attrs,
        "children": [],
        "span_id": s.get("spanId", ""),
        "parent_span_id": s.get("parentSpanId", ""),
        "trace_id": s.get("traceId", ""),
        "events": [
            {
                "name": ev.get("name", "?"),
                "time_ns": int(ev.get("timeUnixNano", 0)),
                "attributes": {a["key"]: _attr_value(a.get("value", {}))
                               for a in ev.get("attributes", [])},
            }
            for ev in s.get("events", [])
        ],
        "links": [
            {"trace_id": ln.get("traceId", ""),
             "span_id": ln.get("spanId", "")}
            for ln in s.get("links", [])
        ],
    }


def tree_from_otlp(envelope: dict) -> tuple[Optional[dict], str]:
    """One OTLP ``resourceSpans`` envelope → (root span tree, service).
    Spans whose parent is missing from the envelope become roots; the
    first root wins (a FileSpanSink line holds exactly one trace)."""
    service = ""
    flat: list[dict] = []
    for rs in envelope.get("resourceSpans", []):
        for a in rs.get("resource", {}).get("attributes", []):
            if a.get("key") == "service.name":
                service = str(_attr_value(a.get("value", {})))
        for ss in rs.get("scopeSpans", []):
            flat.extend(_from_otlp_span(s) for s in ss.get("spans", []))
    by_id = {s["span_id"]: s for s in flat if s["span_id"]}
    roots = []
    for s in flat:
        parent = by_id.get(s["parent_span_id"])
        if parent is not None and parent is not s:
            parent["children"].append(s)
        else:
            roots.append(s)
    return (roots[0] if roots else None), service


def load_traces(stream: Iterable[str]) -> list[tuple[dict, str]]:
    """Parse a mixed input stream into ``[(root_tree, service), ...]``.

    Accepts OTLP JSON-lines (one envelope per line), a single JSON
    document from ``/trace`` / ``/admin/traces`` (``{"traces": [...]}``,
    ``{"recent": ...}`` or one span tree), or raw span-tree lines.
    """
    text = "".join(stream).strip()
    if not text:
        return []
    out: list[tuple[dict, str]] = []

    def _ingest(doc: Any) -> None:
        if not isinstance(doc, dict):
            return
        if "resourceSpans" in doc:
            root, service = tree_from_otlp(doc)
            if root is not None:
                out.append((root, service))
        elif "traces" in doc:        # /admin/traces & collector.query shape
            for rec in doc["traces"]:
                if isinstance(rec, dict) and isinstance(rec.get("root"), dict):
                    out.append((rec["root"], str(rec.get("service", ""))))
        elif "replicasInvolved" in doc and isinstance(doc.get("replicas"),
                                                      dict):
            # /admin/fleet/traces stitched envelope: the gateway journey
            # (hop lanes) first, then each replica's server-side view
            for rec in doc.get("gateway", []):
                if isinstance(rec, dict) and isinstance(rec.get("root"), dict):
                    out.append((rec["root"],
                                str(rec.get("service", "") or "gateway")))
            for rid, recs in doc["replicas"].items():
                for rec in recs if isinstance(recs, list) else []:
                    if not isinstance(rec, dict):
                        continue
                    root = rec.get("root")
                    if root is None and "name" in rec:
                        root = rec     # tracer.recent() items ARE the tree
                    if isinstance(root, dict):
                        out.append((root, str(rid)))
        elif "trace" in doc and isinstance(doc["trace"], dict):
            out.append((doc["trace"], ""))   # /trace?puid= shape
        elif "root" in doc and isinstance(doc["root"], dict):
            out.append((doc["root"], ""))    # one collector record
        elif "name" in doc:
            out.append((doc, ""))            # bare span tree

    try:
        _ingest(json.loads(text))
        if out:
            return out
    except ValueError:
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            _ingest(json.loads(line))
        except ValueError:
            continue
    return out


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def _walk(sp: dict):
    yield sp
    for c in sp.get("children", []):
        yield from _walk(c)


def summarize(root: dict) -> dict:
    """Attribute the trace's wall-clock: device vs host-dispatch vs
    network/queue vs shed, plus notable events — the numbers an operator
    wants before any flamegraph zooming."""
    total = float(root.get("duration_ms", 0.0))
    device = host_dispatch = engine_self = 0.0
    network_queue = 0.0
    events: list[str] = []
    errors = 0
    for sp in _walk(root):
        attrs = sp.get("attributes", {})
        device += float(attrs.get("device_block_ms", 0.0) or 0.0)
        host_dispatch += float(attrs.get("host_dispatch_ms", 0.0) or 0.0)
        child_ms = sum(float(c.get("duration_ms", 0.0))
                       for c in sp.get("children", []))
        self_ms = max(0.0, float(sp.get("duration_ms", 0.0)) - child_ms)
        if sp.get("kind") in _ENGINE_KINDS:
            engine_self += self_ms
        elif sp.get("children"):
            # a parent (gateway/engine root) waiting on its children:
            # the unaccounted slice is transport + queueing
            network_queue += self_ms
        if str(sp.get("status", "OK")) != "OK":
            errors += 1
        for ev in sp.get("events", []):
            tag = ev.get("name", "?")
            reason = ev.get("attributes", {}).get("reason") \
                or ev.get("attributes", {}).get("kind") or ""
            events.append(f"{tag}({reason})" if reason else tag)
    return {
        "total_ms": round(total, 3),
        "device_ms": round(device, 3),
        "host_dispatch_ms": round(host_dispatch, 3),
        "engine_host_ms": round(max(0.0, engine_self - device), 3),
        "network_queue_ms": round(network_queue, 3),
        "errors": errors,
        "events": events,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render_waterfall(root: dict, service: str = "", width: int = 100) -> str:
    """One trace as an indented waterfall: bar offset = start relative to
    the root, bar length = share of the root's duration."""
    lines: list[str] = []
    t0 = int(root.get("start_ns", 0))
    total_ms = max(float(root.get("duration_ms", 0.0)), 1e-9)
    bar_w = max(16, width - 58)
    head = f"trace {root.get('trace_id', '?')[:16]}"
    if service:
        head += f" service={service}"
    head += (f" status={root.get('status', 'OK')}"
             f" total={total_ms:.3f}ms")
    lines.append(head)

    def emit(sp: dict, depth: int) -> None:
        off_ms = (int(sp.get("start_ns", 0)) - t0) / 1e6
        dur_ms = float(sp.get("duration_ms", 0.0))
        lo = min(bar_w - 1, max(0, round(off_ms / total_ms * bar_w)))
        ln = max(1, round(dur_ms / total_ms * bar_w))
        ln = min(ln, bar_w - lo)
        bar = " " * lo + "#" * ln + " " * (bar_w - lo - ln)
        kind = sp.get("kind", "")
        attrs = sp.get("attributes", {})
        if kind == "hop":
            # retry lane: one indented row per gateway attempt, labeled
            # with the replica it targeted (connect-failed hops carry
            # the eject_reason that pulled the replica from rotation)
            rid = attrs.get("replica") or "?"
            label = "  " * depth + f"-> hop {rid}"
            attempt = attrs.get("attempt")
            if attempt not in (None, ""):
                label += f" #{attempt}"
        else:
            label = "  " * depth + sp.get("name", "?")
            if kind and kind != "request":
                label += f" [{kind}]"
        status = str(sp.get("status", "OK"))
        flag = "" if status == "OK" else f"  !! {status}"
        if attrs.get("eject_reason"):
            flag += f" ejected: {attrs['eject_reason']}"
        marks = "".join(
            " *" + ev.get("name", "?") for ev in sp.get("events", []))
        links = sp.get("links", [])
        if links:
            marks += f" ->{len(links)} linked"
        lines.append(f"  {label:<36.36s} |{bar}| {dur_ms:9.3f}ms"
                     f"{flag}{marks}")
        for c in sp.get("children", []):
            emit(c, depth + 1)

    emit(root, 0)
    s = summarize(root)
    attribution = (
        f"  `- device {s['device_ms']}ms"
        f" | host dispatch {s['host_dispatch_ms']}ms"
        f" | engine host {s['engine_host_ms']}ms"
        f" | network/queue {s['network_queue_ms']}ms"
    )
    if s["events"]:
        attribution += f" | events: {', '.join(s['events'])}"
    lines.append(attribution)
    return "\n".join(lines)


def render_report(traces: list[tuple[dict, str]], width: int = 100,
                  summary_only: bool = False) -> str:
    out: list[str] = []
    agg = {"device_ms": 0.0, "host_dispatch_ms": 0.0,
           "network_queue_ms": 0.0, "total_ms": 0.0, "errors": 0}
    for root, service in traces:
        if not summary_only:
            out.append(render_waterfall(root, service, width=width))
            out.append("")
        s = summarize(root)
        for k in ("device_ms", "host_dispatch_ms", "network_queue_ms",
                  "total_ms"):
            agg[k] += s[k]
        agg["errors"] += s["errors"]
    n = len(traces)
    out.append(f"{n} trace(s): total {agg['total_ms']:.3f}ms, "
               f"device {agg['device_ms']:.3f}ms, "
               f"host dispatch {agg['host_dispatch_ms']:.3f}ms, "
               f"network/queue {agg['network_queue_ms']:.3f}ms, "
               f"{agg['errors']} error span(s)")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# introspection lanes (health plane /admin/introspect overlays)
# ---------------------------------------------------------------------------

#: sparkline ramp, low → high (pure ASCII like the waterfall bars)
_RAMP = " .:-=+*#%@"

#: lane name → (label, unit, extractor over one sample's probe dicts)
_LANES = {
    "memory": (
        "memory", "MB",
        lambda probes: _first_value(
            probes, ("hbm_bytes_in_use", "host_rss_bytes")) / 1e6,
    ),
    "queue": (
        "queue", "rows",
        lambda probes: sum(
            float(p.get("queue_rows", 0.0) or 0.0) for p in probes.values()),
    ),
    # profiling plane (profiling/plane.py profile probe): estimated
    # device-FLOP occupancy from per-request attribution — the lane that
    # answers "was the device actually busy during that latency spike?"
    "device": (
        "device", "occupancy",
        lambda probes: _first_value(probes, ("device_occupancy_est",)),
    ),
}


def _first_value(probes: dict, keys: tuple) -> float:
    for key in keys:
        for p in probes.values():
            if key in p:
                return float(p[key] or 0.0)
    return 0.0


def load_introspection(stream: Iterable[str]) -> list[dict]:
    """Parse an ``/admin/introspect`` response (``{"samples": [...]}``),
    a bare samples list, or JSON-lines of samples into sample dicts."""
    text = "".join(stream).strip()
    if not text:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        out = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return [s for s in out if isinstance(s, dict) and "probes" in s]
    if isinstance(doc, dict):
        doc = doc.get("samples", [])
    if not isinstance(doc, list):
        return []
    return [s for s in doc if isinstance(s, dict) and "probes" in s]


def render_lanes(samples: list[dict], lanes: list[str],
                 width: int = 100) -> str:
    """Sparkline lanes over the introspection timeline: one row per lane,
    amplitude normalized per lane, min/max printed so the ramp has
    units.  Sample count > width is downsampled by striding."""
    if not samples:
        return "no introspection samples"
    lane_w = max(16, width - 40)
    stride = max(1, -(-len(samples) // lane_w))  # ceil division
    picked = samples[::stride]
    t0 = float(picked[0].get("ts", 0.0))
    t1 = float(picked[-1].get("ts", t0))
    lines = [f"introspection: {len(samples)} sample(s) over "
             f"{max(0.0, t1 - t0):.1f}s"]
    for name in lanes:
        if name not in _LANES:
            lines.append(f"  {name:<8s} (unknown lane; have: "
                         f"{', '.join(sorted(_LANES))})")
            continue
        label, unit, fn = _LANES[name]
        vals = [fn(s.get("probes", {})) for s in picked]
        lo, hi = min(vals), max(vals)
        span = (hi - lo) or 1.0
        cells = "".join(
            _RAMP[min(len(_RAMP) - 1,
                      int((v - lo) / span * (len(_RAMP) - 1)))]
            for v in vals)
        lines.append(f"  {label:<8s}|{cells:<{lane_w}.{lane_w}s}| "
                     f"{lo:.1f}..{hi:.1f} {unit}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="traceview",
        description="render exported traces as an ASCII waterfall",
    )
    ap.add_argument("path", nargs="?", default="",
                    help="OTLP JSON-lines file, /trace JSON dump, or '-' "
                         "for stdin (optional with --introspect)")
    ap.add_argument("--trace-id", default="",
                    help="only render traces whose ID starts with this")
    ap.add_argument("--last", type=int, default=0,
                    help="only the last N traces")
    ap.add_argument("--errors-only", action="store_true",
                    help="only traces containing an error span")
    ap.add_argument("--width", type=int, default=100)
    ap.add_argument("--summary", action="store_true",
                    help="aggregate summary only, no waterfalls")
    ap.add_argument("--introspect", default="",
                    help="/admin/introspect JSON dump to render as "
                         "sparkline lanes under the report")
    ap.add_argument("--lanes", default="memory,queue,device",
                    help="comma-separated introspection lanes "
                         "(memory,queue,device); used with --introspect")
    args = ap.parse_args(argv)

    if not args.path and not args.introspect:
        ap.error("a trace path and/or --introspect is required")
    if args.path == "-":
        traces = load_traces(sys.stdin)
    elif args.path:
        with open(args.path) as f:
            traces = load_traces(f)
    else:
        traces = []
    if args.trace_id:
        traces = [t for t in traces
                  if str(t[0].get("trace_id", "")).startswith(args.trace_id)]
    if args.errors_only:
        traces = [t for t in traces
                  if any(str(s.get("status", "OK")) != "OK"
                         for s in _walk(t[0]))]
    if args.last:
        traces = traces[-args.last:]
    if not traces and not args.introspect:
        print("no traces matched", file=sys.stderr)
        return 1
    if traces:
        print(render_report(traces, width=args.width,
                            summary_only=args.summary))
    elif args.path:
        print("no traces matched", file=sys.stderr)
    if args.introspect:
        with open(args.introspect) as f:
            samples = load_introspection(f)
        lanes = [x.strip() for x in args.lanes.split(",") if x.strip()]
        print(render_lanes(samples, lanes, width=args.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())
