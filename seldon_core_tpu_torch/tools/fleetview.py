"""ASCII fleet viewer: per-replica lanes from ``/admin/fleet/health``.

Renders the fleet-observability verdict (docs/observability.md#fleet-
observability) as one lane per replica — its own health verdict, latency
median, error rate, compile count, and a skew bar showing how many MADs
it sits from the fleet median on each dimension — plus the fused fleet
verdict and the straggler / compile-skew signals that produced it.

With ``--decisions`` pointing at an ``/admin/fleet/decisions`` dump, the
audit ring is appended as a chronological ledger, so "why is the fleet
shaped like this" and "who is dragging it" answer from one screen.

With ``--placement`` pointing at an ``/admin/placement`` dump, the
device-placement table is appended: one row per fused segment (pinned /
bin-packed / dp-sharded / tp-span) and, for tensor-parallel spans, the
mesh slice, per-device HBM share and the params that shard over ``tp``.

Usage::

    curl -s gw:8080/admin/fleet/health | \\
        python -m seldon_core_tpu_torch.tools.fleetview -
    python -m seldon_core_tpu_torch.tools.fleetview health.json \\
        --decisions decisions.json

No external dependencies — same posture as traceview.py / profview.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, Optional

#: skew-bar cell per this many MADs of distance from the fleet median
_MADS_PER_CELL = 0.5


def load_fleet_health(stream: Iterable[str]) -> dict:
    """Parse an ``/admin/fleet/health`` response (or anything carrying
    its ``replicas`` mapping) into the payload dict."""
    text = "".join(stream).strip()
    if not text:
        return {}
    try:
        doc = json.loads(text)
    except ValueError:
        return {}
    return doc if isinstance(doc, dict) else {}


def _skew_bar(score: float, mad_k: float, width: int = 12) -> str:
    """Distance from the fleet median as a bar: one cell per
    ``_MADS_PER_CELL`` MADs, ``!`` marking the outlier threshold."""
    cells = min(width, int(round(score / _MADS_PER_CELL)))
    bar = "#" * cells + " " * (width - cells)
    cut = min(width - 1, int(round(mad_k / _MADS_PER_CELL)))
    if cells <= cut:
        bar = bar[:cut] + "|" + bar[cut + 1:]
    else:
        bar = bar[:cut] + "!" + bar[cut + 1:]
    return bar


def render_fleet(payload: dict, width: int = 100) -> str:
    """One lane per replica + the fused verdict and its signals."""
    replicas = payload.get("replicas")
    if not isinstance(replicas, dict) or not replicas:
        return "no replicas in payload (is this /admin/fleet/health?)"
    mad_k = float(payload.get("madK", 3.5) or 3.5)
    skew = payload.get("skew", {}) if isinstance(payload.get("skew"),
                                                 dict) else {}
    lat_skew = skew.get("latency", {})
    lines = [
        f"fleet {payload.get('deployment') or '?'}: "
        f"verdict {payload.get('verdict', '?')}"
        + (" (partial scrape)" if payload.get("partial") else "")
        + (" [cached]" if payload.get("cached") else ""),
        f"  {'replica':<10s} {'verdict':<9s} {'p50 ms':>9s} "
        f"{'err':>6s} {'compiles':>8s}  latency skew (| = {mad_k:g} MADs)",
    ]
    for rid in sorted(replicas):
        rep = replicas[rid]
        if not isinstance(rep, dict):
            continue
        if rep.get("unreachable"):
            lines.append(f"  {rid:<10s} {'DOWN':<9s} {'-':>9s} {'-':>6s} "
                         f"{'-':>8s}  {rep.get('error', 'unreachable')}")
            continue
        lat = rep.get("latencyMs")
        err = rep.get("errorRate")
        comp = rep.get("compiles")
        score = float(lat_skew.get(rid, 0.0) or 0.0)
        marks = "".join(
            f"  *{s.get('signal', '?')}" for s in payload.get("signals", [])
            if isinstance(s, dict) and s.get("replica") == rid)
        lat_s = f"{lat:>9.3f}" if isinstance(lat, (int, float)) else f"{'-':>9s}"
        err_s = f"{err:>5.1%}" if isinstance(err, (int, float)) else f"{'-':>6s}"
        comp_s = f"{comp:>8d}" if isinstance(comp, int) else f"{'-':>8s}"
        lines.append(
            f"  {rid:<10s} {str(rep.get('verdict', '?')):<9s} {lat_s} "
            f"{err_s} {comp_s}  |{_skew_bar(score, mad_k)}| "
            f"{score:4.1f}{marks}")
    signals = [s for s in payload.get("signals", []) if isinstance(s, dict)]
    if signals:
        lines.append("  signals:")
        for s in signals:
            lines.append(
                f"    {s.get('signal', '?')}: {s.get('replica', '?')} "
                f"({s.get('dimension', '?')} {s.get('value', '?')} vs "
                f"median {s.get('fleetMedian', '?')}, "
                f"{s.get('score', '?')} MADs)")
    unreachable = payload.get("unreachable") or []
    if unreachable:
        lines.append(f"  unreachable: {', '.join(unreachable)}")
    return "\n".join(lines)


def _mib(n) -> str:
    try:
        return f"{float(n) / (1 << 20):.2f} MiB"
    except (TypeError, ValueError):
        return "?"


def render_placement(payload: dict) -> str:
    """An ``/admin/placement`` dump as a device-placement table: one row
    per segment (pinned / bin-packed / dp-sharded / tp-span) and, for tp
    spans, the mesh slice, per-device HBM share and which params shard —
    the "does the big segment actually fit now" screen."""
    segments = payload.get("segments")
    if not isinstance(segments, list) or not segments:
        return "no segments in payload (is this /admin/placement?)"
    lines = [
        f"placement {payload.get('deployment') or '?'}: "
        f"mesh {payload.get('mesh', '?')!r} over "
        f"{payload.get('devices', '?')} device(s), "
        f"{payload.get('shardedDispatches', 0)} sharded dispatch(es)",
        f"  {'segment':<16s} {'source':<9s} {'devices':<12s} "
        f"{'HBM':>12s}  slice",
    ]
    for row in segments:
        if not isinstance(row, dict):
            continue
        devs = row.get("devices") or []
        dev_s = ",".join(str(d) for d in devs)
        if len(dev_s) > 12:
            dev_s = f"{devs[0]}..{devs[-1]} ({len(devs)})"
        slice_s = ""
        if row.get("source") == "tp-span":
            slice_s = (f"{row.get('meshSlice', '?')} -> "
                       f"{_mib(row.get('tpBytesPerDevice'))}/device")
        lines.append(
            f"  {str(row.get('segment', '?')):<16s} "
            f"{str(row.get('source', '?')):<9s} {dev_s:<12s} "
            f"{_mib(row.get('hbmBytes')):>12s}  {slice_s}")
    over = payload.get("overCapacity") or []
    if over:
        cap = payload.get("deviceCapacityBytes")
        lines.append(
            f"  OVER CAPACITY: device(s) "
            f"{', '.join(str(d) for d in over)}"
            + (f" (budget {_mib(cap)}/device)" if cap else ""))
    for span in payload.get("tpSpans") or []:
        if not isinstance(span, dict):
            continue
        lines.append(
            f"  tp span {span.get('segment', '?')}: "
            f"slice {span.get('meshSlice', '?')}, "
            f"{_mib(span.get('shardedParamBytes'))} sharded -> "
            f"{_mib(span.get('tpBytesPerDevice'))}/device")
        params = span.get("params")
        if isinstance(params, dict):
            for member in sorted(params):
                keys = params[member]
                lines.append(
                    f"    {member}: "
                    f"{', '.join(keys) if keys else '(none)'}")
    return "\n".join(lines)


def render_decisions(doc: dict, last: int = 15) -> str:
    """The audit ring as a chronological ledger (oldest first)."""
    decisions = doc.get("decisions") if isinstance(doc, dict) else None
    if not isinstance(decisions, list) or not decisions:
        return "decision ring empty"
    rows = decisions[-last:] if last else decisions
    lines = [f"decisions ({len(decisions)} in ring, last {len(rows)}):"]
    for d in rows:
        if not isinstance(d, dict):
            continue
        who = d.get("replica") or d.get("deployment") or "?"
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(d.items())
            if k not in ("kind", "replica", "deployment", "ts", "reason")
            and v not in ("", None))
        line = f"  {d.get('kind', '?'):<10s} {who:<14s} " \
               f"{d.get('reason', '')}"
        if detail:
            line += f" ({detail})"
        lines.append(line)
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleetview",
        description="render /admin/fleet/health as per-replica lanes",
    )
    ap.add_argument("path", help="/admin/fleet/health JSON dump, or '-' "
                                 "for stdin")
    ap.add_argument("--decisions", default="",
                    help="/admin/fleet/decisions JSON dump appended as an "
                         "audit ledger")
    ap.add_argument("--placement", default="",
                    help="/admin/placement JSON dump appended as a "
                         "device-placement table (dp rows + tp spans)")
    ap.add_argument("--last", type=int, default=15,
                    help="max decision rows (0 = all)")
    ap.add_argument("--width", type=int, default=100)
    args = ap.parse_args(argv)

    if args.path == "-":
        payload = load_fleet_health(sys.stdin)
    else:
        with open(args.path) as f:
            payload = load_fleet_health(f)
    if not payload and not args.placement:
        print("no fleet health payload", file=sys.stderr)
        return 1
    if payload:
        print(render_fleet(payload, width=args.width))
    if args.decisions:
        with open(args.decisions) as f:
            doc = json.load(f)
        print(render_decisions(doc, last=args.last))
    if args.placement:
        with open(args.placement) as f:
            doc = json.load(f)
        print(render_placement(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
