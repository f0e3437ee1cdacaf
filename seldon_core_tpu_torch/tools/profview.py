"""ASCII flamegraph viewer for collapsed host profiles.

Renders the collapsed-stack profiles the profiling plane exports
(docs/observability.md) — either raw ``stack count`` lines (the
flamegraph.pl format ``HostSampler.render`` emits) or the JSON bodies of
``/admin/profile`` and ``/admin/profile/capture`` (the ``folded`` field
is extracted) — as an indented terminal flamegraph: one line per frame,
bar width proportional to inclusive sample share, so the hot path reads
top-to-bottom without leaving the terminal.

``--diff`` compares two profiles (before/after a change, or two capture
windows around an incident) frame-by-frame on *percentage share*, not raw
counts — two windows of different lengths still diff meaningfully.

Usage::

    curl -s engine:8000/admin/profile | python -m seldon_core_tpu_torch.tools.profview -
    python -m seldon_core_tpu_torch.tools.profview profile.json --min-pct 1
    python -m seldon_core_tpu_torch.tools.profview --diff before.txt after.json
    curl -s gw:8080/admin/fleet/profile > fleet.json
    python -m seldon_core_tpu_torch.tools.profview fleet.json          # fleet sum
    python -m seldon_core_tpu_torch.tools.profview --diff fleet.json#r0 fleet.json#r1

A ``#replica`` path suffix selects one replica's stacks out of an
``/admin/fleet/profile`` envelope, so a straggler's profile diffs
directly against a healthy peer's from the same scrape.

No external dependencies — same posture as traceview.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, Optional

#: frames below this share of total samples are pruned from the tree
#: (keeps the default render focused on where the time actually went)
_DEFAULT_MIN_PCT = 0.5


# ---------------------------------------------------------------------------
# parsing: collapsed text / admin JSON bodies → {stack: count}
# ---------------------------------------------------------------------------

def parse_collapsed(text: str) -> dict:
    """Collapsed-profile input → ``{stack: count}``.

    Accepts raw ``stack count`` lines and the ``/admin/profile`` /
    ``/admin/profile/capture`` JSON bodies (whose ``folded`` field holds
    the same collapsed text).  A stack's frames are ``;``-joined
    root-first; the count is the last whitespace-separated token."""
    text = text.strip()
    if text.startswith("{"):
        body = json.loads(text)
        text = str(body.get("folded", "")).strip()
    folded: dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            folded[stack] = folded.get(stack, 0) + int(count)
        except ValueError:
            continue
    return folded


def load_profile(stream: Iterable[str]) -> dict:
    return parse_collapsed("".join(stream))


# ---------------------------------------------------------------------------
# flamegraph: {stack: count} → frame tree → indented ASCII render
# ---------------------------------------------------------------------------

def build_tree(folded: dict) -> dict:
    """Fold stacks into a frame tree.  Each node is
    ``{"name", "total", "self", "children": {name: node}}`` where
    ``total`` is inclusive samples and ``self`` is samples with no
    deeper frame."""
    root = {"name": "all", "total": 0, "self": 0, "children": {}}
    for stack, count in folded.items():
        root["total"] += count
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = {"name": frame, "total": 0, "self": 0,
                         "children": {}}
                node["children"][frame] = child
            child["total"] += count
            node = child
        node["self"] += count
    return root


def render_flame(folded: dict, width: int = 100,
                 min_pct: float = _DEFAULT_MIN_PCT) -> str:
    """Indented ASCII flamegraph, hottest subtree first at every level."""
    root = build_tree(folded)
    total = root["total"]
    if total <= 0:
        return "empty profile (0 samples)"
    bar_w = max(10, width - 60)
    lines = [f"{total} samples, {len(folded)} distinct stacks"]

    def emit(node: dict, depth: int) -> None:
        pct = 100.0 * node["total"] / total
        if pct < min_pct:
            return
        bar = "#" * max(1, round(bar_w * node["total"] / total))
        label = ("  " * depth + node["name"])[:width - bar_w - 18]
        lines.append(f"{label:<{width - bar_w - 18}s} "
                     f"{pct:5.1f}% {node['total']:>6d} |{bar:<{bar_w}s}|")
        for child in sorted(node["children"].values(),
                            key=lambda c: (-c["total"], c["name"])):
            emit(child, depth + 1)

    for child in sorted(root["children"].values(),
                        key=lambda c: (-c["total"], c["name"])):
        emit(child, 0)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# frame totals + diff
# ---------------------------------------------------------------------------

def frame_totals(folded: dict) -> dict:
    """Inclusive samples per frame label (a frame appearing twice in one
    stack — recursion — still counts that stack's samples once)."""
    totals: dict[str, int] = {}
    for stack, count in folded.items():
        for frame in set(stack.split(";")):
            totals[frame] = totals.get(frame, 0) + count
    return totals


def hottest_frame(folded: dict, prefix: str = "") -> Optional[str]:
    """The frame with the most inclusive samples, optionally restricted
    to labels starting with ``prefix`` (ties break alphabetically).
    ``thread:``/``task:`` root keys are skipped — callers want code."""
    best = None
    for frame, count in sorted(frame_totals(folded).items(),
                               key=lambda kv: (-kv[1], kv[0])):
        if frame.startswith(("thread:", "task:")):
            continue
        if prefix and not frame.startswith(prefix):
            continue
        best = frame
        break
    return best


def diff_profiles(before: dict, after: dict) -> list:
    """Per-frame share delta between two profiles:
    ``[(frame, before_pct, after_pct, delta_pct), ...]`` sorted by
    ``|delta|`` descending.  Shares, not counts — windows of different
    lengths stay comparable."""
    b_tot = frame_totals(before)
    a_tot = frame_totals(after)
    b_all = sum(before.values()) or 1
    a_all = sum(after.values()) or 1
    out = []
    for frame in set(b_tot) | set(a_tot):
        b_pct = 100.0 * b_tot.get(frame, 0) / b_all
        a_pct = 100.0 * a_tot.get(frame, 0) / a_all
        out.append((frame, b_pct, a_pct, a_pct - b_pct))
    out.sort(key=lambda row: (-abs(row[3]), row[0]))
    return out


def render_diff(before: dict, after: dict, top: int = 25,
                min_delta_pct: float = 0.1) -> str:
    rows = [r for r in diff_profiles(before, after)
            if abs(r[3]) >= min_delta_pct][:top]
    if not rows:
        return "no frame moved by >= {:.1f}% of samples".format(min_delta_pct)
    name_w = min(70, max(len(r[0]) for r in rows))
    lines = [
        f"{sum(before.values())} samples before, "
        f"{sum(after.values())} after; share deltas (after - before):",
        f"{'frame':<{name_w}s} {'before':>8s} {'after':>8s} {'delta':>8s}",
    ]
    for frame, b_pct, a_pct, delta in rows:
        lines.append(f"{frame[:name_w]:<{name_w}s} {b_pct:7.1f}% "
                     f"{a_pct:7.1f}% {delta:+7.1f}%")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _read(path: str) -> dict:
    """Read one profile.  ``path`` may carry a ``#replica`` suffix
    (``fleet.json#r0``) selecting one replica's stacks out of an
    ``/admin/fleet/profile`` envelope — so two replicas of the same
    fleet dump diff directly: ``--diff fleet.json#r0 fleet.json#r1``."""
    path, _, rid = path.partition("#")
    if path == "-":
        text = sys.stdin.read()
    else:
        with open(path) as f:
            text = f.read()
    if not rid:
        return parse_collapsed(text)
    body = json.loads(text)
    replicas = body.get("replicas") if isinstance(body, dict) else None
    payload = replicas.get(rid) if isinstance(replicas, dict) else None
    if not isinstance(payload, dict) or not isinstance(
            payload.get("folded"), str):
        have = sorted(r for r in (replicas or {})
                      if isinstance((replicas or {})[r], dict)
                      and isinstance((replicas or {})[r].get("folded"), str))
        raise SystemExit(
            f"profview: no folded profile for replica {rid!r} in "
            f"{path or 'stdin'}"
            + (f" (have: {', '.join(have)})" if have else ""))
    return parse_collapsed(payload["folded"])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="profview",
        description="render collapsed host profiles as an ASCII flamegraph",
    )
    ap.add_argument("path", nargs="?", default="",
                    help="collapsed 'stack count' file, /admin/profile "
                         "JSON dump, or '-' for stdin; append #rN to "
                         "select one replica from an /admin/fleet/profile "
                         "dump")
    ap.add_argument("--diff", nargs=2, metavar=("BEFORE", "AFTER"),
                    help="diff two profiles frame-by-frame instead of "
                         "rendering one")
    ap.add_argument("--width", type=int, default=100)
    ap.add_argument("--min-pct", type=float, default=_DEFAULT_MIN_PCT,
                    help="prune frames below this share of samples "
                         f"(default {_DEFAULT_MIN_PCT})")
    ap.add_argument("--top", type=int, default=25,
                    help="max rows in --diff output")
    args = ap.parse_args(argv)

    try:
        if args.diff:
            print(render_diff(_read(args.diff[0]), _read(args.diff[1]),
                              top=args.top))
            return 0
        if not args.path:
            ap.error("a profile path (or --diff BEFORE AFTER) is required")
        folded = _read(args.path)
        if not folded:
            print("empty profile", file=sys.stderr)
            return 1
        print(render_flame(folded, width=args.width, min_pct=args.min_pct))
    except BrokenPipeError:
        # downstream pager/head closed the pipe — the unix-tool exit, not
        # a traceback
        sys.stderr.close()
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
