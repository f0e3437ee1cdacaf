"""The run's last line, and the checks that may withhold it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (name -> ``{"value", "unit"}``),
``device`` (``platform``, ``kind``, ``count``, ``memory_peak_bytes``, the
card's power limit; with a trace also ``busy_s`` and ``window_s``),
optionally ``breakdown``, and last ``checks``: each number compared beside
its limit.  The checks are also the last lines of standard error.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Optional

__all__ = ["FORBIDDEN", "forbidden_modules", "power_limit", "device_block",
           "emit"]

#: top-level module names no run may have loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "seldon_core_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``seldon_core_tpu_torch`` is not
    ``seldon_core_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def device_block(kind: str, count: int, memory_peak_bytes: int,
                 trace: Optional[dict] = None) -> dict:
    out = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": int(memory_peak_bytes),
           "power_limit": power_limit()}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown: Optional[dict] = None,
         out=None) -> dict:
    """Print the checks on standard error, then the last line on standard
    output; returns the line's object.  ``checks``: name -> ``{"value",
    "limit"}``."""
    out = sys.stdout if out is None else out
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return line
