"""Request flight recorder: a bounded ring of per-request records.

Traces (utils/tracing.py) are *sampled* — at 1% head sampling, the
request you need to debug is usually the one that was not kept.  The
flight recorder is the always-on counterpart: every request that crosses
the gateway or the engine leaves one fixed-size record (puid, trace id,
route taken, per-node ms, status, shed/degraded/cache/batch flags) in a
ring whose memory is bounded by construction.  Records optionally carry
the request body (capped) so ``tools/replay.py`` can re-issue a captured
request against a running deployment and verify walk↔fused byte parity.

Concurrency: a single ``threading.Lock`` guards the deque; nothing
blocks or awaits under it, so the recorder is safe from both threads and
interleaved asyncio tasks (``record`` is called on every request's hot
path and must stay O(1)).

A copy of ``seldon_core_tpu/health/flightrecorder.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Optional

__all__ = [
    "FlightRecorder",
    "REQUEST_CAP_BYTES",
    "node_times_scope",
    "note_node_time",
]

#: request bodies larger than this are dropped from the record (the
#: record itself is still kept — only replay needs the body)
REQUEST_CAP_BYTES = 262144

#: per-request accumulator for node timings; the engine opens a scope in
#: ``predict`` and ``_observe`` appends into it (contextvar, so concurrent
#: requests never see each other's lists)
_NODE_TIMES: ContextVar[Optional[list]] = ContextVar(
    "flight_node_times", default=None
)


class _NodeTimesToken:
    __slots__ = ("_token",)

    def __init__(self, token):
        self._token = token

    def close(self) -> dict:
        """End the scope; returns {node: ms} in observation order."""
        times = _NODE_TIMES.get() or []
        _NODE_TIMES.reset(self._token)
        out: dict[str, float] = {}
        for name, ms in times:
            out[name] = out.get(name, 0.0) + ms
        return out


def node_times_scope() -> _NodeTimesToken:
    """Open a per-request node-timing accumulator (engine ``predict``)."""
    return _NodeTimesToken(_NODE_TIMES.set([]))


def note_node_time(name: str, ms: float) -> None:
    """Record one node's latency into the ambient scope (no-op outside)."""
    times = _NODE_TIMES.get()
    if times is not None:
        times.append((name, ms))


class FlightRecorder:
    """Bounded ring buffer of per-request records (plain dicts)."""

    def __init__(self, capacity: int = 1024, service: str = "",
                 metrics=None, replica: str = ""):
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be > 0")
        self.capacity = int(capacity)
        self.service = service
        self.metrics = metrics
        #: replica identity stamped on every record (fleet observability:
        #: merged views key records by replica; settable post-construction
        #: by the harness/engine once the rid is known)
        self.replica = replica
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0

    # -- write ----------------------------------------------------------
    def record(
        self,
        *,
        puid: str = "",
        trace_id: str = "",
        deployment: str = "",
        route: tuple = (),
        node_ms: Optional[dict] = None,
        status: int = 200,
        reason: str = "",
        duration_ms: float = 0.0,
        flags: Optional[dict] = None,
        request: Optional[dict] = None,
        request_bytes: int = 0,
        replica: str = "",
    ) -> dict:
        """Append one record; O(1), never raises on the hot path."""
        truncated = request_bytes > REQUEST_CAP_BYTES
        rec = {
            "ts": time.time(),
            "service": self.service,
            "replica": replica or self.replica,
            "puid": puid,
            "traceId": trace_id,
            "deployment": deployment,
            "route": list(route),
            "nodeMs": dict(node_ms or {}),
            "status": int(status),
            "reason": reason,
            "durationMs": round(float(duration_ms), 3),
            "flags": dict(flags or {}),
            "request": None if truncated else request,
            "requestTruncated": truncated,
        }
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
            recorded, size = self._recorded, len(self._ring)
        if self.metrics is not None:
            try:
                labels = {"service": self.service or "engine"}
                self.metrics.gauge_set(
                    "seldon_flightrecorder_records", size, labels)
                self.metrics.gauge_set(
                    "seldon_flightrecorder_recorded", recorded, labels)
            except Exception:
                pass
        return rec

    # -- query ----------------------------------------------------------
    def query(
        self,
        deployment: Optional[str] = None,
        status: Optional[int] = None,
        puid: Optional[str] = None,
        min_ms: Optional[float] = None,
        errors_only: bool = False,
        replica: Optional[str] = None,
        n: int = 50,
    ) -> list[dict]:
        """Newest-first filtered view (same filter surface as
        ``/admin/traces``)."""
        with self._lock:
            records = list(self._ring)
        out = []
        for rec in reversed(records):
            if deployment is not None and rec["deployment"] != deployment:
                continue
            if replica is not None and rec.get("replica") != replica:
                continue
            if status is not None and rec["status"] != status:
                continue
            if puid is not None and rec["puid"] != puid:
                continue
            if min_ms is not None and rec["durationMs"] < min_ms:
                continue
            if errors_only and rec["status"] < 400:
                continue
            out.append(rec)
            if len(out) >= n:
                break
        return out

    def get(self, puid: str) -> Optional[dict]:
        """Most recent record for a puid, or None."""
        hits = self.query(puid=puid, n=1)
        return hits[0] if hits else None

    def stats(self) -> dict:
        with self._lock:
            size, recorded = len(self._ring), self._recorded
        return {
            "capacity": self.capacity,
            "size": size,
            "recorded": recorded,
            "dropped": max(0, recorded - size),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
