"""Fleet observability plane: cross-replica aggregation + differential
analysis (docs/observability.md#fleet-observability).

The replica pool spreads a deployment over engines; this module rebuilds
the *central* view the reference platform's orchestrator had (PAPER.md
§1, §5.8) at N>1 replicas.  Three layers, all off the data path:

1. **Scatter-gather scraper** — a bounded-concurrency fan-out over the
   replicas' own admin endpoints (``/admin/health``,
   ``/admin/flightrecorder``, ``/admin/profile[...]``, ``/trace``) with
   a per-replica timeout.  A dead replica becomes
   ``{"unreachable": true}`` inside a ``partial: true`` envelope — a
   scrape must never 500, and it never touches the serving path.
2. **Mergers** — per-endpoint composers that stamp a stable ``replica``
   key on every record, stitch a trace id's gateway hop spans together
   with each replica's server spans, and sum per-replica capacity into
   a fleet total.
3. **Differential analysis** — per-replica latency / error / compile-
   ledger skew scored against the fleet median with a MAD-based outlier
   threshold (robust to one bad replica polluting the baseline, the
   same trick straggler detection in training fleets uses).  Outliers
   raise ``straggler`` / ``compile-skew`` signals naming the replica,
   fused into a fleet-level verdict, exported as ``seldon_fleet_obs_*``
   gauges, and fed back to the :class:`~seldon_core_tpu_torch.fleet.pool.
   ReplicaPool` as a soft routing penalty.

Every autoscale decision and every pool ejection/readmission also lands
in a bounded :class:`DecisionAudit` ring (``/admin/fleet/decisions``) so
a ``spec.replicas`` patch or a 3am ejection is explainable after the
fact.  The ring is process-local (one per gateway / engine / operator
process), mirroring ``fleet/registry.py``'s posture.

Annotations (validated at admission + graphlint GL14xx)::

    seldon.io/fleet-obs-interval-ms: "2000"   # health-scrape cache TTL
    seldon.io/fleet-obs-timeout-ms:  "1500"   # per-replica scrape budget
    seldon.io/fleet-obs-concurrency: "8"      # scatter-gather width
    seldon.io/fleet-obs-mad-k:       "3.5"    # outlier threshold (MADs)
    seldon.io/fleet-obs-audit:       "256"    # decision-ring capacity

Port of ``seldon_core_tpu/fleet/observe.py``: the same envelopes, signals,
gauges and audit records.  The scatter-gather runs on the port's
``serving/client.py`` :class:`HttpSession` where the reference's runs on an
aiohttp session; a dead replica's ``error`` names the port's exception
class (``ConnectError``) beside the same message.
"""

from __future__ import annotations

import asyncio
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

__all__ = [
    "OBS_INTERVAL_ANNOTATION",
    "OBS_TIMEOUT_ANNOTATION",
    "OBS_CONCURRENCY_ANNOTATION",
    "OBS_MAD_K_ANNOTATION",
    "OBS_AUDIT_ANNOTATION",
    "ObserveConfig",
    "observe_config_from_annotations",
    "DecisionAudit",
    "decision_audit",
    "record_decision",
    "skew_scores",
    "detect_outliers",
    "flatten_spans",
    "FleetObserver",
    "fleet_obs_body",
    "decisions_body",
    "OBS_DISABLED",
]

OBS_INTERVAL_ANNOTATION = "seldon.io/fleet-obs-interval-ms"
OBS_TIMEOUT_ANNOTATION = "seldon.io/fleet-obs-timeout-ms"
OBS_CONCURRENCY_ANNOTATION = "seldon.io/fleet-obs-concurrency"
OBS_MAD_K_ANNOTATION = "seldon.io/fleet-obs-mad-k"
OBS_AUDIT_ANNOTATION = "seldon.io/fleet-obs-audit"

#: a robust z-score threshold: 1.4826 * MAD estimates one standard
#: deviation for normal data, so this reads "more than ~3.5 sigma slower
#: than the fleet median"
DEFAULT_MAD_K = 3.5

#: a replica needs this many flight records before its latency median
#: participates in skew scoring (two requests are not a distribution)
MIN_LATENCY_SAMPLES = 5

_VERDICT_GAUGE = "seldon_fleet_obs_verdict"
_SKEW_GAUGE = "seldon_fleet_obs_skew"
_STRAGGLER_GAUGE = "seldon_fleet_obs_straggler"
_UNREACHABLE_GAUGE = "seldon_fleet_obs_unreachable"
_SCRAPE_HIST = "seldon_fleet_obs_scrape_seconds"


@dataclass(frozen=True)
class ObserveConfig:
    #: fleet-health scrape results are cached this long (ms); 0 disables
    #: the cache (every request re-scrapes)
    interval_ms: float = 2000.0
    #: per-replica scrape budget — a slow replica delays only itself
    timeout_ms: float = 1500.0
    #: scatter-gather width (how many replicas are scraped at once)
    concurrency: int = 8
    #: MAD multiples past the fleet median before a replica is an outlier
    mad_k: float = DEFAULT_MAD_K
    #: decision audit ring capacity
    audit_capacity: int = 256

    @property
    def knobs_set(self) -> bool:
        """Any non-default knob present (graphlint dead-knob check)."""
        return self != ObserveConfig()


def _parse_pos_float(raw, name: str, at: str, minimum: float) -> float:
    try:
        v = float(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(f"{name}{at}: {raw!r} is not a number") from None
    if v < minimum:
        raise ValueError(f"{name}{at}: {v:g} must be >= {minimum:g}")
    return v


def _parse_pos_int(raw, name: str, at: str) -> int:
    try:
        n = int(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(f"{name}{at}: {raw!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{name}{at}: {n} must be >= 1")
    return n


def observe_config_from_annotations(ann: Mapping,
                                    where: str = "") -> ObserveConfig:
    """Parse + validate the ``seldon.io/fleet-obs-*`` family; raises
    ``ValueError`` with a path-prefixed, annotation-name-bearing message
    on any malformed knob."""
    at = f" at {where}" if where else ""
    kw: dict = {}
    raw = ann.get(OBS_INTERVAL_ANNOTATION)
    if raw is not None:
        kw["interval_ms"] = _parse_pos_float(
            raw, OBS_INTERVAL_ANNOTATION, at, 0.0)
    raw = ann.get(OBS_TIMEOUT_ANNOTATION)
    if raw is not None:
        kw["timeout_ms"] = _parse_pos_float(
            raw, OBS_TIMEOUT_ANNOTATION, at, 1.0)
    raw = ann.get(OBS_CONCURRENCY_ANNOTATION)
    if raw is not None:
        kw["concurrency"] = _parse_pos_int(raw, OBS_CONCURRENCY_ANNOTATION, at)
    raw = ann.get(OBS_MAD_K_ANNOTATION)
    if raw is not None:
        kw["mad_k"] = _parse_pos_float(raw, OBS_MAD_K_ANNOTATION, at, 0.1)
    raw = ann.get(OBS_AUDIT_ANNOTATION)
    if raw is not None:
        kw["audit_capacity"] = _parse_pos_int(raw, OBS_AUDIT_ANNOTATION, at)
    return ObserveConfig(**kw)


# ---------------------------------------------------------------------------
# decision audit ring
# ---------------------------------------------------------------------------

class DecisionAudit:
    """Bounded ring of fleet control decisions (autoscale patches,
    ejections, readmissions) — the "why is the fleet shaped like this"
    black box.  O(1) writes off a single lock; never raises on the
    recording path."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("decision audit capacity must be > 0")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0

    def resize(self, capacity: int) -> None:
        """Grow/shrink the ring, keeping the newest records."""
        capacity = int(capacity)
        if capacity <= 0 or capacity == self.capacity:
            return
        with self._lock:
            self.capacity = capacity
            self._ring = deque(self._ring, maxlen=capacity)

    def record(self, kind: str, *, deployment: str = "", replica: str = "",
               reason: str = "", **details) -> dict:
        """Append one decision; ``kind`` is e.g. ``autoscale`` /
        ``eject`` / ``readmit``."""
        rec = {
            "ts": time.time(),
            "kind": kind,
            "deployment": deployment,
            "replica": replica,
            "reason": reason,
        }
        for key, value in details.items():
            if value is not None:
                rec[key] = value
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
        return rec

    def query(self, kind: Optional[str] = None,
              deployment: Optional[str] = None,
              replica: Optional[str] = None, n: int = 50) -> list:
        """Newest-first filtered view."""
        with self._lock:
            records = list(self._ring)
        out = []
        for rec in reversed(records):
            if kind is not None and rec["kind"] != kind:
                continue
            if deployment is not None and rec["deployment"] != deployment:
                continue
            if replica is not None and rec["replica"] != replica:
                continue
            out.append(rec)
            if len(out) >= n:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            size, recorded = len(self._ring), self._recorded
        return {"capacity": self.capacity, "size": size,
                "recorded": recorded, "dropped": max(0, recorded - size)}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: process-default ring: the gateway's pools, the operator's autoscale
#: loop, and the local harness all record here unless handed their own
_DEFAULT_AUDIT = DecisionAudit()


def decision_audit() -> DecisionAudit:
    """The process-default decision audit ring."""
    return _DEFAULT_AUDIT


def record_decision(kind: str, **kw) -> dict:
    """Record into the process-default ring (never raises)."""
    try:
        return _DEFAULT_AUDIT.record(kind, **kw)
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# differential analysis (pure functions — property-tested)
# ---------------------------------------------------------------------------

def skew_scores(values: Mapping[str, float]) -> dict:
    """Robust z-score per replica against the fleet median.

    Scale is ``1.4826 * MAD`` (the normal-consistent MAD), floored at
    10% of the median magnitude: a tight fleet's MAD can be arbitrarily
    small, and without the floor a 0.5% wobble scores as an outlier.
    With it, a replica must diverge by whole-fleet fractions (not
    measurement noise) to flag — a near-uniform fleet scores ~0
    everywhere while a 10x straggler still stands out.  Fewer than 2
    replicas cannot skew."""
    if len(values) < 2:
        return {rid: 0.0 for rid in values}
    vals = [float(v) for v in values.values()]
    med = statistics.median(vals)
    mad = statistics.median([abs(v - med) for v in vals])
    scale = max(1.4826 * mad, 0.1 * abs(med), 1e-9)
    return {rid: (float(v) - med) / scale for rid, v in values.items()}


def detect_outliers(values: Mapping[str, float], *,
                    mad_k: float = DEFAULT_MAD_K,
                    signal: str = "straggler",
                    dimension: str = "latency") -> list:
    """MAD-outlier signals for replicas scoring above ``mad_k``.

    Only the HIGH side is flagged — a replica faster / quieter than the
    fleet is not a defect.  Returns one signal dict per outlier, each
    naming the replica (that name is the whole point: "the fleet is
    slow" is not actionable, "r2 is slow" is)."""
    med = statistics.median([float(v) for v in values.values()]) \
        if values else 0.0
    out = []
    for rid, score in sorted(skew_scores(values).items()):
        if score > mad_k:
            out.append({
                "signal": signal,
                "replica": rid,
                "dimension": dimension,
                "score": round(score, 2),
                "value": round(float(values[rid]), 3),
                "fleetMedian": round(med, 3),
            })
    return out


def flatten_spans(root: Optional[dict], replica: str = "") -> list:
    """Flatten a ``Span.to_dict`` tree into a span list, stamping
    ``replica`` on every span (stitching key for merged traces)."""
    out: list = []
    stack = [root] if isinstance(root, dict) else []
    while stack:
        span = stack.pop()
        flat = {k: v for k, v in span.items() if k != "children"}
        if replica:
            flat["replica"] = replica
        out.append(flat)
        stack.extend(c for c in span.get("children", ())
                     if isinstance(c, dict))
    return out


def _latency_median(records: Sequence[dict]) -> Optional[float]:
    """Median durationMs over a replica's flight records, or None below
    the sample floor."""
    samples = [float(r.get("durationMs", 0.0)) for r in records]
    if len(samples) < MIN_LATENCY_SAMPLES:
        return None
    return statistics.median(samples)


def _error_rate(records: Sequence[dict]) -> Optional[float]:
    if not records:
        return None
    errors = sum(1 for r in records if int(r.get("status", 0)) >= 500)
    return errors / len(records)


def _compile_total(payload: Mapping) -> Optional[float]:
    """Total compiles from an ``/admin/profile/compile`` payload."""
    segments = payload.get("segments")
    if not isinstance(segments, dict):
        return None
    return float(sum(int(seg.get("compiles", 0))
                     for seg in segments.values()
                     if isinstance(seg, dict)))


# ---------------------------------------------------------------------------
# scatter-gather + mergers
# ---------------------------------------------------------------------------

class FleetObserver:
    """Cross-replica scraper + differential analyzer.

    One per gateway (all pools) or per local harness.  Holds no
    connection state of its own: callers pass the ``HttpSession`` and
    the ``(replica, url)`` target list, so the gateway reuses its
    forwarding session and the engine-side harness its probe session.
    """

    def __init__(self, config: Optional[ObserveConfig] = None,
                 metrics=None, audit: Optional[DecisionAudit] = None,
                 clock=time.monotonic):
        self.config = config or ObserveConfig()
        self.metrics = metrics
        self.audit = audit if audit is not None else decision_audit()
        if audit is None:
            # annotation-configured capacity applies to the shared ring
            self.audit.resize(self.config.audit_capacity)
        self._clock = clock
        #: deployment → (monotonic ts, fleet-health payload) cache;
        #: bounds scrape overhead to one fan-out per interval
        self._health_cache: dict = {}
        self._lock = threading.Lock()

    # -- scatter-gather -------------------------------------------------
    async def scrape(self, session, targets: Sequence[Tuple[str, str]],
                     path: str, params: Optional[Mapping] = None,
                     endpoint: str = "") -> dict:
        """Bounded-concurrency GET fan-out over ``(replica, url)`` on
        ``session`` (an ``HttpSession``).

        Never raises: a replica that times out, refuses, or answers
        garbage becomes ``{"unreachable": true, "error": ...}`` and the
        envelope gets ``partial: true``.  Non-200 answers (e.g. a plane
        disabled on one replica) are kept — the body explains itself —
        with the status in ``statuses``."""
        sem = asyncio.Semaphore(max(1, int(self.config.concurrency)))
        timeout_s = max(0.001, self.config.timeout_ms / 1000.0)
        t0 = time.perf_counter()

        async def one(rid: str, url: str):
            async with sem:
                try:
                    status, body = await session.get_json(
                        url.rstrip("/") + path, params=dict(params or {}),
                        timeout_s=timeout_s)
                    if not isinstance(body, dict):
                        body = {"body": body}
                    return rid, status, body
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    return rid, 0, {
                        "unreachable": True,
                        "error": f"{type(e).__name__}: {e}",
                    }

        # one() converts every failure into an unreachable-replica dict,
        # so the gather cannot raise
        results = await asyncio.gather(  # graphlint: disable=RL605
            *(one(rid, url) for rid, url in targets))
        replicas: dict = {}
        statuses: dict = {}
        unreachable: list = []
        for rid, status, body in results:
            replicas[rid] = body
            statuses[rid] = status
            if status == 0:
                unreachable.append(rid)
        elapsed = time.perf_counter() - t0
        self._observe_scrape(endpoint or path, elapsed)
        return {
            "replicas": replicas,
            "statuses": statuses,
            "unreachable": sorted(unreachable),
            "partial": bool(unreachable),
            "scrapeMs": round(elapsed * 1000.0, 3),
        }

    def _observe_scrape(self, endpoint: str, seconds: float) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.observe(_SCRAPE_HIST, seconds,
                                 {"endpoint": endpoint})
        except Exception:
            pass

    # -- simple mergers -------------------------------------------------
    @staticmethod
    def merge_flightrecorder(scrape: dict) -> dict:
        """Flatten per-replica flight records into one newest-first list,
        each record stamped with its ``replica``."""
        records: list = []
        for rid, payload in scrape["replicas"].items():
            for rec in payload.get("records", ()):
                if isinstance(rec, dict):
                    records.append({**rec, "replica": rec.get("replica")
                                    or rid})
        records.sort(key=lambda r: r.get("ts", 0.0), reverse=True)
        return {
            "records": records,
            "replicas": scrape["replicas"],
            "unreachable": scrape["unreachable"],
            "partial": scrape["partial"],
        }

    @staticmethod
    def merge_capacity(scrape: dict) -> dict:
        """Sum per-replica capacity estimates into a fleet total (every
        numeric key is summed — the fleet's achievable RPS is the sum of
        its members')."""
        fleet: dict = {}
        per_replica: dict = {}
        for rid, payload in scrape["replicas"].items():
            if payload.get("unreachable"):
                per_replica[rid] = payload
                continue
            per_replica[rid] = payload
            for key, value in payload.items():
                if isinstance(value, bool) or not isinstance(
                        value, (int, float)):
                    continue
                fleet[key] = fleet.get(key, 0.0) + float(value)
        return {
            "fleet": {k: round(v, 6) for k, v in sorted(fleet.items())},
            "replicas": per_replica,
            "unreachable": scrape["unreachable"],
            "partial": scrape["partial"],
        }

    @staticmethod
    def merge_profile(scrape: dict) -> dict:
        """Per-replica host profiles plus a fleet-combined collapsed
        profile (concatenating collapsed stacks sums their counts, so
        the combined text renders directly in ``tools/profview`` and
        any two replicas diff with ``profview --diff fleet.json#r0
        fleet.json#r1``)."""
        combined: dict = {}
        for rid, payload in scrape["replicas"].items():
            folded = payload.get("folded")
            if not isinstance(folded, str):
                continue
            for line in folded.splitlines():
                stack, _, count = line.strip().rpartition(" ")
                if not stack:
                    continue
                try:
                    combined[stack] = combined.get(stack, 0) + int(count)
                except ValueError:
                    continue
        return {
            "folded": "\n".join(f"{stack} {count}"
                                for stack, count in sorted(combined.items())),
            "replicas": scrape["replicas"],
            "unreachable": scrape["unreachable"],
            "partial": scrape["partial"],
        }

    # -- trace stitching ------------------------------------------------
    @staticmethod
    def merge_traces(scrape: dict, gateway_records: Sequence[dict] = (),
                     trace_id: str = "") -> dict:
        """Stitch gateway trace records with each replica's server spans.

        With ``trace_id`` the result is ONE journey: the gateway root
        (whose ``hop`` children narrate every attempt, including
        connect-failed ones with their ``eject_reason``) plus the server
        spans of every replica that actually served — flattened into
        ``spans`` with a ``replica`` key, with ``hops`` and
        ``replicasInvolved`` extracted for direct assertion."""
        spans: list = []
        replica_traces: dict = {}
        for rec in gateway_records:
            spans.extend(flatten_spans(rec.get("root"),
                                       rec.get("replica") or "gateway"))
        for rid, payload in scrape["replicas"].items():
            recs = payload.get("traces")
            if not isinstance(recs, list):
                continue
            kept = []
            for rec in recs:
                if trace_id and rec.get("trace_id") != trace_id:
                    continue
                kept.append(rec)
                # collector records carry the tree under "root";
                # tracer.recent() items ARE the tree
                root = rec.get("root") or (rec if "name" in rec else None)
                spans.extend(flatten_spans(root, rid))
            if kept:
                replica_traces[rid] = kept
        hops = [s for s in spans if s.get("kind") == "hop"]
        involved = sorted(
            {h.get("attributes", {}).get("replica") for h in hops
             if h.get("attributes", {}).get("replica")}
            | set(replica_traces)
        )
        out = {
            "gateway": list(gateway_records),
            "replicas": replica_traces,
            "spans": spans,
            "hops": hops,
            "replicasInvolved": involved,
            "unreachable": scrape["unreachable"],
            "partial": scrape["partial"],
        }
        if trace_id:
            out["traceId"] = trace_id
        return out

    # -- fleet health (differential analysis) ---------------------------
    async def fleet_health(self, session,
                           targets: Sequence[Tuple[str, str]],
                           deployment: str = "", pool=None,
                           refresh: bool = False) -> dict:
        """The fleet-level verdict: every replica's own health verdict,
        plus latency / error / compile-ledger skew scored against the
        fleet median.  Cached for ``interval_ms`` per deployment so the
        admin surface cannot stampede the fleet; ``refresh=True``
        bypasses the cache."""
        now = self._clock()
        ttl = self.config.interval_ms / 1000.0
        if not refresh and ttl > 0:
            with self._lock:
                cached = self._health_cache.get(deployment)
            if cached is not None and now - cached[0] < ttl:
                return {**cached[1], "cached": True}
        # scrape() returns error-shaped payloads instead of raising, so
        # fail-fast here is unreachable
        health, flights, compiles = await asyncio.gather(
            # graphlint: disable=RL605
            self.scrape(session, targets, "/admin/health",
                        endpoint="health"),
            self.scrape(session, targets, "/admin/flightrecorder",
                        params={"n": "100"}, endpoint="flightrecorder"),
            self.scrape(session, targets, "/admin/profile/compile",
                        endpoint="compile"),
        )
        payload = self._analyze(health, flights, compiles, deployment)
        if pool is not None:
            self._feed_pool(pool, dict(targets), payload)
        self._export(deployment, payload)
        with self._lock:
            self._health_cache[deployment] = (now, payload)
        return payload

    def _analyze(self, health: dict, flights: dict, compiles: dict,
                 deployment: str) -> dict:
        latency: dict = {}
        errors: dict = {}
        compile_totals: dict = {}
        replicas: dict = {}
        level = 0
        for rid, verdict in health["replicas"].items():
            if verdict.get("unreachable"):
                replicas[rid] = {"unreachable": True,
                                 "error": verdict.get("error", "")}
                continue
            rep_level = int(verdict.get("level", 0))
            level = max(level, rep_level)
            replicas[rid] = {
                "verdict": verdict.get("verdict", "ok"),
                "level": rep_level,
                "signals": list(verdict.get("signals", ())),
            }
            records = (flights["replicas"].get(rid) or {}).get("records")
            if isinstance(records, list):
                lat = _latency_median(records)
                if lat is not None:
                    latency[rid] = lat
                    replicas[rid]["latencyMs"] = round(lat, 3)
                err = _error_rate(records)
                if err is not None:
                    errors[rid] = err
                    replicas[rid]["errorRate"] = round(err, 4)
            total = _compile_total(compiles["replicas"].get(rid) or {})
            if total is not None:
                compile_totals[rid] = total
                replicas[rid]["compiles"] = int(total)
        mad_k = self.config.mad_k
        signals = (
            detect_outliers(latency, mad_k=mad_k,
                            signal="straggler", dimension="latency")
            + detect_outliers(errors, mad_k=mad_k,
                              signal="straggler", dimension="errors")
            + detect_outliers(compile_totals, mad_k=mad_k,
                              signal="compile-skew", dimension="compile")
        )
        unreachable = sorted(set(health["unreachable"])
                             | set(flights["unreachable"]))
        partial = bool(unreachable)
        if signals or partial:
            level = max(level, 1)
        return {
            "deployment": deployment,
            "verdict": ("ok", "warn", "critical")[min(level, 2)],
            "level": min(level, 2),
            "signals": signals,
            "replicas": replicas,
            "skew": {
                "latency": {r: round(s, 2)
                            for r, s in skew_scores(latency).items()},
                "errors": {r: round(s, 2)
                           for r, s in skew_scores(errors).items()},
                "compile": {r: round(s, 2)
                            for r, s in skew_scores(compile_totals).items()},
            },
            "madK": mad_k,
            "unreachable": unreachable,
            "partial": partial,
        }

    def _feed_pool(self, pool, urls: Mapping[str, str],
                   payload: dict) -> None:
        """Straggler scores become a soft routing penalty: the policy's
        load score is multiplied by ``1 + penalty``, steering (not
        slamming) traffic away from the outlier until it recovers."""
        straggling = {s["replica"]: s["score"] for s in payload["signals"]
                      if s["signal"] == "straggler"}
        note = getattr(pool, "note_penalty", None)
        if note is None:
            return
        for rid, url in urls.items():
            score = straggling.get(rid, 0.0)
            penalty = min(score / max(self.config.mad_k, 0.1), 4.0) \
                if score else 0.0
            try:
                note(url, penalty)
            except Exception:
                pass

    def _export(self, deployment: str, payload: dict) -> None:
        if self.metrics is None:
            return
        try:
            dep = {"deployment": deployment or "fleet"}
            self.metrics.gauge_set(_VERDICT_GAUGE, payload["level"], dep)
            self.metrics.gauge_set(
                _UNREACHABLE_GAUGE, len(payload["unreachable"]), dep)
            stragglers = {s["replica"] for s in payload["signals"]
                          if s["signal"] == "straggler"}
            for dimension, scores in payload["skew"].items():
                for rid, score in scores.items():
                    self.metrics.gauge_set(
                        _SKEW_GAUGE, score,
                        {**dep, "replica": rid, "dimension": dimension})
            for rid in payload["replicas"]:
                self.metrics.gauge_set(
                    _STRAGGLER_GAUGE, 1.0 if rid in stragglers else 0.0,
                    {**dep, "replica": rid})
        except Exception:
            pass


# ---------------------------------------------------------------------------
# shared endpoint bodies (gateway/app.py AND serving/rest.py wrap these)
# ---------------------------------------------------------------------------

OBS_DISABLED = {
    "error": "fleet observability unavailable",
    "hint": 'needs a replica set: run a fleet (seldon.io/fleet-replicas: '
            '"3") — the gateway aggregates its pooled deployments, the '
            "engine its LocalFleet harness; tune with the "
            "seldon.io/fleet-obs-* annotations",
}


def decisions_body(audit: DecisionAudit, query: Mapping) -> Tuple[int, dict]:
    """``/admin/fleet/decisions``: the bounded autoscale / ejection /
    readmission audit ring (``?kind= ?deployment= ?replica= ?n=``).
    Served even with no fleet running — the process-default ring exists
    either way and an empty answer is still an answer."""
    n = int(query.get("n", 50))
    return 200, {
        "decisions": audit.query(
            kind=query.get("kind"), deployment=query.get("deployment"),
            replica=query.get("replica"), n=n,
        ),
        "stats": audit.stats(),
    }


async def fleet_obs_body(observer: FleetObserver, session,
                         targets: Sequence[Tuple[str, str]], kind: str,
                         query: Mapping, *, deployment: str = "",
                         pool=None,
                         gateway_records: Sequence[dict] = ()
                         ) -> Tuple[int, dict]:
    """Dispatch one ``/admin/fleet/{kind}`` aggregation request.

    Returns ``(status, payload)`` like the other shared admin bodies;
    malformed numeric params raise ``ValueError`` (callers map to 400).
    A scrape result is never a 500: dead replicas are inside the
    envelope, not an error."""
    if kind == "health":
        refresh = str(query.get("refresh", "")).lower() in ("1", "true",
                                                            "yes")
        return 200, await observer.fleet_health(
            session, targets, deployment=deployment, pool=pool,
            refresh=refresh,
        )
    if kind == "traces":
        trace_id = query.get("trace_id", "")
        params = {"n": str(int(query.get("n", 20)))}
        if trace_id:
            params["trace_id"] = trace_id
        if query.get("replica"):
            params["replica"] = query["replica"]
        scrape = await observer.scrape(session, targets, "/trace",
                                       params=params, endpoint="traces")
        return 200, observer.merge_traces(
            scrape, gateway_records=gateway_records, trace_id=trace_id)
    if kind == "flightrecorder":
        params = {"n": str(int(query.get("n", 50)))}
        for key in ("deployment", "status", "puid", "min_ms",
                    "errors_only", "replica"):
            if query.get(key):
                params[key] = query[key]
        scrape = await observer.scrape(
            session, targets, "/admin/flightrecorder", params=params,
            endpoint="flightrecorder")
        return 200, observer.merge_flightrecorder(scrape)
    if kind == "profile":
        params = {}
        if query.get("n"):
            params["n"] = str(int(query["n"]))
        scrape = await observer.scrape(session, targets, "/admin/profile",
                                       params=params, endpoint="profile")
        return 200, observer.merge_profile(scrape)
    if kind == "capacity":
        scrape = await observer.scrape(
            session, targets, "/admin/profile/capacity",
            endpoint="capacity")
        return 200, observer.merge_capacity(scrape)
    return 404, {"error": f"unknown fleet endpoint {kind!r}"}
