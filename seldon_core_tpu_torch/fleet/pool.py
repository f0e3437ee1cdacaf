"""Replica pool: health-gated membership + load accounting for one
deployment's engine fleet.

The gateway keeps one :class:`ReplicaPool` per deployment (rebuilt when
the ``seldon.io/fleet-*`` annotations or the member URL list change —
the ``_dep_cache`` idiom).  Membership comes from the deployment record
(the reconcile loop's view of the engine Service endpoints); health
gating is local: a replica whose ``/admin/health`` verdict goes critical,
whose breakers open, or whose connections fail is EJECTED and re-probed
half-open-style — after ``reprobe_s`` it becomes PROBING and one trial
request (or one successful health probe) readmits it.

Load accounting feeds the least-loaded policy: live in-flight count plus
an EWMA of it (so a slow replica's backlog outlives individual requests)
divided by the capacity headroom the engine publishes at
``/admin/profile/capacity``.

Port of ``seldon_core_tpu/fleet/pool.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from seldon_core_tpu_torch.fleet.config import FleetConfig
from seldon_core_tpu_torch.fleet.observe import record_decision
from seldon_core_tpu_torch.fleet.ring import HashRing

__all__ = ["Replica", "ReplicaPool", "HEALTHY", "EJECTED", "PROBING"]

HEALTHY = "healthy"
EJECTED = "ejected"
PROBING = "probing"


@dataclass
class Replica:
    rid: str
    url: str
    state: str = HEALTHY
    inflight: int = 0
    ewma_inflight: float = 0.0
    forwards: int = 0
    failures: int = 0
    ejections: int = 0
    ejected_at: float = 0.0
    eject_reason: str = ""
    #: last health verdict string seen for this replica ("" = never probed)
    verdict: str = ""
    #: capacity headroom in [0, 1] from /admin/profile/capacity (None =
    #: the engine's profiling plane is off / not yet read)
    headroom: Optional[float] = None
    #: soft routing penalty from the fleet observer's straggler scoring
    #: (policy multiplies the load score by 1 + penalty; 0 = no skew)
    penalty: float = 0.0
    #: EWMA of observed per-request latency at the gateway (ms) — the
    #: transport-inclusive skew signal the observer scores replicas on
    ewma_ms: float = 0.0

    def snapshot(self) -> dict:
        out = {
            "replica": self.rid,
            "url": self.url,
            "state": self.state,
            "inflight": self.inflight,
            "ewmaInflight": round(self.ewma_inflight, 3),
            "forwards": self.forwards,
            "failures": self.failures,
            "ejections": self.ejections,
        }
        if self.penalty:
            out["penalty"] = round(self.penalty, 3)
        if self.ewma_ms:
            out["ewmaMs"] = round(self.ewma_ms, 3)
        if self.eject_reason:
            out["ejectReason"] = self.eject_reason
        if self.verdict:
            out["verdict"] = self.verdict
        if self.headroom is not None:
            out["headroom"] = round(self.headroom, 4)
        return out


class ReplicaPool:
    """Thread-safe (the gateway event loop + metrics scrapers both read)."""

    def __init__(
        self,
        deployment: str,
        config: Optional[FleetConfig] = None,
        members=(),
        metrics=None,
        reprobe_s: float = 2.0,
        ewma_alpha: float = 0.3,
        clock=time.monotonic,
    ):
        self.deployment = deployment
        self.config = config or FleetConfig(enabled=True)
        self.metrics = metrics
        self.reprobe_s = reprobe_s
        self.ewma_alpha = ewma_alpha
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}  # url -> Replica
        self._rid_seq = 0
        self._rr = 0  # round-robin cursor
        self.ring = HashRing(vnodes=64)
        #: session-affinity map: session key -> replica url (SSE streams)
        self._sessions: dict[str, str] = {}
        self._last_probe = 0.0
        if members:
            self.set_members(members)

    # -- membership -----------------------------------------------------
    def set_members(self, urls) -> None:
        """Reconcile the member set to ``urls`` (order-insensitive).
        Existing replicas keep their stats and state; the ring only moves
        the arcs of added/removed members."""
        with self._lock:
            want = list(dict.fromkeys(urls))  # dedupe, keep order
            for url in want:
                if url not in self._replicas:
                    rid = f"r{self._rid_seq}"
                    self._rid_seq += 1
                    self._replicas[url] = Replica(rid=rid, url=url)
                    self.ring.add(url)
            for url in list(self._replicas):
                if url not in want:
                    del self._replicas[url]
                    self.ring.remove(url)
            for sess, url in list(self._sessions.items()):
                if url not in self._replicas:
                    del self._sessions[sess]
        self._emit_state_gauge()

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def by_url(self, url: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(url)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- routing --------------------------------------------------------
    def pick(self, key: Optional[str] = None, session: Optional[str] = None,
             exclude=()) -> Optional[Replica]:
        """Choose a replica under the configured policy.  ``exclude`` is
        the retry path's set of already-failed URLs; ``key`` the content-
        addressed cache key (consistent-hash); ``session`` the affinity
        key for SSE streams.  Falls back across state tiers: healthy →
        probing (half-open trial traffic) → ejected (last resort — one
        desperate attempt beats an unconditional 503)."""
        from seldon_core_tpu_torch.fleet.policy import pick_replica

        with self._lock:
            self._advance_probes_locked()
            return pick_replica(self, key=key, session=session,
                                exclude=set(exclude))

    # -- load accounting -------------------------------------------------
    def acquire(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight += 1

    def release(self, replica: Replica, ok: bool,
                latency_ms: Optional[float] = None) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)
            a = self.ewma_alpha
            replica.ewma_inflight = (
                (1 - a) * replica.ewma_inflight + a * replica.inflight
            )
            if latency_ms is not None:
                replica.ewma_ms = (
                    latency_ms if replica.ewma_ms == 0.0
                    else (1 - a) * replica.ewma_ms + a * latency_ms
                )
            readmitted = False
            if ok:
                replica.forwards += 1
                if replica.state == PROBING:
                    # half-open trial succeeded → readmit
                    replica.state = HEALTHY
                    replica.eject_reason = ""
                    readmitted = True
            else:
                replica.failures += 1
        if readmitted:
            record_decision("readmit", deployment=self.deployment,
                            replica=replica.rid, url=replica.url,
                            reason="half-open trial succeeded")
        if ok and self.metrics is not None:
            self.metrics.counter_inc(
                "seldon_fleet_forwards_total",
                {"deployment": self.deployment, "replica": replica.rid},
            )
        if ok:
            self._emit_state_gauge()

    # -- health gating ---------------------------------------------------
    def eject(self, replica: Replica, reason: str) -> None:
        with self._lock:
            first = replica.state != EJECTED
            replica.state = EJECTED
            replica.ejected_at = self._clock()
            replica.eject_reason = reason
            if first:
                replica.ejections += 1
            # affinity must not pin sessions to a dead replica
            for sess, url in list(self._sessions.items()):
                if url == replica.url:
                    del self._sessions[sess]
        if first and self.metrics is not None:
            self.metrics.counter_inc(
                "seldon_fleet_ejections_total",
                {"deployment": self.deployment, "replica": replica.rid,
                 "reason": reason},
            )
        if first:
            # every ejection is explainable after the fact
            # (/admin/fleet/decisions; fleet/observe.py DecisionAudit)
            record_decision("eject", deployment=self.deployment,
                            replica=replica.rid, reason=reason,
                            url=replica.url, ejections=replica.ejections)
        self._emit_state_gauge()

    def readmit(self, replica: Replica) -> None:
        with self._lock:
            was_out = replica.state != HEALTHY
            replica.state = HEALTHY
            replica.eject_reason = ""
        if was_out:
            record_decision("readmit", deployment=self.deployment,
                            replica=replica.rid, url=replica.url)
        self._emit_state_gauge()

    def note_verdict(self, url: str, verdict: str,
                     open_breakers=()) -> None:
        """Feed a replica's ``/admin/health`` verdict into membership:
        ``critical`` (or any open breaker) ejects; ``ok`` readmits a
        probing replica (the half-open probe succeeded)."""
        rep = self.by_url(url)
        if rep is None:
            return
        with self._lock:
            rep.verdict = verdict
        if verdict == "critical":
            self.eject(rep, "health-critical")
        elif open_breakers:
            self.eject(rep, "breaker-open")
        elif rep.state == PROBING and verdict in ("ok", "warn"):
            self.readmit(rep)

    def note_headroom(self, url: str, headroom: Optional[float]) -> None:
        rep = self.by_url(url)
        if rep is not None:
            with self._lock:
                rep.headroom = headroom

    def note_penalty(self, url: str, penalty: float) -> None:
        """Soft routing penalty from the fleet observer's straggler
        scoring (fleet/observe.py): the routing policy multiplies the
        replica's load score by ``1 + penalty``, steering traffic away
        without ejecting — the straggler keeps receiving enough traffic
        to show recovery."""
        rep = self.by_url(url)
        if rep is not None:
            with self._lock:
                rep.penalty = max(0.0, float(penalty))

    def _advance_probes_locked(self) -> None:
        """Ejected → probing after the half-open window (caller holds
        the lock).  A PROBING replica is eligible for trial traffic; one
        success readmits it, one more failure re-ejects."""
        now = self._clock()
        for rep in self._replicas.values():
            if rep.state == EJECTED and now - rep.ejected_at >= self.reprobe_s:
                rep.state = PROBING

    def probe_due(self, interval_s: float) -> bool:
        """Rate-limits the gateway's active health sweep (at most one
        sweep per ``interval_s``)."""
        now = self._clock()
        with self._lock:
            if now - self._last_probe < interval_s:
                return False
            self._last_probe = now
            return True

    # -- session affinity -------------------------------------------------
    def session_url(self, session: str) -> Optional[str]:
        with self._lock:
            return self._sessions.get(session)

    def bind_session(self, session: str, url: str) -> None:
        with self._lock:
            # bounded: affinity is best-effort, not a leak vector
            if len(self._sessions) > 4096:
                self._sessions.clear()
            self._sessions[session] = url

    # -- surfaces ---------------------------------------------------------
    def _emit_state_gauge(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            counts = {HEALTHY: 0, EJECTED: 0, PROBING: 0}
            for rep in self._replicas.values():
                counts[rep.state] = counts.get(rep.state, 0) + 1
        for state, n in counts.items():
            self.metrics.gauge_set(
                "seldon_fleet_replicas",
                float(n),
                {"deployment": self.deployment, "state": state},
            )

    def snapshot(self) -> dict:
        with self._lock:
            self._advance_probes_locked()
            reps = [r.snapshot() for r in self._replicas.values()]
            ring = self.ring.describe()
            sessions = len(self._sessions)
        reps.sort(key=lambda r: r["replica"])
        return {
            "deployment": self.deployment,
            "policy": self.config.policy,
            "replicas": reps,
            "healthy": sum(1 for r in reps if r["state"] == HEALTHY),
            "ring": ring,
            "sessions": sessions,
        }
