"""Routing policies over a :class:`~seldon_core_tpu_torch.fleet.pool.ReplicaPool`.

Three policies, selected by ``seldon.io/fleet-policy`` (docs/scale-out.md):

- ``least-loaded`` — score each candidate by live in-flight + its EWMA,
  discounted by the capacity headroom the engine publishes at
  ``/admin/profile/capacity`` (a replica with 80% headroom absorbs twice
  the queue of one at 40% before looking equally loaded).  Ties break
  round-robin so an idle fleet still spreads.
- ``consistent-hash`` — the request's content-addressed cache key routes
  on the blake2b ring (fleet/ring.py): repeats of a body land on the
  same replica, so engine-tier caches and LLM prefix pages get locality.
- ``round-robin`` — the baseline rotation.

Session affinity (SSE streams) runs BEFORE the policy: a live binding
pins the stream's replica; the policy only picks for unbound sessions.

All functions are called with the pool's lock held.

Port of ``seldon_core_tpu/fleet/policy.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

from typing import Optional

from seldon_core_tpu_torch.fleet.pool import EJECTED, HEALTHY, PROBING, Replica

__all__ = ["pick_replica"]


def _candidates(pool, exclude: set) -> list[Replica]:
    """Best available state tier: healthy, else probing (half-open trial
    traffic), else ejected (last resort).  ``exclude`` drops URLs the
    current request already failed against — unless that empties the
    tier entirely (a desperate retry beats an unconditional 503)."""
    reps = list(pool._replicas.values())
    for states in ((HEALTHY,), (PROBING,), (EJECTED,)):
        tier = [r for r in reps if r.state in states]
        if not tier:
            continue
        usable = [r for r in tier if r.url not in exclude]
        if usable:
            return usable
    remaining = [r for r in reps if r.url not in exclude]
    return remaining or reps


def _score(rep: Replica) -> float:
    load = rep.inflight + rep.ewma_inflight
    if rep.headroom is not None:
        # headroom in [0,1]; 0.1 floor keeps a saturated replica
        # selectable (finite score) when everyone is saturated
        load = load / max(rep.headroom, 0.1)
    # soft straggler penalty from the fleet observer (fleet/observe.py):
    # steer away from the outlier without ejecting it — ties at load 0
    # still need the +1 so an idle straggler scores worse than an idle peer
    if rep.penalty:
        load = (load + 1.0) * (1.0 + rep.penalty) - 1.0
    return load


def pick_replica(pool, key: Optional[str] = None,
                 session: Optional[str] = None,
                 exclude: Optional[set] = None) -> Optional[Replica]:
    exclude = exclude or set()
    if not pool._replicas:
        return None
    # -- session affinity (streams): sticky while the binding is healthy
    if session:
        url = pool._sessions.get(session)
        if url is not None and url not in exclude:
            rep = pool._replicas.get(url)
            if rep is not None and rep.state != EJECTED:
                return rep
        rep = _pick_by_policy(pool, key, exclude)
        if rep is not None:
            if len(pool._sessions) > 4096:
                pool._sessions.clear()
            pool._sessions[session] = rep.url
        return rep
    return _pick_by_policy(pool, key, exclude)


def _pick_by_policy(pool, key: Optional[str],
                    exclude: set) -> Optional[Replica]:
    cands = _candidates(pool, exclude)
    if not cands:
        return None
    policy = pool.config.policy
    if policy == "consistent-hash" and key:
        # prefer the key's home replica, walking the ring past excluded
        # and unroutable members (preference order is per-key stable)
        routable = {r.url for r in cands}
        bad = set(exclude) | {
            u for u in pool._replicas if u not in routable
        }
        url = pool.ring.lookup(key, exclude=bad)
        if url is not None and url in pool._replicas:
            return pool._replicas[url]
        # ring exhausted (all home candidates excluded) → fall through
    if policy == "least-loaded":
        best = min(cands, key=_score)
        score = _score(best)
        tied = [r for r in cands if _score(r) == score]
        if len(tied) > 1:
            pool._rr += 1
            return tied[pool._rr % len(tied)]
        return best
    # round-robin (and the consistent-hash fallback path)
    pool._rr += 1
    return cands[pool._rr % len(cands)]
