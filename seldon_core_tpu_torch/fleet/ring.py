"""Consistent-hash ring over the blake2b cache-key space.

The gateway's prediction-cache key (``caching/key.py raw_key``) content-
addresses each request; hashing that key onto a ring of engine replicas
gives every distinct request body a home replica, so the ENGINE-tier
caches (and LLM prefix pages) see repeats instead of N cold caches.

Classic Karger ring with virtual nodes: each member owns ``vnodes``
points; a key routes to the first member point clockwise.  Membership
changes move only the arcs adjacent to the added/removed points — ~1/N
of the key space per single-replica change (tests/test_fleet.py proves
the property over the real blake2b key distribution).

Port of ``seldon_core_tpu/fleet/ring.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import bisect
import hashlib

__all__ = ["HashRing"]


def _point(s: str) -> int:
    """64-bit ring coordinate (blake2b — same family as the cache key, so
    the ring is uniform over exactly the key space it routes)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    def __init__(self, members=(), vnodes: int = 64):
        self.vnodes = vnodes
        self._points: list[int] = []          # sorted vnode coordinates
        self._owner: dict[int, str] = {}      # coordinate -> member
        self._members: set[str] = set()
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def members(self) -> list[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self.vnodes):
            pt = _point(f"{member}#{i}")
            # collisions across members are astronomically unlikely in a
            # 64-bit space; last-add-wins keeps the ring consistent anyway
            if pt not in self._owner:
                bisect.insort(self._points, pt)
            self._owner[pt] = member

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        for i in range(self.vnodes):
            pt = _point(f"{member}#{i}")
            if self._owner.get(pt) == member:
                del self._owner[pt]
                idx = bisect.bisect_left(self._points, pt)
                if idx < len(self._points) and self._points[idx] == pt:
                    self._points.pop(idx)

    def lookup(self, key: str, exclude=()) -> str | None:
        """The key's home member — first ring point clockwise from the
        key's coordinate.  ``exclude`` walks past excluded members (the
        retry-next-replica path), preserving per-key preference order."""
        if not self._points:
            return None
        start = bisect.bisect_right(self._points, _point(key))
        seen: set[str] = set()
        n = len(self._points)
        for step in range(n):
            owner = self._owner[self._points[(start + step) % n]]
            if owner in seen:
                continue
            seen.add(owner)
            if owner not in exclude:
                return owner
            if len(seen) == len(self._members):
                break
        return None

    def describe(self) -> dict:
        return {
            "members": self.members(),
            "vnodes": self.vnodes,
            "points": len(self._points),
        }
