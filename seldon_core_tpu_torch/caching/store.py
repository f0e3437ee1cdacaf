"""Byte-budgeted LRU+TTL prediction cache (port of
``seldon_core_tpu/caching/store.py``).

The store is deliberately dumb: a thread-safe ``OrderedDict`` keyed by
content digests (``caching/key.py``) holding opaque entries with a byte
cost.  Eviction is LRU under a byte budget; expiry is lazy per-``get``
(an expired entry counts as a miss and is dropped).  Entries may hold
tensors on the card (a segment's or a node's output where it lies), so
the byte budget bounds device memory as well as host memory.

Annotations (validated when the deployment loads, ``graph/spec.py``):

- ``seldon.io/prediction-cache``: ``"true"`` enables the tier
- ``seldon.io/prediction-cache-bytes``: byte budget (default 64 MiB)
- ``seldon.io/prediction-cache-ttl-ms``: entry TTL (default 0 = forever)

Metrics (``cache`` label = tier instance name): ``seldon_cache_hits_total``,
``seldon_cache_misses_total``, ``seldon_cache_evictions_total``
(``reason=bytes|ttl``), ``seldon_cache_bytes`` gauge,
``seldon_coalesced_requests_total`` for single-flight followers, and
``seldon_cache_bypass_total`` for payloads that could not be keyed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

__all__ = [
    "CacheConfig",
    "PredictionCache",
    "CACHE_ANNOTATION",
    "CACHE_BYTES_ANNOTATION",
    "CACHE_TTL_ANNOTATION",
    "cache_enabled",
    "config_from_annotations",
]

CACHE_ANNOTATION = "seldon.io/prediction-cache"
CACHE_BYTES_ANNOTATION = "seldon.io/prediction-cache-bytes"
CACHE_TTL_ANNOTATION = "seldon.io/prediction-cache-ttl-ms"

DEFAULT_MAX_BYTES = 64 * 1024 * 1024

_TRUE = ("1", "true", "yes")
_FALSE = ("", "0", "false", "no")


@dataclass
class CacheConfig:
    name: str = "cache"
    max_bytes: int = DEFAULT_MAX_BYTES
    ttl_s: float = 0.0  # 0 = never expires


def cache_enabled(ann: dict) -> bool:
    """``seldon.io/prediction-cache`` as a strict boolean; raises
    ``ValueError`` on anything else so a typo'd value rejects at admission
    instead of silently serving uncached."""
    raw = str(ann.get(CACHE_ANNOTATION, "")).strip().lower()
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    raise ValueError(
        f"annotation {CACHE_ANNOTATION} must be a boolean, got {raw!r}"
    )


def config_from_annotations(ann: dict, name: str) -> Optional[CacheConfig]:
    """CacheConfig from ``seldon.io/prediction-cache*`` annotations, or
    None when the tier is off.  Raises ``ValueError`` on invalid values
    (admission wraps this into a rejected spec)."""
    if not cache_enabled(ann):
        return None
    raw_bytes = ann.get(CACHE_BYTES_ANNOTATION)
    if raw_bytes is None or str(raw_bytes).strip() == "":
        max_bytes = DEFAULT_MAX_BYTES
    else:
        try:
            max_bytes = int(str(raw_bytes).strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"annotation {CACHE_BYTES_ANNOTATION} must be an integer, "
                f"got {raw_bytes!r}"
            ) from None
        if max_bytes <= 0:
            raise ValueError(
                f"annotation {CACHE_BYTES_ANNOTATION} must be > 0, "
                f"got {max_bytes}"
            )
    raw_ttl = ann.get(CACHE_TTL_ANNOTATION)
    if raw_ttl is None or str(raw_ttl).strip() == "":
        ttl_s = 0.0
    else:
        try:
            ttl_ms = float(str(raw_ttl).strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"annotation {CACHE_TTL_ANNOTATION} must be a number "
                f"(milliseconds), got {raw_ttl!r}"
            ) from None
        if ttl_ms < 0:
            raise ValueError(
                f"annotation {CACHE_TTL_ANNOTATION} must be >= 0, "
                f"got {ttl_ms:g}"
            )
        ttl_s = ttl_ms / 1000.0
    return CacheConfig(name=name, max_bytes=max_bytes, ttl_s=ttl_s)


class _Entry:
    __slots__ = ("value", "nbytes", "expires_at")

    def __init__(self, value: Any, nbytes: int, expires_at: float):
        self.value = value
        self.nbytes = nbytes
        self.expires_at = expires_at  # 0 = never


class PredictionCache:
    """Thread-safe LRU+TTL store under a byte budget.

    Values are opaque to the store; callers supply the byte cost.  An
    over-budget single value is simply not cached (never evicts the whole
    working set for one giant response).
    """

    def __init__(self, config: Optional[CacheConfig] = None, metrics=None):
        self.config = config or CacheConfig()
        self.metrics = metrics  # MetricsRegistry or None
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # lifetime counters, mirrored into the metrics registry when one
        # is attached (bench/tests read these without scraping exposition)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coalesced = 0
        # requests whose payload could not be keyed (served cold, never
        # stored); kept out of ``stats``, which is the reference's
        self.bypassed = 0

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[Any]:
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.expires_at and e.expires_at <= now:
                self._drop(key, e, "ttl")
                e = None
            if e is None:
                self.misses += 1
                self._count("seldon_cache_misses_total")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._count("seldon_cache_hits_total")
            return e.value

    def put(self, key: str, value: Any, nbytes: int) -> bool:
        """Insert (or refresh) an entry; False if it exceeds the whole
        budget and was not stored."""
        nbytes = max(int(nbytes), 0)
        if nbytes > self.config.max_bytes:
            return False
        expires = (
            time.monotonic() + self.config.ttl_s if self.config.ttl_s else 0.0
        )
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(value, nbytes, expires)
            self._bytes += nbytes
            while self._bytes > self.config.max_bytes and self._entries:
                k, e = next(iter(self._entries.items()))
                self._drop(k, e, "bytes")
            self._gauge()
        return True

    def note_coalesced(self, n: int = 1) -> None:
        """Count single-flight followers served off one in-flight future."""
        self.coalesced += n
        self._count("seldon_coalesced_requests_total", n)

    def note_bypass(self) -> None:
        """Count a request that took the cold path unkeyed."""
        self.bypassed += 1
        self._count("seldon_cache_bypass_total")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._gauge()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "coalesced": self.coalesced,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------------
    def _drop(self, key: str, e: _Entry, reason: str) -> None:
        """Caller holds the lock."""
        self._entries.pop(key, None)
        self._bytes -= e.nbytes
        self.evictions += 1
        if self.metrics is not None:
            self.metrics.counter_inc(
                "seldon_cache_evictions_total",
                {"cache": self.config.name, "reason": reason},
            )

    def _count(self, name: str, n: float = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(name, {"cache": self.config.name}, n)

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge_set(
                "seldon_cache_bytes", self._bytes, {"cache": self.config.name}
            )
