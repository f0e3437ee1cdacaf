"""Prediction cache + single-flight coalescing (port of
``seldon_core_tpu/caching/``; the gateway tier is not ported yet).

Two engine tiers share this package:

1. **walk mode** (``graph/engine.py``): memoisation of maximal
   deterministic-pure subtrees, with per-request meta replay;
2. **fused-plan mode**: per-segment cache — a hit skips the whole segment
   (no replay of its CUDA graph, no kernel launched).

Both coalesce concurrent identical requests through one
:class:`SingleFlight` table (N arrivals → 1 model invocation → N
responses), composing with the dynamic batcher: a coalesced group
occupies exactly one batch row.
"""

from seldon_core_tpu_torch.caching.key import array_key, message_key, raw_key
from seldon_core_tpu_torch.caching.singleflight import SingleFlight
from seldon_core_tpu_torch.caching.store import (
    CACHE_ANNOTATION,
    CACHE_BYTES_ANNOTATION,
    CACHE_TTL_ANNOTATION,
    CacheConfig,
    PredictionCache,
    cache_enabled,
    config_from_annotations,
)

__all__ = [
    "array_key",
    "message_key",
    "raw_key",
    "SingleFlight",
    "CacheConfig",
    "PredictionCache",
    "CACHE_ANNOTATION",
    "CACHE_BYTES_ANNOTATION",
    "CACHE_TTL_ANNOTATION",
    "cache_enabled",
    "config_from_annotations",
]
