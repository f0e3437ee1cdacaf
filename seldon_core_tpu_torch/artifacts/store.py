"""Artifact store backends (port of ``seldon_core_tpu/artifacts/store.py``,
the same layout and behaviour).

Artifacts are operator-managed data living next to the checkpoints
(``runtime/checkpoint.py``).  The local dir backend writes
``<final>.tmp.<pid>`` then ``os.replace``, so a crashed writer never
leaves a half-written entry where a booting replica will find it.

Layout (one directory per segment fingerprint, so boot-time hydration
enumerates a segment's buckets with one listdir)::

    <root>/<segment_fp[:12]>/<key>.bin    # payload: a bucket's probe
                                          # record, or the kernel library
    <root>/<segment_fp[:12]>/<key>.json   # sidecar: full key material,
                                          # probe digest, capture seconds

Trust model: the kernel library entry is code (it is loaded with
``dlopen`` after its sha256 is checked against its sidecar), so the store
directory sits in the same trust domain as the model checkpoints — never
hydrate from a store you would not load weights from.

``ArtifactBackend`` is the pluggable seam: :class:`LocalArtifactStore`
is the dir backend, :class:`InMemoryArtifactStore` stands in for a
shared remote backend in tests (same contract, no disk).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = [
    "ArtifactBackend",
    "LocalArtifactStore",
    "InMemoryArtifactStore",
]


class ArtifactBackend:
    """Contract every artifact store speaks: content-addressed put/get
    of an opaque payload plus a JSON-able sidecar.  Implementations must
    be safe under concurrent readers and a single writer per key."""

    def put(self, segment_fp: str, key: str, payload: bytes,
            sidecar: dict) -> None:
        raise NotImplementedError

    def get(self, segment_fp: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def sidecars(self, segment_fp: str) -> list[dict]:
        """Every sidecar stored for one segment fingerprint."""
        raise NotImplementedError

    def delete(self, segment_fp: str, key: str) -> None:
        """Quarantine: drop a corrupt/failed artifact so the next boot
        does not trip over it again."""
        raise NotImplementedError

    def stats(self) -> dict:
        """``{"entries": int, "bytes": int}`` across the whole store."""
        raise NotImplementedError


def _seg_dirname(segment_fp: str) -> str:
    return str(segment_fp)[:12]


class LocalArtifactStore(ArtifactBackend):
    """Directory-backed artifact store with checkpoint-style atomic
    writes.  The root is created lazily on the first put so a read-only
    replica pointed at an empty path just sees misses."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))

    # -- paths ----------------------------------------------------------
    def _paths(self, segment_fp: str, key: str) -> tuple:
        d = os.path.join(self.root, _seg_dirname(segment_fp))
        return (os.path.join(d, f"{key}.bin"),
                os.path.join(d, f"{key}.json"))

    # -- backend contract ------------------------------------------------
    def put(self, segment_fp: str, key: str, payload: bytes,
            sidecar: dict) -> None:
        bin_path, json_path = self._paths(segment_fp, key)
        os.makedirs(os.path.dirname(bin_path), exist_ok=True)
        for path, data in ((bin_path, payload),
                           (json_path,
                            json.dumps(sidecar, sort_keys=True).encode())):
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)

    def get(self, segment_fp: str, key: str) -> Optional[bytes]:
        bin_path, _ = self._paths(segment_fp, key)
        try:
            with open(bin_path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def sidecars(self, segment_fp: str) -> list[dict]:
        d = os.path.join(self.root, _seg_dirname(segment_fp))
        out = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name), "rb") as f:
                    sc = json.loads(f.read())
            except (OSError, ValueError):
                continue
            if isinstance(sc, dict):
                out.append(sc)
        return out

    def delete(self, segment_fp: str, key: str) -> None:
        for path in self._paths(segment_fp, key):
            try:
                os.remove(path)
            except OSError:
                pass

    def stats(self) -> dict:
        entries = size = 0
        try:
            seg_dirs = os.listdir(self.root)
        except OSError:
            return {"entries": 0, "bytes": 0}
        for seg in seg_dirs:
            d = os.path.join(self.root, seg)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                try:
                    size += os.path.getsize(os.path.join(d, name))
                except OSError:
                    continue
                if name.endswith(".bin"):
                    entries += 1
        return {"entries": entries, "bytes": size}


class InMemoryArtifactStore(ArtifactBackend):
    """Process-local backend with the shared-store contract — the test
    and drill stand-in for a remote (bucket/PVC) backend."""

    def __init__(self):
        self._lock = threading.Lock()
        # (segment_fp, key) -> (payload, sidecar)
        self._data: dict[tuple, tuple] = {}

    def put(self, segment_fp: str, key: str, payload: bytes,
            sidecar: dict) -> None:
        with self._lock:
            self._data[(segment_fp, key)] = (bytes(payload), dict(sidecar))

    def get(self, segment_fp: str, key: str) -> Optional[bytes]:
        with self._lock:
            hit = self._data.get((segment_fp, key))
        return hit[0] if hit else None

    def sidecars(self, segment_fp: str) -> list[dict]:
        with self._lock:
            return [dict(sc) for (fp, _k), (_p, sc) in self._data.items()
                    if fp == segment_fp]

    def delete(self, segment_fp: str, key: str) -> None:
        with self._lock:
            self._data.pop((segment_fp, key), None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": sum(len(p) for p, _ in self._data.values()),
            }
