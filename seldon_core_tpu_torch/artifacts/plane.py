"""Artifact plane: boot-time capture of a fused plan's buckets from a
content-addressed store, and the kernel library from the same store (port
of ``seldon_core_tpu/artifacts/plane.py``, redesigned for the card).

The reference serializes XLA executables.  Nothing of that carries over:
a fused bucket here is a ``torch.cuda.CUDAGraph`` (``graph/plan.py``,
``runtime/programs.py`` :func:`capture`), a CUDA graph does not outlive
its process, and K1 launches through ctypes, which ``torch.export``
cannot trace.  So the store holds two things:

- **a record per captured bucket**: its key under the reference's field
  names (``key``, ``bucketShape``, ``dtype``, ``sharding``, ``cost``), the
  capture's seconds, and a blake2b digest of the replay's output on a
  probe input drawn from a ``torch.Generator`` seeded from the key;
- **the kernel library** ``libsck_<hash>.so`` under its own key, with its
  sha256 (:meth:`ArtifactPlane.load_library`,
  :meth:`ArtifactPlane.publish_library`, called by ``ops/_build.py``).

The reference's operations map so:

- **hydrate** (:meth:`ArtifactPlane.hydrate_plan`, at engine boot):
  every stored bucket whose key matches this process's (segment, mesh,
  runtime) identity is captured now, then replayed on its probe input;
- **the parity gate**: the probe digest must equal the published one
  (the capture itself already holds its first replay bitwise to an eager
  run, ``programs.capture``);
- **quarantine**: a digest mismatch or a corrupt record is deleted from
  the store and counted, and the bucket captures live at first sight,
  which publishes a fresh record;
- **publish**: every live capture (first sight, or the boot warm-up when
  ``precompile`` is on) is replayed on its probe input and recorded.

Buckets exist only where graphs are captured (``programs.graphs_on``: the
card).  On the CPU a segment runs eagerly, and the plane hydrates and
publishes nothing.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from seldon_core_tpu_torch.artifacts.config import ArtifactConfig
from seldon_core_tpu_torch.artifacts.key import (
    FORMAT_VERSION,
    artifact_key,
    runtime_identity,
    segment_fingerprint,
)
from seldon_core_tpu_torch.artifacts.store import (
    ArtifactBackend,
    LocalArtifactStore,
)
from seldon_core_tpu_torch.runtime import programs

logger = logging.getLogger(__name__)

__all__ = ["ArtifactPlane", "LIBRARY_FP", "library_key", "probe_input",
           "probe_digest"]

_HYDRATIONS_COUNTER = "seldon_artifact_hydrations_total"
_PUBLISHES_COUNTER = "seldon_artifact_publishes_total"
_MISSES_COUNTER = "seldon_artifact_misses_total"
_PARITY_FAIL_COUNTER = "seldon_artifact_parity_failures_total"
_DESERIALIZE_FAIL_COUNTER = "seldon_artifact_deserialize_failures_total"
_STORE_ENTRIES_GAUGE = "seldon_artifact_store_entries"
_STORE_BYTES_GAUGE = "seldon_artifact_store_bytes"
_COVERAGE_GAUGE = "seldon_artifact_coverage"

#: the store "segment" the kernel library lives under
LIBRARY_FP = "kernel-library"


def library_key(source_hash: str) -> str:
    """The kernel library's key: its sources and flags
    (``ops/_build.source_hash``), the CUDA toolkit PyTorch runs on, the
    format version."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{source_hash}|{torch.version.cuda}|{FORMAT_VERSION}".encode())
    return h.hexdigest()


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt


def probe_input(key: str, shape, dtype: torch.dtype,
                device) -> torch.Tensor:
    """The bucket's probe: drawn on the host from a generator seeded from
    the key (the same on every process and card), then moved."""
    g = torch.Generator().manual_seed(int(key[:15], 16))
    shape = tuple(int(d) for d in shape)
    if dtype == torch.bool:
        x = torch.rand(shape, generator=g) < 0.5
    elif dtype.is_floating_point:
        x = (torch.rand(shape, generator=g) * 255.0).to(dtype)
    else:
        x = torch.randint(0, 100, shape, generator=g).to(dtype)
    return x.to(device)


def probe_digest(y: torch.Tensor) -> str:
    """blake2b of an output's shape, dtype and bytes."""
    t = y.detach().to("cpu").contiguous()
    h = hashlib.blake2b(digest_size=16)
    h.update(str(tuple(t.shape)).encode())
    h.update(str(t.dtype).encode())
    if t.numel():
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class ArtifactPlane:
    """One deployment's artifact posture: the store, the hydration and
    publish counters, and the admin and status surfaces."""

    def __init__(self, config: ArtifactConfig, metrics=None,
                 deployment: str = "",
                 backend: Optional[ArtifactBackend] = None):
        self.config = config
        self.metrics = metrics
        self.deployment = deployment
        self.store: ArtifactBackend = (
            backend if backend is not None
            else LocalArtifactStore(config.store))
        #: the runtime identity in every key; set from the plan's device
        #: when the plan is attached (unless set before)
        self.runtime: Optional[str] = None
        self.mesh_spec = ""
        self._plan = None
        self._lock = threading.Lock()
        self.hydrated = 0
        self.published = 0
        self.misses = 0
        self.live_compiles = 0
        self.parity_failures = 0
        self.deserialize_failures = 0
        self.quarantined = 0
        #: the kernel library's provenance in this process
        self.library: dict = {}

    # -- wiring ----------------------------------------------------------
    def attach_plan(self, plan, mesh_spec: str = "") -> None:
        """Bind the plan: every fused segment gets a back-reference (its
        first-sight captures consult the store and publish back), and each
        segment's fingerprint is taken now, once."""
        self._plan = plan
        self.mesh_spec = mesh_spec or ""
        for seg in plan.segments:
            seg.artifacts = self
            self._fingerprint(seg)
        if self.runtime is None:
            dev = plan.segments[0].device if plan.segments else "cpu"
            self.runtime = runtime_identity(dev)

    def _fingerprint(self, seg) -> str:
        fp = getattr(seg, "_artifact_fp", None)
        if fp is None:
            fp = segment_fingerprint(seg)
            seg._artifact_fp = fp
        return fp

    def _key(self, fp: str, shape, dtype: str, sharding: str = "") -> str:
        return artifact_key(fp, shape, dtype, self.mesh_spec, self.runtime,
                            sharding=sharding)

    # -- hydrate (boot) --------------------------------------------------
    def hydrate_plan(self, plan=None) -> int:
        """Capture every stored bucket matching this process's (segment,
        mesh, runtime) identity, each held to its probe digest.  Returns
        the buckets hydrated; never raises — a store problem costs warm
        starts, not the deployment."""
        plan = plan if plan is not None else self._plan
        if plan is None:
            return 0
        total = 0
        for seg in plan.segments:
            if not programs.graphs_on(seg.device):
                continue  # eager on the CPU: nothing is captured
            try:
                total += self._hydrate_segment(seg)
            except Exception:
                logger.warning("artifact hydration failed for segment %s",
                               seg.label, exc_info=True)
        self._export_store_gauges()
        return total

    def _hydrate_segment(self, seg) -> int:
        fp = self._fingerprint(seg)
        n = 0
        for sc in self.store.sidecars(fp):
            try:
                shape = tuple(int(d) for d in sc.get("bucketShape", ()))
                dtype = str(sc.get("dtype", ""))
                key = str(sc.get("key", ""))
                sharding = str(sc.get("sharding", "") or "")
            except (TypeError, ValueError):
                continue  # not a record of this format
            if key != self._key(fp, shape, dtype, sharding) or sharding:
                # another mesh, runtime or format vintage: not ours
                continue
            with seg._capture_lock:
                if seg.bucket_for(shape, dtype) in seg._buckets:
                    continue
                t0 = time.perf_counter()
                got = self._capture_stored(seg, fp, key, shape, dtype,
                                           sc.get("probeDigest"))
                if got is None:
                    continue
                wall_ms = (time.perf_counter() - t0) * 1000.0
                bucket = seg.bucket_for(shape, dtype)
                cost = {**dict(sc.get("cost") or {}),
                        **seg.bucket_cost(bucket)}
                cost["source"] = "aot-cache"
                cost["hydrate_ms"] = round(wall_ms, 3)
                seg.hydrated.add(bucket)
                seg.cost_by_bucket[seg.bucket_wire(bucket)] = cost
            n += 1
            self.note_hydrated(seg, bucket, wall_ms)
        return n

    def _capture_stored(self, seg, fp: str, key: str, shape, dtype: str,
                        published: Optional[str]):
        """Capture a stored bucket on its probe input (the caller holds
        the segment's capture lock) and hold the probe's digest to the
        record's and, when given, the sidecar's.  The capture, or None:
        a miss, or a quarantined record (then nothing stays captured)."""
        blob = self.store.get(fp, key)
        if blob is None:
            return None
        try:
            rec = json.loads(blob)
            want = str(rec["probeDigest"])
            if rec.get("key") != key or rec.get("format") != FORMAT_VERSION:
                raise ValueError("record of another key or format")
            probe = probe_input(key, shape, _torch_dtype(dtype), seg.device)
        except (ValueError, KeyError, TypeError):
            self._quarantine(seg, fp, key, "deserialize")
            return None
        bucket = seg.bucket_for(shape, dtype)
        b = seg._capture_bucket(bucket, probe)
        got = probe_digest(b.outputs)
        if got != want or (published is not None and got != published):
            seg.drop_bucket(bucket)
            self._quarantine(seg, fp, key, "parity")
            return None
        return b

    def note_hydrated(self, seg, bucket: tuple, wall_ms: float) -> None:
        """Counters and the capture-ledger row (``source="aot-cache"``,
        never a live capture) of one bucket captured from the store."""
        with self._lock:
            self.hydrated += 1
        seg.note_ledger(bucket, wall_ms, "aot-cache")
        if self.metrics is not None:
            try:
                self.metrics.counter_inc(_HYDRATIONS_COUNTER,
                                         {"segment": seg.label})
            except Exception:
                pass

    # -- request-path hooks (FusedSegment._capture) -----------------------
    def load_bucket(self, seg, bucket: tuple):
        """A bucket not captured at boot, seen on the request path: capture
        it from the store (under the segment's capture lock) when a record
        holds it, probe-checked.  The capture, or None (a miss, a
        quarantined record); never raises."""
        try:
            fp = self._fingerprint(seg)
            shape, dtype = seg.bucket_wire(bucket)
            key = self._key(fp, shape, dtype)
            if self.store.get(fp, key) is None:
                with self._lock:
                    self.misses += 1
                if self.metrics is not None:
                    self.metrics.counter_inc(_MISSES_COUNTER,
                                             {"segment": seg.label})
                return None
            t0 = time.perf_counter()
            b = self._capture_stored(seg, fp, key, shape, dtype, None)
            if b is None:
                return None
            wall_ms = (time.perf_counter() - t0) * 1e3
            seg.hydrated.add(bucket)
            seg.cost_by_bucket[seg.bucket_wire(bucket)] = {
                **seg.bucket_cost(bucket), "source": "aot-cache",
                "hydrate_ms": round(wall_ms, 3)}
            self.note_hydrated(seg, bucket, wall_ms)
            return b
        except Exception:
            logger.debug("artifact load failed for segment %s bucket %s",
                         seg.label, bucket, exc_info=True)
            return None

    def note_live_compile(self, seg, bucket: tuple) -> None:
        """A bucket captured live in this process."""
        with self._lock:
            self.live_compiles += 1

    def publish_bucket(self, seg, bucket: tuple, captured,
                       capture_s: float) -> bool:
        """Replay a live capture on its probe input and record it in the
        store.  True when the probe replayed (the static outputs then hold
        the probe's answer); never raises."""
        if not self.config.publish:
            return False
        try:
            fp = self._fingerprint(seg)
            shape, dtype = seg.bucket_wire(bucket)
            key = self._key(fp, shape, dtype)
            probe = probe_input(key, shape, _torch_dtype(dtype), seg.device)
        except Exception:
            logger.warning("artifact probe failed for segment %s bucket %s",
                           seg.label, bucket, exc_info=True)
            return False
        try:
            captured.inputs[0].copy_(probe)
            digest = probe_digest(captured.replay())
        except Exception:
            # the static buffers may hold the probe now: the caller replays
            logger.warning("artifact probe failed for segment %s bucket %s",
                           seg.label, bucket, exc_info=True)
            return True
        try:
            cost = {"capture_s": capture_s}
            blob = json.dumps({"format": FORMAT_VERSION, "key": key,
                               "probeDigest": digest}).encode()
            self.store.put(fp, key, blob, {
                "key": key,
                "segment": seg.label,
                "segmentFingerprint": fp,
                "bucketShape": list(shape),
                "dtype": dtype,
                "meshSpec": self.mesh_spec,
                "sharding": "",
                "runtimeIdentity": self.runtime,
                "formatVersion": FORMAT_VERSION,
                # every capture holds its first replay bitwise to an
                # eager run (programs.capture) before it is published
                "parity": "verified",
                "probeDigest": digest,
                "captureSeconds": capture_s,
                "payloadBytes": len(blob),
                "cost": cost,
                "createdAt": time.time(),
            })
            with self._lock:
                self.published += 1
            if self.metrics is not None:
                self.metrics.counter_inc(_PUBLISHES_COUNTER,
                                         {"segment": seg.label})
            self._export_store_gauges()
        except Exception:
            # a read-only store, a full disk: live-only serving
            logger.debug("artifact publish failed for segment %s bucket %s",
                         seg.label, bucket, exc_info=True)
        return True

    def _quarantine(self, seg, fp: str, key: str, why: str) -> None:
        label = getattr(seg, "label", str(seg))
        with self._lock:
            self.quarantined += 1
            if why == "parity":
                self.parity_failures += 1
            else:
                self.deserialize_failures += 1
        if self.metrics is not None:
            try:
                self.metrics.counter_inc(
                    _PARITY_FAIL_COUNTER if why == "parity"
                    else _DESERIALIZE_FAIL_COUNTER, {"segment": label})
            except Exception:
                pass
        logger.warning(
            "segment %s: quarantining artifact %s (%s failure); a live "
            "capture takes over", label, key, why)
        try:
            self.store.delete(fp, key)
        except Exception:
            pass

    # -- the kernel library (ops/_build.py) ------------------------------
    def load_library(self, source_hash: str, dest: Path) -> Optional[Path]:
        """The stored kernel library for ``source_hash``, written to
        ``dest`` once its sha256 matches its sidecar's: ``dest``, or None
        (a miss, or a quarantined entry, which is never loaded)."""
        key = library_key(source_hash)
        blob = self.store.get(LIBRARY_FP, key)
        if blob is None:
            with self._lock:
                self.misses += 1
            return None
        want = None
        for sc in self.store.sidecars(LIBRARY_FP):
            if sc.get("key") == key:
                want = sc.get("sha256")
        if want is None or hashlib.sha256(blob).hexdigest() != want:
            self._quarantine("kernel-library", LIBRARY_FP, key, "parity")
            return None
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_name(f"{dest.name}.tmp.{threading.get_ident()}")
        tmp.write_bytes(blob)
        tmp.replace(dest)
        self.library = {"source": "aot-cache", "key": key, "sha256": want,
                        "store": self._store_path(LIBRARY_FP, key)}
        return dest

    def publish_library(self, source_hash: str, path: Path) -> bool:
        """Record the kernel library built here; never raises."""
        if not self.config.publish:
            return False
        key = library_key(source_hash)
        try:
            blob = Path(path).read_bytes()
            digest = hashlib.sha256(blob).hexdigest()
            self.store.put(LIBRARY_FP, key, blob, {
                "key": key, "library": Path(path).name,
                "sourceHash": source_hash, "cuda": torch.version.cuda,
                "formatVersion": FORMAT_VERSION, "sha256": digest,
                "payloadBytes": len(blob), "createdAt": time.time()})
        except Exception:
            logger.debug("kernel library publish failed", exc_info=True)
            return False
        self.library = {"source": "live", "key": key, "sha256": digest,
                        "store": self._store_path(LIBRARY_FP, key)}
        return True

    def _store_path(self, fp: str, key: str) -> str:
        paths = getattr(self.store, "_paths", None)
        return str(paths(fp, key)[0]) if paths is not None else key

    # -- read surfaces ----------------------------------------------------
    def coverage(self) -> dict:
        """How many of the buckets this process has needed came from the
        store; ``coverage == 1.0`` with ``liveCompiles == 0`` is a warm
        boot."""
        with self._lock:
            hydrated = self.hydrated
            live = self.live_compiles
        total = hydrated + live
        return {
            "buckets": total,
            "hydrated": hydrated,
            "liveCompiles": live,
            "coverage": round(hydrated / total, 4) if total else 1.0,
        }

    def source_tag(self) -> str:
        """``meta.tags["artifact-source"]``: ``aot-cache`` when every
        bucket this replica serves was captured at boot from the store,
        ``live`` otherwise."""
        with self._lock:
            return ("aot-cache"
                    if self.live_compiles == 0 and self.hydrated > 0
                    else "live")

    def _export_store_gauges(self) -> None:
        if self.metrics is None:
            return
        try:
            st = self.store.stats()
            self.metrics.gauge_set(_STORE_ENTRIES_GAUGE,
                                   float(st.get("entries", 0)))
            self.metrics.gauge_set(_STORE_BYTES_GAUGE,
                                   float(st.get("bytes", 0)))
            self.metrics.gauge_set(_COVERAGE_GAUGE,
                                   self.coverage()["coverage"])
        except Exception:
            pass

    def snapshot(self) -> dict:
        """Compact posture (status, tests)."""
        cov = self.coverage()
        with self._lock:
            out = {
                "enabled": self.config.enabled,
                "store": getattr(self.store, "root",
                                 type(self.store).__name__),
                "meshSpec": self.mesh_spec,
                "runtimeIdentity": self.runtime,
                "hydrated": self.hydrated,
                "published": self.published,
                "misses": self.misses,
                "liveCompiles": self.live_compiles,
                "parityFailures": self.parity_failures,
                "deserializeFailures": self.deserialize_failures,
                "quarantined": self.quarantined,
                "source": ("aot-cache"
                           if self.live_compiles == 0 and self.hydrated > 0
                           else "live"),
            }
            if self.library:
                out["kernelLibrary"] = dict(self.library)
        out["coverage"] = cov["coverage"]
        try:
            out["storeStats"] = self.store.stats()
        except Exception:
            pass
        return out

    def describe(self) -> dict:
        """``/admin/artifacts``: the snapshot, and per segment where each
        bucket came from and how many records the store holds for it."""
        out = self.snapshot()
        segments = []
        plan = self._plan
        if plan is not None:
            for seg in plan.segments:
                buckets = {}
                for bucket, cost in list(seg.cost_by_bucket.items()):
                    shape, dtype = seg.bucket_wire(bucket)
                    label = "x".join(str(d) for d in shape) + f":{dtype}"
                    buckets[label] = {
                        "source": cost.get("source", "live"),
                        **{k: cost[k] for k in
                           ("capture_s", "hydrate_ms") if k in cost},
                    }
                entry = {
                    "segment": seg.label,
                    "fingerprint": self._fingerprint(seg),
                    "buckets": buckets,
                }
                entry["stored"] = len(self.store.sidecars(
                    entry["fingerprint"]))
                segments.append(entry)
        out["segments"] = segments
        return out

    # -- probe ------------------------------------------------------------
    def probe(self):
        """A probe of store occupancy and warm coverage, for the health
        plane's introspection sampler (``operator/local.py`` adds it)."""
        def _probe() -> dict:
            try:
                st = self.store.stats()
            except Exception:
                st = {}
            cov = self.coverage()
            with self._lock:
                return {
                    "artifact_store_entries":
                        float(st.get("entries", 0)),
                    "artifact_store_bytes": float(st.get("bytes", 0)),
                    "artifact_hydrated": float(self.hydrated),
                    "artifact_live_compiles": float(self.live_compiles),
                    "artifact_coverage": float(cov["coverage"]),
                }
        return _probe

