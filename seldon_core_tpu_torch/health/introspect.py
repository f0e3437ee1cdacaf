"""Runtime introspection sampler: continuous telemetry of what the
serving path exhausts on the card (port of
``seldon_core_tpu/health/introspect.py``).

A per-process asyncio background task snapshots, every
``seldon.io/health-sample-ms``:

- device memory — ``torch.cuda.memory_stats`` (allocated bytes) against
  the card's total memory; the host's RSS only on the CPU device;
- fused-segment dispatch counters (``n_calls``, the count
  ``_dispatch_segment`` reads for ``compile_cache_hit``);
- DynamicBatcher queue depth / occupancy / latency EWMA;
- prediction-cache bytes/entries;
- QoS admission limit + shed level;
- the device-tensor registry's entries/bytes, the device plane's and the
  artifact plane's counters;
- asyncio event-loop lag (scheduling delay of the sampler's own tick).

Each sample lands in a bounded in-memory timeline (queryable at
``/admin/introspect``) and is exported as ``seldon_runtime_*`` gauges
in the shared metrics exposition.  Probes are plain callables returning
``{key: number}``; a probe that raises is counted and skipped — sampling
must never take the serving path down with it.  The placement probe
(:func:`placement_probe`) samples the mesh: its size, the sharded segments
and dispatches, and the bytes each device holds.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = [
    "RuntimeSampler",
    "GAUGES",
    "device_memory_probe",
    "engine_probe",
    "batcher_probe",
    "cache_probe",
    "qos_probe",
    "profile_probe",
    "device_registry_probe",
    "placement_probe",
    "PLACEMENT_DEVICE_BYTES_GAUGE",
]

#: sample key → exported gauge name (every name is in the analytics
#: CATALOG; gauges carry a ``probe`` label naming their source instance)
GAUGES = {
    "hbm_bytes_in_use": "seldon_runtime_hbm_bytes_in_use",
    "hbm_bytes_limit": "seldon_runtime_hbm_bytes_limit",
    "host_rss_bytes": "seldon_runtime_host_rss_bytes",
    "event_loop_lag_ms": "seldon_runtime_event_loop_lag_ms",
    "jit_segments": "seldon_runtime_jit_segments",
    "jit_segments_compiled": "seldon_runtime_jit_segments_compiled",
    "jit_dispatches": "seldon_runtime_jit_dispatches",
    "device_occupancy_est": "seldon_runtime_device_occupancy_est",
    "compiles_total": "seldon_runtime_compiles_total",
    "recompile_storm": "seldon_runtime_recompile_storm",
    "queue_rows": "seldon_runtime_queue_rows",
    "queue_lanes": "seldon_runtime_queue_lanes",
    "queue_occupancy": "seldon_runtime_queue_occupancy",
    "batch_inflight": "seldon_runtime_batch_inflight",
    "batch_latency_ewma_ms": "seldon_runtime_batch_latency_ewma_ms",
    "cache_bytes": "seldon_runtime_cache_bytes",
    "cache_entries": "seldon_runtime_cache_entries",
    "admission_limit": "seldon_runtime_admission_limit",
    "admission_inflight": "seldon_runtime_admission_inflight",
    "shed_level": "seldon_runtime_shed_level",
    "device_registry_entries": "seldon_runtime_device_registry_entries",
    "device_registry_bytes": "seldon_runtime_device_registry_bytes",
    "placement_devices": "seldon_runtime_placement_devices",
    "placement_segments_sharded": "seldon_runtime_placement_segments_sharded",
    "placement_sharded_dispatches":
        "seldon_runtime_placement_sharded_dispatches",
    "placement_device_bytes_max": "seldon_runtime_placement_device_bytes_max",
    "artifact_store_entries": "seldon_artifact_store_entries",
    "artifact_store_bytes": "seldon_artifact_store_bytes",
    "artifact_hydrated": "seldon_artifact_hydrated",
    "artifact_live_compiles": "seldon_artifact_live_compiles",
    "artifact_coverage": "seldon_artifact_coverage",
    "device_plane_transfers_avoided":
        "seldon_runtime_device_plane_transfers_avoided",
    "device_plane_bytes_avoided":
        "seldon_runtime_device_plane_bytes_avoided",
    "device_plane_remote_refs": "seldon_runtime_device_plane_remote_refs",
    "device_plane_downgrades": "seldon_runtime_device_plane_downgrades",
    "device_plane_donations": "seldon_runtime_device_plane_donations",
}


# -- standard probes ---------------------------------------------------------
def device_memory_probe(device=None) -> Callable[[], dict]:
    """Device memory of ``device`` (the card in use when None and one is
    visible, else the CPU).  On a card: ``allocated_bytes.all.current``
    of ``torch.cuda.memory_stats`` as ``hbm_bytes_in_use`` (the bytes held
    by live tensors and CUDA-graph pools, as XLA's ``bytes_in_use`` counts
    live buffers; the caching allocator's reserved bytes would add free
    blocks it keeps), and the card's total memory as ``hbm_bytes_limit``;
    a card that does not report raises (the sampler counts the error).  On
    the CPU device: the process's RSS."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)

    def probe() -> dict:
        if dev.type != "cuda":
            return {"host_rss_bytes": _host_rss_bytes()}
        stats = torch.cuda.memory_stats(dev)
        if "allocated_bytes.all.current" not in stats:
            raise RuntimeError(
                f"torch.cuda.memory_stats({dev}) reports no allocated bytes")
        return {
            "hbm_bytes_in_use": float(stats["allocated_bytes.all.current"]),
            "hbm_bytes_limit": float(
                torch.cuda.get_device_properties(dev).total_memory),
        }

    return probe


def _host_rss_bytes() -> float:
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return float(resident_pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        return 0.0


def engine_probe(engine) -> Callable[[], dict]:
    """Fused-plan compile/dispatch counters (walk-mode engines have no
    plan and contribute nothing)."""

    def probe() -> dict:
        plan = getattr(engine, "plan", None)
        segments = getattr(plan, "segments", None)
        if not segments:
            return {}
        calls = [getattr(seg, "n_calls", 0) for seg in segments]
        return {
            "jit_segments": float(len(calls)),
            "jit_segments_compiled": float(sum(1 for c in calls if c > 0)),
            "jit_dispatches": float(sum(calls)),
        }

    return probe


def batcher_probe(batcher) -> Callable[[], dict]:
    def probe() -> dict:
        lanes = list(getattr(batcher, "_lanes", {}).values())
        rows = float(sum(getattr(lane, "pending_rows", 0) for lane in lanes))
        max_rows = float(getattr(batcher, "max_queue_rows", 0) or 0)
        return {
            "queue_rows": rows,
            "queue_lanes": float(len(lanes)),
            "queue_occupancy": rows / max_rows if max_rows else 0.0,
            "batch_inflight": float(getattr(batcher, "_inflight", 0)),
            "batch_latency_ewma_ms": float(
                getattr(batcher, "latency_ewma_s", 0.0)) * 1000.0,
        }

    return probe


def cache_probe(cache) -> Callable[[], dict]:
    def probe() -> dict:
        stats = cache.stats
        return {
            "cache_bytes": float(stats.get("bytes", 0)),
            "cache_entries": float(stats.get("entries", 0)),
        }

    return probe


def qos_probe(qos) -> Callable[[], dict]:
    """Admission posture from an ``EngineQos`` (or bare controller)."""

    def probe() -> dict:
        admission = getattr(qos, "admission", qos)
        out = {"shed_level": float(getattr(qos, "shed_level", 0))}
        if admission is not None:
            out["admission_limit"] = float(getattr(admission, "limit", 0))
            out["admission_inflight"] = float(
                getattr(admission, "inflight", 0))
        return out

    return probe


def profile_probe(profiler) -> Callable[[], dict]:
    """Profiling-plane posture (profiling/plane.py ProfilePlane):
    estimated device-FLOP occupancy from per-request attribution, the
    capture ledger, and the live capture-storm signal.  The port has no
    compile cache, so the reference's compile-cache keys are absent."""

    def probe() -> dict:
        compile_stats = profiler.compile.stats()
        return {
            "device_occupancy_est":
                profiler.attribution.occupancy_estimate(),
            "compiles_total": float(compile_stats.get("compiles", 0)),
            "recompile_storm": 1.0 if profiler.storm_segments() else 0.0,
        }

    return probe


#: the labeled per-device gauge the placement probe sets itself (the flat
#: GAUGES table cannot carry a ``device`` label)
PLACEMENT_DEVICE_BYTES_GAUGE = "seldon_runtime_placement_device_bytes"


def placement_probe(placement, metrics=None) -> Callable[[], dict]:
    """The placement plane's posture (``placement/plane.py``): mesh size,
    the segments serving sharded, the sharded-dispatch count, and the
    bytes each device holds, in the labeled
    ``seldon_runtime_placement_device_bytes{device=...}`` gauge.

    On a card the bytes are ``allocated_bytes.all.current`` of
    ``torch.cuda.memory_stats`` of each distinct CUDA device of the mesh,
    labeled with its index (ranks that share a card share one reading).
    The CPU has no allocator statistics, so there each rank's bytes are
    those of the params it holds for the sharded segments (its tp pieces
    and its replicated leaves), labeled with the rank's ordinal.  The
    reference attributes ``jax.live_arrays`` to its devices instead."""
    import torch

    def probe() -> dict:
        devices = list(placement.mesh.devices.flat)
        per_dev: dict = {}
        cuda = [d for d in placement.mesh.distinct_devices
                if d.type == "cuda"]
        if cuda:
            for d in cuda:
                stats = torch.cuda.memory_stats(d)
                per_dev[str(d.index if d.index is not None else 0)] = float(
                    stats.get("allocated_bytes.all.current", 0) or 0)
        else:
            per_dev = {str(r): 0.0 for r in range(len(devices))}
            for seg in placement.armed_segments():
                for r, n in enumerate(seg.rank_param_bytes()):
                    per_dev[str(r)] = per_dev.get(str(r), 0.0) + float(n)
        if metrics is not None:
            try:
                for dev, b in per_dev.items():
                    metrics.gauge_set(PLACEMENT_DEVICE_BYTES_GAUGE, b,
                                      {"device": dev})
            except Exception:
                pass
        return {
            "placement_devices": float(len(devices)),
            "placement_segments_sharded":
                float(len(placement.sharded_segments)),
            "placement_sharded_dispatches":
                float(placement.n_sharded_dispatches),
            "placement_device_bytes_max":
                max(per_dev.values(), default=0.0),
        }

    return probe


def device_registry_probe(reg=None) -> Callable[[], dict]:
    def probe() -> dict:
        target = reg
        if target is None:
            from seldon_core_tpu_torch.runtime.device_registry import registry
            target = registry
        return {
            "device_registry_entries": float(len(target)),
            "device_registry_bytes": float(getattr(target, "nbytes", 0)),
        }

    return probe


class RuntimeSampler:
    """Async background sampler with a bounded timeline.

    Lifecycle: ``ensure_started()`` is called lazily from the serving
    path (the constructor runs where no event loop exists yet);
    ``await stop()`` cancels and reaps the task — tests assert no task
    leaks across start/stop cycles.
    """

    def __init__(self, interval_s: float = 1.0, timeline: int = 600,
                 metrics=None, service: str = ""):
        self.interval_s = max(0.001, float(interval_s))
        self.metrics = metrics
        self.service = service
        self._probes: dict[str, Callable[[], dict]] = {}
        self._timeline: deque[dict] = deque(maxlen=max(1, int(timeline)))
        self._lock = threading.Lock()
        self._task: Optional[asyncio.Task] = None
        self._last_lag_ms = 0.0
        self.samples = 0
        self.probe_errors = 0

    # -- probe registration ---------------------------------------------
    def add_probe(self, name: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._probes[name] = fn

    def remove_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    @property
    def probe_names(self) -> list[str]:
        with self._lock:
            return sorted(self._probes)

    # -- lifecycle ------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def ensure_started(self) -> bool:
        """Start the background task if an event loop is running here;
        idempotent, returns whether the sampler is (now) running."""
        if self.running:
            return True
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        self._task = loop.create_task(self._run(), name="health-sampler")
        return True

    async def start(self) -> None:
        self.ensure_started()

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is None or task.done():
            return
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    async def _run(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            # scheduling delay of our own wakeup = event-loop lag
            self._last_lag_ms = max(
                0.0, (time.monotonic() - t0 - self.interval_s) * 1000.0)
            self.sample_once()

    # -- sampling -------------------------------------------------------
    def sample_once(self) -> dict:
        """Run every probe, append one timeline sample, export gauges.
        Callable synchronously (tests, endpoints) as well as from the
        background task."""
        with self._lock:
            probes = dict(self._probes)
        sample: dict = {"ts": time.time(), "probes": {}}
        for name, fn in probes.items():
            try:
                values = fn()
            except Exception:
                self.probe_errors += 1
                continue
            if not values:
                continue
            sample["probes"][name] = values
            self._export(name, values)
        sample["probes"].setdefault("loop", {})[
            "event_loop_lag_ms"] = round(self._last_lag_ms, 3)
        self._export("loop", {"event_loop_lag_ms": self._last_lag_ms})
        with self._lock:
            self._timeline.append(sample)
        self.samples += 1
        if self.metrics is not None:
            try:
                self.metrics.gauge_set(
                    "seldon_runtime_sampler_ticks", self.samples,
                    {"probe": self.service or "sampler"})
            except Exception:
                pass
        return sample

    def _export(self, probe_name: str, values: dict) -> None:
        if self.metrics is None:
            return
        for key, value in values.items():
            gauge = GAUGES.get(key)
            if gauge is None:
                continue
            try:
                self.metrics.gauge_set(gauge, float(value),
                                       {"probe": probe_name})
            except Exception:
                pass

    # -- query ----------------------------------------------------------
    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._timeline[-1] if self._timeline else None

    def timeline(self, n: Optional[int] = None,
                 probe: Optional[str] = None) -> list[dict]:
        """Oldest-first bounded timeline; optionally filtered to one
        probe's series."""
        with self._lock:
            samples = list(self._timeline)
        if n is not None:
            samples = samples[-n:]
        if probe is None:
            return samples
        return [
            {"ts": s["ts"], "probes": {probe: s["probes"][probe]}}
            for s in samples
            if probe in s["probes"]
        ]

    def stats(self) -> dict:
        with self._lock:
            size = len(self._timeline)
        return {
            "running": self.running,
            "intervalMs": round(self.interval_s * 1000.0, 3),
            "samples": self.samples,
            "timeline": size,
            "timelineCap": self._timeline.maxlen,
            "probes": self.probe_names,
            "probeErrors": self.probe_errors,
            "eventLoopLagMs": round(self._last_lag_ms, 3),
        }
