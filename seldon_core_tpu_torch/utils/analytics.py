"""Analytics stack generator: metric catalog → Grafana dashboard +
Prometheus scrape/alert config (port of ``seldon_core_tpu/utils/
analytics.py``).

The catalog is CODE — the single source the dashboard, the alerts and the
docs are generated from, so a metric rename cannot silently orphan its
panels.  It lists every metric the port emits and nothing else: the
reference's compile-cache metrics have no counterpart (the port keeps no
compile cache).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# metric catalog — every metric the framework emits (grep-locked by tests)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MetricInfo:
    name: str
    kind: str  # counter | histogram | gauge
    help: str
    labels: tuple = ()


CATALOG: tuple[MetricInfo, ...] = (
    MetricInfo(
        "seldon_api_executor_server_requests_seconds", "histogram",
        "Engine northbound request latency (reference "
        "seldon_api_executor_server_requests_seconds timer, "
        "SeldonRestTemplateExchangeTagsProvider.java:40-141)",
        ("deployment", "predictor"),
    ),
    MetricInfo(
        "seldon_api_executor_client_requests_seconds", "histogram",
        "Per-graph-node southbound latency (model/router/combiner/"
        "transformer calls); status=ok|error so failed calls keep their "
        "latency instead of vanishing from the histogram",
        ("deployment", "predictor", "model_name", "status"),
    ),
    MetricInfo(
        "seldon_api_server_ingress_seconds", "histogram",
        "Gateway ingress latency per deployment (apife "
        "AuthorizedWebMvcTagsProvider parity)",
        ("deployment", "path"),
    ),
    MetricInfo(
        "seldon_api_gateway_retries_total", "counter",
        "Gateway->engine forward retries after connection failures "
        "(apife HttpRetryHandler parity)",
        ("deployment", "path"),
    ),
    MetricInfo(
        "seldon_api_model_feedback_total", "counter",
        "Feedback events per model (reference PredictiveUnitBean.java:283)",
        ("deployment", "model_name"),
    ),
    MetricInfo(
        "seldon_api_model_feedback_reward_total", "counter",
        "Cumulative reward per model (MAB learning signal)",
        ("deployment", "model_name"),
    ),
    MetricInfo(
        "seldon_batcher_batches_total", "counter",
        "Device batches dispatched by the dynamic batcher (no reference "
        "counterpart: the reference has no server-side batching)",
        ("batcher",),
    ),
    MetricInfo(
        "seldon_batcher_batch_rows", "histogram",
        "Rows per dispatched batch (fill efficiency; compare to the "
        "configured max batch)",
        ("batcher",),
    ),
    MetricInfo(
        "seldon_batcher_pad_rows_total", "counter",
        "Padding rows added to reach bucket sizes (wasted device FLOPs)",
        ("batcher",),
    ),
    MetricInfo(
        "seldon_batcher_shed_total", "counter",
        "Requests shed by backpressure (reason=queue_full|deadline)",
        ("batcher", "reason"),
    ),
    MetricInfo(
        "seldon_cache_hits_total", "counter",
        "Prediction-cache hits (gateway raw-body tier + engine "
        "subtree/segment tiers, docs/caching.md; no reference "
        "counterpart — Clipper-style cache)",
        ("cache",),
    ),
    MetricInfo(
        "seldon_cache_misses_total", "counter",
        "Prediction-cache misses (a hit/(hit+miss) ratio panel reads "
        "both)",
        ("cache",),
    ),
    MetricInfo(
        "seldon_cache_evictions_total", "counter",
        "Prediction-cache evictions (reason=bytes under the byte budget, "
        "reason=ttl on expiry)",
        ("cache", "reason"),
    ),
    MetricInfo(
        "seldon_cache_bypass_total", "counter",
        "Requests that took the cold path because their payload could "
        "not be keyed (an object array)",
        ("cache",),
    ),
    MetricInfo(
        "seldon_cache_bytes", "gauge",
        "Prediction-cache resident bytes (fused-plan entries may be "
        "HBM-resident device arrays; the budget bounds those too)",
        ("cache",),
    ),
    MetricInfo(
        "seldon_coalesced_requests_total", "counter",
        "Requests served by riding another request's in-flight "
        "computation (single-flight: N identical arrivals, 1 model "
        "invocation, 1 batch row)",
        ("cache",),
    ),
    MetricInfo(
        "seldon_qos_admitted_total", "counter",
        "Requests admitted by the QoS admission controller "
        "(docs/qos.md; no reference counterpart — the reference has no "
        "overload story beyond probes and retries)",
        ("deployment", "priority"),
    ),
    MetricInfo(
        "seldon_qos_shed_total", "counter",
        "Requests refused by QoS (429 + Retry-After); priority=low sheds "
        "first (DAGOR-style fractions of the adaptive limit)",
        ("deployment", "priority", "reason"),
    ),
    MetricInfo(
        "seldon_qos_concurrency_limit", "gauge",
        "Current AIMD concurrency limit per deployment (learned against "
        "the seldon.io/slo-p95-ms target)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_qos_inflight", "gauge",
        "Requests currently holding an admission slot",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_qos_shed_level", "gauge",
        "Current shed level: 0 none, 1 low sheds, 2 normal sheds, 3 all "
        "shed (the seldon.io/qos-degrade-shed-level trigger reads this)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_qos_breaker_state", "gauge",
        "Circuit-breaker state per remote/duck component: 0 closed, "
        "1 half-open, 2 open",
        ("component",),
    ),
    MetricInfo(
        "seldon_qos_breaker_transitions_total", "counter",
        "Breaker state transitions (to=closed|half_open|open)",
        ("component", "to"),
    ),
    MetricInfo(
        "seldon_qos_degraded_total", "counter",
        "Requests served by the seldon.io/qos-fallback subgraph "
        "(meta.tags.degraded set; reason=breaker_open|shed_level)",
        ("graph", "reason"),
    ),
    MetricInfo(
        "seldon_llm_tokens_generated_total", "counter",
        "Tokens generated by the continuous-batching LLM engine "
        "(runtime/llm.py; no reference counterpart)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_generate_duration_seconds", "histogram",
        "Per-request end-to-end generation latency (custom TIMER "
        "passthrough; milliseconds at source, seconds in exposition)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_tokens_per_second", "gauge",
        "Most recent request's decode throughput",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_spec_accept_rate", "gauge",
        "Speculative decoding draft acceptance rate (engine lifetime)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_prefix_hit_rate", "gauge",
        "Automatic prefix-cache hit rate: auto-prefix hits / admissions "
        "where auto matching was consulted (engine lifetime)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_kv_pages_used_ratio", "gauge",
        "Paged KV cache occupancy (used pages / usable pages; "
        "PagedLLMEngine only)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_preempted", "gauge",
        "Requests preempted by higher-priority admissions under slot/page "
        "pressure (engine lifetime; every preemption resumes and completes "
        "byte-identically)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_admission_shed", "gauge",
        "Requests shed at admission (HTTP 504) because their admit_timeout "
        "deadline expired while waiting for a slot or KV pages (engine "
        "lifetime)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_preempted_total", "gauge",
        "DEPRECATED alias of seldon_llm_preempted, removed next release "
        "(OpenMetrics forbids gauges named *_total)",
        ("model_name",),
    ),
    MetricInfo(
        "seldon_llm_admission_shed_total", "gauge",
        "DEPRECATED alias of seldon_llm_admission_shed, removed next "
        "release (OpenMetrics forbids gauges named *_total)",
        ("model_name",),
    ),
    # -- health plane (docs/observability.md): runtime introspection
    #    sampler, flight recorder, SLO burn monitor ----------------------
    MetricInfo(
        "seldon_runtime_hbm_bytes_in_use", "gauge",
        "Device (HBM) bytes allocated to live tensors and CUDA-graph "
        "pools, from torch.cuda.memory_stats() allocated_bytes "
        "(health-plane introspection sampler; absent on the CPU device)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_hbm_bytes_limit", "gauge",
        "Device (HBM) byte capacity: the card's total memory",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_host_rss_bytes", "gauge",
        "Host resident set size, reported only for the CPU device (a "
        "card never reports host memory as its own)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_event_loop_lag_ms", "gauge",
        "Asyncio event-loop lag measured as sampler sleep overshoot — "
        "the canary for blocking work on the serving hot path "
        "(graphlint RL401 is the static twin)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_jit_segments", "gauge",
        "Fused-plan segments in the serving graph (0 in walk mode)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_jit_segments_compiled", "gauge",
        "Fused segments that have run (n_calls > 0) — compared to "
        "seldon_runtime_jit_segments this exposes warmup coverage",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_jit_dispatches", "gauge",
        "Cumulative fused-segment calls (graph replays, captures and "
        "eager runs)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_queue_rows", "gauge",
        "Rows waiting in a dynamic batcher's lanes at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_queue_lanes", "gauge",
        "Distinct shape/dtype lanes currently queued in a batcher",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_queue_occupancy", "gauge",
        "Queued rows / max_queue_rows (1.0 = backpressure sheds next)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_batch_inflight", "gauge",
        "Device batches currently executing for a batcher",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_batch_latency_ewma_ms", "gauge",
        "Batcher's EWMA of device batch latency (the adaptive max-wait "
        "controller's input)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_cache_bytes", "gauge",
        "Prediction-cache resident bytes as seen by the sampler (the "
        "cache's own seldon_cache_bytes is event-driven; this one lands "
        "on the introspection timeline)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_cache_entries", "gauge",
        "Prediction-cache entry count at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_admission_limit", "gauge",
        "QoS AIMD concurrency limit at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_admission_inflight", "gauge",
        "Admission slots held at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_shed_level", "gauge",
        "QoS shed level at sample time (0 none .. 3 all)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_registry_entries", "gauge",
        "Zero-copy device-buffer registry entries at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_registry_bytes", "gauge",
        "Bytes pinned by the device-buffer registry at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_plane_transfers_avoided", "gauge",
        "Device-plane avoided host transfers (all kinds) at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_plane_bytes_avoided", "gauge",
        "Device-plane avoided transfer bytes (all kinds) at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_plane_remote_refs", "gauge",
        "Device refs minted for remote edges at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_plane_downgrades", "gauge",
        "Device-plane downgrades to the byte wire at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_device_plane_donations", "gauge",
        "One-shot device-ref donations at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_sampler_ticks", "gauge",
        "Introspection samples taken since process start (a flat line "
        "means the sampler died — alert on it, it is the watchdog's "
        "watchdog)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_health_verdict", "gauge",
        "Health verdict per deployment: 0 ok, 1 warn, 2 critical "
        "(/admin/health serves the contributing signals)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_health_burn_rate", "gauge",
        "Error-budget burn rate per SLO objective and window "
        "(slo=availability|latency, window=5m|1h; 1.0 = burning exactly "
        "the budget, 14.4 sustained in both windows = critical)",
        ("deployment", "slo", "window"),
    ),
    MetricInfo(
        "seldon_flightrecorder_records", "gauge",
        "Flight-recorder ring occupancy (bounded at "
        "seldon.io/health-flight-records)",
        ("service",),
    ),
    MetricInfo(
        "seldon_flightrecorder_recorded", "gauge",
        "Requests recorded since process start (recorded - records = "
        "ring overwrites)",
        ("service",),
    ),
    MetricInfo(
        "seldon_metrics_dropped_series_total", "counter",
        "Label series refused by the per-metric cardinality cap "
        "(utils/metrics.py max_series) — a nonzero rate means some "
        "label value is unbounded and that metric is now partial",
        ("metric",),
    ),
    # -- profiling plane (docs/observability.md): host sampling profiler,
    #    capture/cost telemetry, per-request FLOP attribution ------------
    MetricInfo(
        "seldon_profile_samples_total", "counter",
        "Host profiler sampling ticks since process start (profiling/"
        "hostsampler.py; a flat line means the sampler thread died)",
        ("service",),
    ),
    MetricInfo(
        "seldon_profile_stacks", "gauge",
        "Distinct folded stacks in the profiler's bounded table "
        "(at seldon.io/profile-stacks the (other) overflow bucket "
        "starts absorbing new stacks)",
        ("service",),
    ),
    MetricInfo(
        "seldon_profile_windows_open", "gauge",
        "Capture windows currently open via /admin/profile/capture",
        ("service",),
    ),
    MetricInfo(
        "seldon_compile_total", "counter",
        "Fused-segment CUDA-graph captures, labelled by segment and "
        "shape-bucket (rows x cols : dtype) — a high rate on one segment "
        "is a capture storm (each capture runs the segment eagerly, "
        "captures and checks a replay)",
        ("segment", "bucket"),
    ),
    MetricInfo(
        "seldon_compile_wall_ms_total", "counter",
        "Milliseconds spent capturing CUDA graphs per fused segment",
        ("segment",),
    ),
    MetricInfo(
        "seldon_compile_flops", "gauge",
        "FLOPs of a segment's captured shape-bucket, counted once at "
        "capture from the stages' shapes (the per-request attribution "
        "numerator)",
        ("segment", "bucket"),
    ),
    MetricInfo(
        "seldon_compile_bytes_accessed", "gauge",
        "Bytes accessed per segment and shape-bucket, counted at capture "
        "from the stages' shapes (HBM traffic estimate)",
        ("segment", "bucket"),
    ),
    MetricInfo(
        "seldon_compile_peak_hbm_bytes", "gauge",
        "The segment's CUDA-graph pool bytes after a bucket's capture "
        "(the memory its captured buckets hold)",
        ("segment", "bucket"),
    ),
    MetricInfo(
        "seldon_compile_storm", "gauge",
        "1 while a segment is capturing at storm rate (>= "
        "seldon.io/profile-storm captures within the window) — also "
        "degrades the /admin/health verdict to warn",
        ("segment",),
    ),
    MetricInfo(
        "seldon_request_flops_total", "counter",
        "Device FLOPs attributed to completed requests (the bucket's "
        "counted cost x the request's share of each dynamic batch)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_request_hbm_bytes_total", "counter",
        "HBM bytes-accessed attributed to completed requests (same "
        "share accounting as seldon_request_flops_total)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_request_attributed_total", "counter",
        "Requests that received nonzero FLOP attribution (compare to "
        "request rate for attribution coverage)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_runtime_device_occupancy_est", "gauge",
        "Estimated device FLOP occupancy: attributed FLOP rate / device "
        "peak (introspection sampler profile probe; the "
        "/admin/profile/capacity headroom estimate derives from it)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_compiles_total", "gauge",
        "Cumulative segment captures at sample time (sampler twin "
        "of seldon_compile_total)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_recompile_storm", "gauge",
        "1 while any segment is in a capture storm at sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_device_registry_entries", "gauge",
        "Zero-copy device-buffer registry entries (event-driven twin of "
        "the seldon_runtime_* sampler series)",
        (),
    ),
    MetricInfo(
        "seldon_device_registry_bytes", "gauge",
        "Bytes pinned by device-buffer registry entries awaiting "
        "consumption",
        (),
    ),
    MetricInfo(
        "seldon_device_registry_reaped_total", "counter",
        "Registry entries reaped (kind=entry on TTL/capacity eviction, "
        "kind=shm for this process's unconsumed shared-memory exports, "
        "kind=orphan for dead producers' segments swept at boot)",
        ("kind",),
    ),
    MetricInfo(
        "seldon_device_registry_transfer_bytes_total", "counter",
        "Host↔device bytes the registry moved (direction=d2h on "
        "put_shm, direction=h2d on shm resolution) or skipped entirely "
        "(direction=avoided on loopback resolutions that hand back the "
        "HBM handle) — the device plane's transfer ledger",
        ("direction",),
    ),
    # -- device-resident tensor plane (docs/device-plane.md): HBM
    #    handles across interpreter-boundary graph edges ----------------
    MetricInfo(
        "seldon_device_plane_transfers_avoided_total", "counter",
        "Host transfers the device plane skipped (kind=d2h for "
        "device→host materializations, kind=h2d for re-uploads, "
        "kind=copy for defensive host copies replaced by immutable HBM "
        "handles)",
        ("kind",),
    ),
    MetricInfo(
        "seldon_device_plane_bytes_avoided_total", "counter",
        "Bytes those avoided transfers would have moved (same kind "
        "labels as seldon_device_plane_transfers_avoided_total)",
        ("kind",),
    ),
    MetricInfo(
        "seldon_device_plane_remote_refs_total", "counter",
        "Remote graph edges served by a DeviceTensorRef instead of "
        "tensor bytes (mode=loopback for in-process registry refs, "
        "mode=shm for same-host shared-memory staging)",
        ("mode",),
    ),
    MetricInfo(
        "seldon_device_plane_downgrades_total", "counter",
        "Remote edges that fell back to the byte wire (reason="
        "negotiation|foreign-process|resolve-failed|dtype|policy; a "
        "silent downgrade would look exactly like a plane that does "
        "not work — alert on a nonzero rate)",
        ("reason",),
    ),
    MetricInfo(
        "seldon_device_plane_donations_total", "counter",
        "One-shot device refs consumed (the producer's buffer is "
        "donated to the consumer and freed from the registry)",
        (),
    ),
    # -- placement plane (placement/): device meshes, segment placement by
    #    device bytes, dp- and tp-sharded fused-segment execution --------
    MetricInfo(
        "seldon_placement_dispatches_total", "counter",
        "Per-rank executions from sharded fused-segment dispatches (each "
        "sharded dispatch runs rows/dp on every rank of the dp span; the "
        "device label is the rank's ordinal in the mesh)",
        ("deployment", "device"),
    ),
    MetricInfo(
        "seldon_placement_sharded_dispatches_total", "counter",
        "Fused-segment dispatches served by the sharded executor "
        "(compare to seldon_batcher_batches_total for sharding coverage; "
        "a parity-failed bucket serves unsharded and does not count here)",
        ("deployment", "segment"),
    ),
    MetricInfo(
        "seldon_placement_segments", "gauge",
        "Fused segments under placement management for this deployment",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_placement_device_hbm_bytes", "gauge",
        "Planner-estimated device memory load per device (static "
        "signature bytes, sharpened by the capture ledger's graph-pool "
        "peaks once buckets are captured; the /admin/placement "
        "deviceHbmBytes map)",
        ("deployment", "device"),
    ),
    MetricInfo(
        "seldon_placement_tp_spans", "gauge",
        "Fused segments planned as tensor-parallel spans: their "
        "layout-covered weights shard over the mesh's tp axis instead "
        "of replicating (the /admin/placement tpSpans list)",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_placement_tp_bytes_per_device", "gauge",
        "Per-device memory share of one tp-span segment: layout-covered "
        "weight bytes divided by tp plus the replicated remainder, the "
        "number that turns an infeasible segment (GL1204 at tp=1) into a "
        "feasible plan",
        ("deployment", "segment"),
    ),
    MetricInfo(
        "seldon_runtime_placement_devices", "gauge",
        "Mesh size seen by the placement plane at sample time "
        "(introspection sampler placement probe)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_placement_segments_sharded", "gauge",
        "Segments currently serving through the sharded executor at "
        "sample time",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_placement_sharded_dispatches", "gauge",
        "Cumulative sharded dispatches at sample time (sampler twin of "
        "seldon_placement_sharded_dispatches_total)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_placement_device_bytes_max", "gauge",
        "Largest per-device byte count across the mesh at sample time "
        "(skew indicator; per-device detail in "
        "seldon_runtime_placement_device_bytes)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_runtime_placement_device_bytes", "gauge",
        "Bytes per mesh device at sample time (the CUDA allocator's "
        "allocated bytes of each card; on the CPU, the params each rank "
        "holds)",
        ("device",),
    ),
    # -- artifact plane (artifacts/): a record per captured bucket and the
    # kernel library in a content-addressed store, for warm boots
    MetricInfo(
        "seldon_artifact_hydrations_total", "counter",
        "Shape buckets captured at boot from the artifact store's record "
        "(probe digest held) instead of on first sight in traffic",
        ("segment",),
    ),
    MetricInfo(
        "seldon_artifact_publishes_total", "counter",
        "Bucket records published into the artifact store after a live "
        "capture (one cold replica warms the store for the next)",
        ("segment",),
    ),
    MetricInfo(
        "seldon_artifact_misses_total", "counter",
        "Artifact-store lookups that found no record for the segment x "
        "bucket x dtype x mesh x runtime key — each miss is a live "
        "capture on the serving path",
        ("segment",),
    ),
    MetricInfo(
        "seldon_artifact_parity_failures_total", "counter",
        "Stored records quarantined because a capture on the record's "
        "probe input did not reproduce its digest bitwise",
        ("segment",),
    ),
    MetricInfo(
        "seldon_artifact_deserialize_failures_total", "counter",
        "Stored records that failed to parse (corruption, format "
        "drift) — quarantined from the store and served by a live "
        "capture instead",
        ("segment",),
    ),
    MetricInfo(
        "seldon_artifact_store_entries", "gauge",
        "Records currently in the artifact store visible to this "
        "replica",
    ),
    MetricInfo(
        "seldon_artifact_store_bytes", "gauge",
        "Total record bytes in the artifact store (the kernel library "
        "included)",
    ),
    MetricInfo(
        "seldon_artifact_coverage", "gauge",
        "Warm-start coverage: hydrated / (hydrated + live-captured) "
        "buckets since boot (1.0 = fully warm boot, the autoscaler's "
        "warm-before-admit signal)",
    ),
    MetricInfo(
        "seldon_artifact_hydrated", "gauge",
        "Hydrated bucket count at sample time (introspection sampler "
        "artifact probe)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_artifact_live_compiles", "gauge",
        "Live-captured bucket count at sample time (introspection "
        "sampler artifact probe; nonzero on a replica booted against a "
        "populated store means key drift or new traffic shapes)",
        ("probe",),
    ),
    MetricInfo(
        "seldon_compile_hydrated_total", "counter",
        "Capture-ledger rows captured at boot from the artifact store "
        "(hydrations land on the ledger for bucket visibility but never "
        "count as captures or storm events)",
        ("segment", "bucket"),
    ),
    # -- fleet plane (docs/scale-out.md): multi-replica engine pool
    # behind one gateway — capacity-aware routing, health-gated
    # membership, autoscale
    MetricInfo(
        "seldon_fleet_forwards_total", "counter",
        "Requests forwarded to a fleet replica and completed without a "
        "transport failure (per-replica skew shows the routing policy "
        "at work; snapshot at /admin/fleet)",
        ("deployment", "replica"),
    ),
    MetricInfo(
        "seldon_fleet_ejections_total", "counter",
        "Replicas ejected from the healthy pool, by reason "
        "(connect-error, probe-failed, health-critical, breaker-open); "
        "ejected replicas are re-probed half-open before readmission",
        ("deployment", "replica", "reason"),
    ),
    MetricInfo(
        "seldon_fleet_replicas", "gauge",
        "Fleet membership by state (healthy / probing / ejected) for "
        "each deployment's replica pool",
        ("deployment", "state"),
    ),
    # -- fleet observability plane (docs/observability.md#fleet-
    # observability): cross-replica aggregation, straggler detection,
    # decision audit
    MetricInfo(
        "seldon_fleet_obs_verdict", "gauge",
        "Fused fleet health verdict level (0 ok / 1 warn / 2 critical) "
        "from the /admin/fleet/health differential analysis",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_fleet_obs_skew", "gauge",
        "Per-replica robust z-score (MAD multiples from the fleet "
        "median) on each compared dimension — latency, errors, compile "
        "count; the straggler threshold is seldon.io/fleet-obs-mad-k",
        ("deployment", "replica", "dimension"),
    ),
    MetricInfo(
        "seldon_fleet_obs_straggler", "gauge",
        "1 when the replica is currently flagged as a latency/error "
        "straggler (named in the fleet verdict and penalized in "
        "routing), else 0",
        ("deployment", "replica"),
    ),
    MetricInfo(
        "seldon_fleet_obs_unreachable", "gauge",
        "Replicas that failed the last fleet-health scrape (timeout or "
        "refused connect) — reported inside the partial envelope, "
        "never a 500",
        ("deployment",),
    ),
    MetricInfo(
        "seldon_fleet_obs_scrape_seconds", "histogram",
        "Wall time of one bounded scatter-gather scrape across the "
        "fleet, by aggregation endpoint (the admin surface's own "
        "overhead, gated in CI)",
        ("endpoint",),
    ),
)


# ---------------------------------------------------------------------------
# prometheus
# ---------------------------------------------------------------------------


def prometheus_config(scrape_interval: str = "15s",
                      alertmanager: bool = True) -> dict:
    """Scrape config: kubernetes pod discovery keyed on the
    ``prometheus.io/scrape`` annotations the operator stamps
    (compile.py; reference SeldonDeploymentOperatorImpl.java:608-610).

    ``alertmanager=False`` (chart ``--set alertmanager.enabled=false``)
    drops the alerting target and rule file — otherwise Prometheus would
    log a notification-send error for every firing alert, forever."""
    cfg: dict = {"global": {"scrape_interval": scrape_interval}}
    if alertmanager:
        cfg["rule_files"] = ["/etc/prometheus/alerts.yaml"]
        cfg["alerting"] = {
            "alertmanagers": [
                {"static_configs": [{"targets": ["alertmanager:9093"]}]}
            ]
        }
    cfg["scrape_configs"] = _scrape_configs()
    return cfg


def _scrape_configs() -> list:
    return [
            {
                "job_name": "seldon-pods",
                "kubernetes_sd_configs": [{"role": "pod"}],
                "relabel_configs": [
                    {
                        "source_labels":
                            ["__meta_kubernetes_pod_annotation_prometheus_io_scrape"],
                        "action": "keep",
                        "regex": "true",
                    },
                    {
                        "source_labels":
                            ["__meta_kubernetes_pod_annotation_prometheus_io_path"],
                        "action": "replace",
                        "target_label": "__metrics_path__",
                        "regex": "(.+)",
                    },
                    {
                        "source_labels":
                            ["__address__",
                             "__meta_kubernetes_pod_annotation_prometheus_io_port"],
                        "action": "replace",
                        "regex": r"([^:]+)(?::\d+)?;(\d+)",
                        "replacement": r"$1:$2",
                        "target_label": "__address__",
                    },
                    {
                        "source_labels": ["__meta_kubernetes_namespace"],
                        "action": "replace",
                        "target_label": "namespace",
                    },
                    {
                        "source_labels": ["__meta_kubernetes_pod_name"],
                        "action": "replace",
                        "target_label": "pod",
                    },
                ],
            }
    ]


def alert_rules() -> dict:
    """Starter alerts over the catalog (reference analytics ships
    alertmanager with no rules; these cover the serving SLO basics)."""
    return {
        "groups": [
            {
                "name": "seldon-serving",
                "rules": [
                    {
                        "alert": "SeldonHighP99Latency",
                        "expr": (
                            "histogram_quantile(0.99, sum(rate("
                            "seldon_api_executor_server_requests_seconds_bucket"
                            "[5m])) by (le, deployment)) > 1"
                        ),
                        "for": "5m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "p99 predict latency above 1s for "
                                "{{ $labels.deployment }}",
                        },
                    },
                    {
                        "alert": "SeldonBatcherShedding",
                        "expr": (
                            "sum(rate(seldon_batcher_shed_total[5m])) "
                            "by (batcher, reason) > 0"
                        ),
                        "for": "2m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "batcher {{ $labels.batcher }} shedding "
                                "({{ $labels.reason }}) — overloaded",
                        },
                    },
                    {
                        "alert": "SeldonQosHighPriorityShedding",
                        "expr": (
                            "sum(rate(seldon_qos_shed_total"
                            '{priority="high"}[5m])) by (deployment) > 0'
                        ),
                        "for": "2m",
                        "labels": {"severity": "critical"},
                        "annotations": {
                            "summary":
                                "HIGH-priority traffic shedding on "
                                "{{ $labels.deployment }} — capacity "
                                "exhausted past the protected tier",
                        },
                    },
                    {
                        "alert": "SeldonQosBreakerOpen",
                        "expr": "max_over_time(seldon_qos_breaker_state[5m])"
                                " == 2",
                        "for": "1m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "circuit open for component "
                                "{{ $labels.component }} — traffic routing "
                                "to fallback/failing fast",
                        },
                    },
                    {
                        "alert": "SeldonErrorBudgetFastBurn",
                        "expr": (
                            'max(seldon_health_burn_rate{window="5m"}) '
                            "by (deployment, slo) > 14.4 and "
                            'max(seldon_health_burn_rate{window="1h"}) '
                            "by (deployment, slo) > 14.4"
                        ),
                        "for": "2m",
                        "labels": {"severity": "critical"},
                        "annotations": {
                            "summary":
                                "{{ $labels.deployment }} burning "
                                "{{ $labels.slo }} error budget at >14.4x "
                                "in both the 5m and 1h windows — budget "
                                "gone within hours (multiwindow SRE burn "
                                "alert; /admin/health has the signals)",
                        },
                    },
                    {
                        "alert": "SeldonErrorBudgetSlowBurn",
                        "expr": (
                            'max(seldon_health_burn_rate{window="5m"}) '
                            "by (deployment, slo) > 6 and "
                            'max(seldon_health_burn_rate{window="1h"}) '
                            "by (deployment, slo) > 6"
                        ),
                        "for": "15m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "{{ $labels.deployment }} burning "
                                "{{ $labels.slo }} error budget at >6x "
                                "sustained — on track to exhaust the "
                                "monthly budget early",
                        },
                    },
                    {
                        "alert": "SeldonRecompileStorm",
                        "expr": "max by (segment) (seldon_compile_storm)"
                                " > 0",
                        "for": "2m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "segment {{ $labels.segment }} is "
                                "capturing CUDA graphs at storm rate — "
                                "shape/dtype churn is burning device time "
                                "on captures (bucket the inputs or pad to "
                                "the batcher ladder; /admin/profile/"
                                "compile has the per-bucket ledger)",
                        },
                    },
                    {
                        "alert": "SeldonFleetReplicaEjected",
                        "expr": (
                            'sum(seldon_fleet_replicas{state="ejected"}) '
                            "by (deployment) > 0"
                        ),
                        "for": "2m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "fleet replica(s) ejected for "
                                "{{ $labels.deployment }} — pool serving "
                                "below configured width (/admin/fleet has "
                                "per-replica verdicts and ejection reasons)",
                        },
                    },
                    {
                        "alert": "SeldonFleetStraggler",
                        "expr": (
                            "max(seldon_fleet_obs_straggler) "
                            "by (deployment, replica) > 0"
                        ),
                        "for": "5m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "replica {{ $labels.replica }} of "
                                "{{ $labels.deployment }} is a sustained "
                                "straggler — its latency/error profile "
                                "sits past the fleet's MAD threshold and "
                                "routing is penalizing it "
                                "(/admin/fleet/health names the "
                                "dimension; profview --diff its "
                                "/admin/fleet/profile stacks against a "
                                "healthy peer)",
                        },
                    },
                    {
                        "alert": "SeldonGatewayRetrying",
                        "expr": (
                            "sum(rate(seldon_api_gateway_retries_total[5m])) "
                            "by (deployment) > 1"
                        ),
                        "for": "5m",
                        "labels": {"severity": "warning"},
                        "annotations": {
                            "summary":
                                "gateway retrying engine forwards for "
                                "{{ $labels.deployment }} — engine flapping",
                        },
                    },
                ],
            }
        ]
    }


# ---------------------------------------------------------------------------
# grafana
# ---------------------------------------------------------------------------


def _panel(panel_id: int, title: str, exprs, y: int, x: int = 0,
           w: int = 12, unit: Optional[str] = None) -> dict:
    if isinstance(exprs, str):
        exprs = [exprs]
    fieldcfg: dict = {"defaults": {}, "overrides": []}
    if unit:
        fieldcfg["defaults"]["unit"] = unit
    return {
        "id": panel_id,
        "type": "timeseries",
        "title": title,
        "gridPos": {"h": 8, "w": w, "x": x, "y": y},
        "datasource": {"type": "prometheus", "uid": "prometheus"},
        "fieldConfig": fieldcfg,
        "targets": [
            {"expr": e, "refId": chr(ord("A") + i)}
            for i, e in enumerate(exprs)
        ],
    }


def grafana_dashboard() -> dict:
    """The "prediction analytics" dashboard, generated from the catalog
    (reference: seldon-core-analytics' prebuilt dashboard)."""
    panels = [
        _panel(1, "Predict rate (req/s) by deployment",
               "sum(rate(seldon_api_executor_server_requests_seconds_count[1m]))"
               " by (deployment)", y=0, x=0),
        _panel(2, "Predict latency p50/p99",
               ["histogram_quantile(0.50, sum(rate("
                "seldon_api_executor_server_requests_seconds_bucket[5m])) "
                "by (le, deployment))",
                "histogram_quantile(0.99, sum(rate("
                "seldon_api_executor_server_requests_seconds_bucket[5m])) "
                "by (le, deployment))"], y=0, x=12, unit="s"),
        _panel(3, "Per-node southbound latency p99",
               "histogram_quantile(0.99, sum(rate("
               "seldon_api_executor_client_requests_seconds_bucket[5m])) "
               "by (le, model_name))", y=8, x=0, unit="s"),
        _panel(4, "LLM tokens/s and KV pages in use",
               ["sum(seldon_llm_tokens_per_second) by (model_name)",
                "max(seldon_llm_kv_pages_used_ratio) by (model_name)"],
               y=8, x=12),
        _panel(5, "Batch fill (mean rows per batch)",
               "sum(rate(seldon_batcher_batch_rows_sum[5m])) by (batcher) / "
               "sum(rate(seldon_batcher_batch_rows_count[5m])) by (batcher)",
               y=16, x=0),
        _panel(6, "Batcher sheds + gateway retries",
               ["sum(rate(seldon_batcher_shed_total[5m])) by (batcher, reason)",
                "sum(rate(seldon_api_gateway_retries_total[5m])) "
                "by (deployment)"], y=16, x=12),
        _panel(7, "Feedback reward rate",
               "sum(rate(seldon_api_model_feedback_reward_total[5m])) "
               "by (deployment, model_name)", y=24, x=0),
        _panel(8, "Padding overhead (rows/s)",
               "sum(rate(seldon_batcher_pad_rows_total[5m])) by (batcher)",
               y=24, x=12),
        _panel(9, "Prediction-cache hit rate",
               "sum(rate(seldon_cache_hits_total[5m])) by (cache) / "
               "(sum(rate(seldon_cache_hits_total[5m])) by (cache) + "
               "sum(rate(seldon_cache_misses_total[5m])) by (cache))",
               y=32, x=0, unit="percentunit"),
        _panel(10, "Cache coalescing + evictions",
               ["sum(rate(seldon_coalesced_requests_total[5m])) by (cache)",
                "sum(rate(seldon_cache_evictions_total[5m])) "
                "by (cache, reason)"], y=32, x=12),
        _panel(11, "QoS admission: limit, in-flight, shed rate",
               ["seldon_qos_concurrency_limit",
                "seldon_qos_inflight",
                "sum(rate(seldon_qos_shed_total[5m])) "
                "by (deployment, priority, reason)"], y=40, x=0),
        _panel(12, "QoS breakers + degraded traffic",
               ["seldon_qos_breaker_state",
                "sum(rate(seldon_qos_degraded_total[5m])) "
                "by (graph, reason)"], y=40, x=12),
        _panel(13, "SLO error-budget burn rate (5m/1h)",
               ["max(seldon_health_burn_rate) by (deployment, slo, window)",
                "max(seldon_health_verdict) by (deployment)"],
               y=48, x=0),
        _panel(14, "Device memory (allocated / total; host RSS)",
               ["max(seldon_runtime_hbm_bytes_in_use) by (probe)",
                "max(seldon_runtime_hbm_bytes_limit) by (probe)",
                "max(seldon_runtime_host_rss_bytes) by (probe)"],
               y=48, x=12, unit="bytes"),
        _panel(15, "Batch queue depth + event-loop lag",
               ["sum(seldon_runtime_queue_rows) by (probe)",
                "max(seldon_runtime_queue_occupancy) by (probe)",
                "max(seldon_runtime_event_loop_lag_ms) by (probe)"],
               y=56, x=0),
        _panel(16, "CUDA-graph captures + capture storms",
               ["sum(rate(seldon_compile_total[5m])) by (segment)",
                "max(seldon_compile_storm) by (segment)",
                "sum(rate(seldon_compile_wall_ms_total[5m])) by (segment)"],
               y=56, x=12),
        _panel(17, "Attributed device FLOPs (per deployment)",
               ["sum(rate(seldon_request_flops_total[5m])) by (deployment)",
                "sum(rate(seldon_request_hbm_bytes_total[5m])) "
                "by (deployment)"], y=64, x=0),
        _panel(18, "Device occupancy estimate",
               "max(seldon_runtime_device_occupancy_est) by (probe)",
               y=64, x=12, unit="percentunit"),
        _panel(19, "Device plane: avoided transfer bytes + remote refs",
               ["sum(rate(seldon_device_plane_bytes_avoided_total[5m])) "
                "by (kind)",
                "sum(rate(seldon_device_plane_remote_refs_total[5m])) "
                "by (mode)"], y=72, x=0, unit="bytes"),
        _panel(20, "Device plane: downgrades + registry transfer ledger",
               ["sum(rate(seldon_device_plane_downgrades_total[5m])) "
                "by (reason)",
                "sum(rate("
                "seldon_device_registry_transfer_bytes_total[5m])) "
                "by (direction)"], y=72, x=12),
        _panel(21, "Artifact store: warm coverage + hydrations",
               ["max(seldon_artifact_coverage)",
                "sum(rate(seldon_artifact_hydrations_total[5m])) "
                "by (segment)"], y=80, x=0),
        _panel(22, "Gateway ingress latency p99",
               "histogram_quantile(0.99, sum(rate("
               "seldon_api_server_ingress_seconds_bucket[5m])) "
               "by (le, deployment))", y=80, x=12, unit="s"),
        _panel(23, "Fleet forwards by replica (req/s)",
               "sum(rate(seldon_fleet_forwards_total[5m])) "
               "by (deployment, replica)", y=88, x=0),
        _panel(24, "Fleet membership + ejections",
               ["sum(seldon_fleet_replicas) by (deployment, state)",
                "sum(rate(seldon_fleet_ejections_total[5m])) "
                "by (deployment, replica, reason)"], y=88, x=12),
        _panel(25, "Fleet skew (MADs from fleet median, by replica)",
               ["max(seldon_fleet_obs_skew) "
                "by (deployment, replica, dimension)",
                "max(seldon_fleet_obs_straggler) by (deployment, replica)"],
               y=96, x=0),
        _panel(26, "Fleet verdict + unreachable replicas",
               ["max(seldon_fleet_obs_verdict) by (deployment)",
                "max(seldon_fleet_obs_unreachable) by (deployment)"],
               y=96, x=12),
        _panel(27, "Placement: tp spans + sharded dispatch rate",
               ["sum(seldon_placement_tp_spans) by (deployment)",
                "sum(rate(seldon_placement_sharded_dispatches_total[5m])) "
                "by (deployment, segment)"], y=104, x=0),
        _panel(28, "Placement: per-device memory (tp-span share)",
               ["max(seldon_placement_device_hbm_bytes) "
                "by (deployment, device)",
                "max(seldon_placement_tp_bytes_per_device) "
                "by (deployment, segment)"], y=104, x=12, unit="bytes"),
    ]
    return {
        "title": "Seldon Core TPU (PyTorch/CUDA port) — Prediction "
                 "Analytics",
        "uid": "seldon-core-tpu-torch",
        "schemaVersion": 39,
        "tags": ["seldon", "cuda"],
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "panels": panels,
    }


def metric_docs() -> str:
    """docs/analytics.md content (reference docs/analytics.md)."""
    lines = [
        "# Metrics catalog",
        "",
        "Generated from `seldon_core_tpu_torch/utils/analytics.py` CATALOG "
        "— do not edit by hand (`python -m "
        "seldon_core_tpu_torch.utils.analytics docs`).",
        "",
        "| Metric | Type | Labels | Description |",
        "|---|---|---|---|",
    ]
    for m in CATALOG:
        lines.append(
            f"| `{m.name}` | {m.kind} | {', '.join(m.labels) or '—'} "
            f"| {m.help} |"
        )
    lines += [
        "",
        "Custom component metrics (COUNTER/GAUGE/TIMER returned from a "
        "component's `metrics()`) flow through the engine registry under "
        "their own names (reference `CustomMetricsManager.java:30-43`, "
        "`docs/custom_metrics.md`).",
        "",
        "When tracing is enabled ([docs/observability.md](observability.md)),"
        " latency histograms attach the current request's trace ID to the "
        "bucket the observation landed in as an OpenMetrics exemplar "
        "(`# {trace_id=\"...\"}`), so a latency spike on any dashboard panel "
        "deep-links to a concrete trace in `/trace`.",
    ]
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="emit analytics artifacts")
    ap.add_argument("what", choices=["dashboard", "prometheus", "alerts",
                                     "docs"])
    args = ap.parse_args(argv)
    # the scrape config and the alerts as JSON, which every YAML reader
    # reads (the port carries no YAML writer)
    docs = {"dashboard": grafana_dashboard, "prometheus": prometheus_config,
            "alerts": alert_rules}
    if args.what in docs:
        print(json.dumps(docs[args.what](), indent=2))
    else:
        print(metric_docs())


if __name__ == "__main__":
    main()
