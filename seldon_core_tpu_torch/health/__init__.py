"""Health plane (port of ``seldon_core_tpu/health/``): the always-on
counterpart to sampled tracing.  Three pillars, one subsystem:

1. **Runtime introspection** (:mod:`~seldon_core_tpu_torch.health.introspect`):
   a per-process async sampler snapshotting device memory
   (``torch.cuda.memory_stats``), fused-segment dispatch counters,
   batcher queues, prediction-cache bytes, admission posture, the
   device-tensor registry, the device, artifact and placement planes and
   event-loop lag into bounded timelines — exported as ``seldon_runtime_*`` gauges
   and queryable at ``/admin/introspect``.
2. **Flight recorder** (:mod:`~seldon_core_tpu_torch.health.flightrecorder`):
   a bounded ring of per-request records captured *unconditionally*
   (puid, trace id, route, per-node ms, status, shed/degraded/cache/
   batch flags), queryable at ``/admin/flightrecorder``.
3. **SLO burn-rate monitor** (:mod:`~seldon_core_tpu_torch.health.burnrate`):
   multi-window (5 m/1 h) error-budget evaluation of
   ``seldon.io/slo-p95-ms`` (latency) and ``seldon.io/slo-availability``
   (availability), fused with QoS posture and the profiling plane's
   capture-storm signal into a machine-readable ok/warn/critical verdict
   at ``/admin/health``.

Enabled by ``seldon.io/health: "true"`` or by declaring
``seldon.io/slo-availability``; validated when the deployment loads
(``graph/spec.py health_config``, the reference's messages).
"""

from seldon_core_tpu_torch.health.burnrate import (
    CRITICAL_BURN,
    WARN_BURN,
    WINDOWS,
    BurnRateMonitor,
)
from seldon_core_tpu_torch.health.config import (
    HEALTH_ANNOTATION,
    HEALTH_FLIGHT_RECORDS_ANNOTATION,
    HEALTH_SAMPLE_MS_ANNOTATION,
    HEALTH_TIMELINE_ANNOTATION,
    SLO_AVAILABILITY_ANNOTATION,
    HealthConfig,
    health_config_from_annotations,
)
from seldon_core_tpu_torch.health.flightrecorder import (
    FlightRecorder,
    node_times_scope,
    note_node_time,
)
from seldon_core_tpu_torch.health.introspect import (
    RuntimeSampler,
    batcher_probe,
    cache_probe,
    device_memory_probe,
    device_registry_probe,
    engine_probe,
    placement_probe,
    profile_probe,
    qos_probe,
)
from seldon_core_tpu_torch.health.plane import HealthPlane
from seldon_core_tpu_torch.health.registry import (
    clear,
    publish,
    snapshot,
    unpublish,
)

__all__ = [
    "BurnRateMonitor",
    "CRITICAL_BURN",
    "WARN_BURN",
    "WINDOWS",
    "HEALTH_ANNOTATION",
    "HEALTH_FLIGHT_RECORDS_ANNOTATION",
    "HEALTH_SAMPLE_MS_ANNOTATION",
    "HEALTH_TIMELINE_ANNOTATION",
    "SLO_AVAILABILITY_ANNOTATION",
    "HealthConfig",
    "health_config_from_annotations",
    "FlightRecorder",
    "node_times_scope",
    "note_node_time",
    "RuntimeSampler",
    "batcher_probe",
    "cache_probe",
    "device_memory_probe",
    "device_registry_probe",
    "engine_probe",
    "placement_probe",
    "profile_probe",
    "qos_probe",
    "HealthPlane",
    "publish",
    "unpublish",
    "snapshot",
    "clear",
]
