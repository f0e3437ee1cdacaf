"""Fleet plane: a multi-replica engine pool behind one gateway.

Scale-out data plane (docs/scale-out.md, ROADMAP item 3): the gateway's
single ``engine_url`` becomes a :class:`ReplicaPool` with health-gated
membership, pluggable routing policies (least-loaded / consistent-hash /
round-robin + SSE session affinity), retry-next-replica on connection
failure, and an operator autoscale loop driven by the SLO burn-rate and
attributed-FLOP capacity signals the observability planes publish.

Port of ``seldon_core_tpu/fleet/``: the same exports.
"""

from seldon_core_tpu_torch.fleet.autoscale import (
    AutoscaleDecision,
    Autoscaler,
    TARGET_UTILIZATION,
)
from seldon_core_tpu_torch.fleet.config import (
    FLEET_AUTOSCALE_ANNOTATION,
    FLEET_COOLDOWN_ANNOTATION,
    FLEET_MAX_ANNOTATION,
    FLEET_MIN_ANNOTATION,
    FLEET_POLICY_ANNOTATION,
    FLEET_REPLICAS_ANNOTATION,
    POLICIES,
    FleetConfig,
    fleet_config_from_annotations,
)
from seldon_core_tpu_torch.fleet.http import fleet_body
from seldon_core_tpu_torch.fleet.observe import (
    OBS_AUDIT_ANNOTATION,
    OBS_CONCURRENCY_ANNOTATION,
    OBS_DISABLED,
    OBS_INTERVAL_ANNOTATION,
    OBS_MAD_K_ANNOTATION,
    OBS_TIMEOUT_ANNOTATION,
    DecisionAudit,
    FleetObserver,
    ObserveConfig,
    decision_audit,
    decisions_body,
    detect_outliers,
    fleet_obs_body,
    observe_config_from_annotations,
    record_decision,
    skew_scores,
)
from seldon_core_tpu_torch.fleet.pool import (
    EJECTED,
    HEALTHY,
    PROBING,
    Replica,
    ReplicaPool,
)
from seldon_core_tpu_torch.fleet.registry import (
    clear,
    publish,
    snapshot,
    unpublish,
)
from seldon_core_tpu_torch.fleet.ring import HashRing

__all__ = [
    "AutoscaleDecision",
    "Autoscaler",
    "TARGET_UTILIZATION",
    "FLEET_AUTOSCALE_ANNOTATION",
    "FLEET_COOLDOWN_ANNOTATION",
    "FLEET_MAX_ANNOTATION",
    "FLEET_MIN_ANNOTATION",
    "FLEET_POLICY_ANNOTATION",
    "FLEET_REPLICAS_ANNOTATION",
    "POLICIES",
    "FleetConfig",
    "fleet_config_from_annotations",
    "fleet_body",
    "OBS_AUDIT_ANNOTATION",
    "OBS_CONCURRENCY_ANNOTATION",
    "OBS_DISABLED",
    "OBS_INTERVAL_ANNOTATION",
    "OBS_MAD_K_ANNOTATION",
    "OBS_TIMEOUT_ANNOTATION",
    "DecisionAudit",
    "FleetObserver",
    "ObserveConfig",
    "decision_audit",
    "decisions_body",
    "detect_outliers",
    "fleet_obs_body",
    "observe_config_from_annotations",
    "record_decision",
    "skew_scores",
    "EJECTED",
    "HEALTHY",
    "PROBING",
    "Replica",
    "ReplicaPool",
    "HashRing",
    "publish",
    "unpublish",
    "snapshot",
    "clear",
]
