"""Fleet plane: so far only its annotations and their parsers, which the
admission lint reads (``analysis/graphlint.py`` GL13xx and GL14xx).  The
replica pool, the routing policies, the autoscaler and the fleet
observer of ``seldon_core_tpu/fleet/`` come with a later slice."""

from seldon_core_tpu_torch.fleet.config import (
    FLEET_AUTOSCALE_ANNOTATION,
    FLEET_COOLDOWN_ANNOTATION,
    FLEET_MAX_ANNOTATION,
    FLEET_MIN_ANNOTATION,
    FLEET_POLICY_ANNOTATION,
    FLEET_REPLICAS_ANNOTATION,
    fleet_config_from_annotations,
)
from seldon_core_tpu_torch.fleet.observe import (
    OBS_AUDIT_ANNOTATION,
    OBS_CONCURRENCY_ANNOTATION,
    OBS_INTERVAL_ANNOTATION,
    OBS_MAD_K_ANNOTATION,
    OBS_TIMEOUT_ANNOTATION,
    observe_config_from_annotations,
)

__all__ = [
    "FLEET_AUTOSCALE_ANNOTATION",
    "FLEET_COOLDOWN_ANNOTATION",
    "FLEET_MAX_ANNOTATION",
    "FLEET_MIN_ANNOTATION",
    "FLEET_POLICY_ANNOTATION",
    "FLEET_REPLICAS_ANNOTATION",
    "fleet_config_from_annotations",
    "OBS_AUDIT_ANNOTATION",
    "OBS_CONCURRENCY_ANNOTATION",
    "OBS_INTERVAL_ANNOTATION",
    "OBS_MAD_K_ANNOTATION",
    "OBS_TIMEOUT_ANNOTATION",
    "observe_config_from_annotations",
]
