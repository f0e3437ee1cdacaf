"""Quality of service (port of ``seldon_core_tpu/qos/``): admission control
against ``seldon.io/slo-p95-ms`` with shedding by priority, deadlines that
ride every hop and bound the walk and the batcher's queue, circuit breakers
around remote nodes, and the ``seldon.io/qos-fallback`` subgraph.
"""

from seldon_core_tpu_torch.qos.admission import (
    AdmissionController,
    AdmissionShedError,
)
from seldon_core_tpu_torch.qos.breaker import (
    BreakerOpenError,
    BreakerWrapper,
    CircuitBreaker,
)
from seldon_core_tpu_torch.qos.context import (
    DEADLINE_HEADER,
    DEADLINE_TAG,
    PRIORITIES,
    PRIORITY_HEADER,
    PRIORITY_TAG,
    Deadline,
    QosContext,
    current_qos,
    qos_from_headers,
    qos_from_meta,
    qos_scope,
    stamp_meta,
)
from seldon_core_tpu_torch.qos.policy import (
    EngineQos,
    QosConfig,
    qos_from_annotations,
)
from seldon_core_tpu_torch.qos.registry import publish, snapshot, unpublish

__all__ = ["AdmissionController", "AdmissionShedError", "BreakerOpenError",
           "BreakerWrapper", "CircuitBreaker", "DEADLINE_HEADER",
           "DEADLINE_TAG", "PRIORITIES", "PRIORITY_HEADER", "PRIORITY_TAG",
           "Deadline", "QosContext", "EngineQos", "QosConfig", "current_qos",
           "qos_from_annotations", "qos_from_headers", "qos_from_meta",
           "qos_scope", "stamp_meta", "publish", "snapshot", "unpublish"]
