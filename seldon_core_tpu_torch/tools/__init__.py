"""Test and load tooling (port of ``seldon_core_tpu/tools/``).

- :mod:`~seldon_core_tpu_torch.tools.contract`: contract-driven request
  generation.
- :mod:`~seldon_core_tpu_torch.tools.tester`: component and external-API
  testers.
- :mod:`~seldon_core_tpu_torch.tools.loadtest`: async socket load harness
  over REST, SSE, gRPC and the framed wire.
- :mod:`~seldon_core_tpu_torch.tools.chaos`: fault injection for graph
  components.
- :mod:`~seldon_core_tpu_torch.tools.replay`: flight-recorder replay and
  response parity.
- :mod:`~seldon_core_tpu_torch.tools.traceview`,
  :mod:`~seldon_core_tpu_torch.tools.profview`,
  :mod:`~seldon_core_tpu_torch.tools.fleetview`: text viewers of the
  ``/trace``, ``/admin/profile*`` and ``/admin/fleet*`` bodies.

CLI: ``python -m seldon_core_tpu_torch.tools {contract-test,api-test,load,
save-model,firehose-tail}``.
"""

from seldon_core_tpu_torch.tools.chaos import ChaosError, ChaosPolicy, ChaosWrapper
from seldon_core_tpu_torch.tools.contract import Contract, FeatureDef, validate_response
from seldon_core_tpu_torch.tools.loadtest import (
    FramedDriver,
    GrpcDriver,
    LoadResult,
    RestDriver,
    oauth_token,
    run_load,
)
from seldon_core_tpu_torch.tools.tester import TestReport, test_api, test_component

__all__ = [
    "ChaosError",
    "ChaosPolicy",
    "ChaosWrapper",
    "Contract",
    "FeatureDef",
    "validate_response",
    "LoadResult",
    "RestDriver",
    "GrpcDriver",
    "FramedDriver",
    "oauth_token",
    "run_load",
    "TestReport",
    "test_api",
    "test_component",
]
