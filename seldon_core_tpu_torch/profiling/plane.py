"""ProfilePlane (port of ``seldon_core_tpu/profiling/plane.py``): one
object per process/deployment owning the three profiling pillars — host
sampling profiler, capture ledger, per-request cost attribution — plus
the posture the admin surfaces read.

The engine and the gateway each hold a plane; ``/admin/profile/*`` reads
from it, the fused segments report captures into it, and the health
plane consults :meth:`storm_segments` so a capture storm degrades the
``/admin/health`` verdict.
"""

from __future__ import annotations

import time

from seldon_core_tpu_torch.profiling.attribution import CostAttribution
from seldon_core_tpu_torch.profiling.compilewatch import CompileWatch
from seldon_core_tpu_torch.profiling.config import ProfileConfig
from seldon_core_tpu_torch.profiling.hostsampler import HostSampler
from seldon_core_tpu_torch.utils.tracing import warm_device_profile

__all__ = ["ProfilePlane"]


class ProfilePlane:
    def __init__(self, config: ProfileConfig, metrics=None,
                 service: str = "engine", deployment: str = "",
                 clock=time.time):
        self.config = config
        self.metrics = metrics
        self.service = service
        self.deployment = deployment
        self.sampler = HostSampler(
            hz=config.hz, max_stacks=config.stacks, metrics=metrics,
            service=service)
        self.compile = CompileWatch(
            metrics=metrics, storm_threshold=config.storm, clock=clock)
        self.attribution = CostAttribution(
            metrics=metrics, deployment=deployment or service, clock=clock)
        # a capture window's device trace then starts in milliseconds
        warm_device_profile()

    # -- lifecycle ------------------------------------------------------
    def ensure_started(self) -> None:
        """Lazy sampler-thread start from the serving path (same contract
        as HealthPlane.ensure_started)."""
        self.sampler.ensure_started()

    async def aclose(self) -> None:
        self.sampler.stop()

    # -- health-verdict input -------------------------------------------
    def storm_segments(self) -> list[str]:
        return self.compile.storm_segments()

    # -- posture --------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "service": self.service,
            "hz": self.config.hz,
            "sampler": self.sampler.stats(),
            "compile": self.compile.stats(),
            "attribution": self.attribution.stats(),
            "storm": self.storm_segments(),
        }
