"""HealthPlane (port of ``seldon_core_tpu/health/plane.py``): one object
per process/deployment owning the three health pillars (sampler, flight recorder, burn monitor) plus the
verdict that fuses them.

The engine and the gateway each hold a plane; ``/admin/health``,
``/admin/introspect`` and ``/admin/flightrecorder`` read from it, the
reconcile loop snapshots it into ``status.health`` via
``health/registry.py``, and the analytics stack alerts on the
``seldon_health_*`` gauges it exports.
"""

from __future__ import annotations

import time
from typing import Optional

from seldon_core_tpu_torch.health.burnrate import BurnRateMonitor
from seldon_core_tpu_torch.health.config import HealthConfig
from seldon_core_tpu_torch.health.flightrecorder import FlightRecorder
from seldon_core_tpu_torch.health.introspect import RuntimeSampler

__all__ = ["HealthPlane"]

_VERDICT_GAUGE = "seldon_health_verdict"
_BURN_GAUGE = "seldon_health_burn_rate"


class HealthPlane:
    def __init__(self, config: HealthConfig, metrics=None,
                 service: str = "engine", deployment: str = "",
                 clock=time.time):
        self.config = config
        self.metrics = metrics
        self.service = service
        self.deployment = deployment
        self.recorder = FlightRecorder(config.flight_records,
                                       service=service, metrics=metrics)
        self.monitor = BurnRateMonitor(
            slo_p95_ms=config.slo_p95_ms,
            slo_availability=config.slo_availability, clock=clock)
        self.sampler = RuntimeSampler(
            interval_s=config.sample_ms / 1000.0, timeline=config.timeline,
            metrics=metrics, service=service)
        #: optional EngineQos ref — shed level / open breakers become
        #: contributing warn signals in the verdict
        self.qos = None
        #: optional ProfilePlane ref — a capture storm (profiling/
        #: compilewatch.py) becomes a contributing warn signal too: each
        #: CUDA-graph capture of a new shape runs the segment eagerly,
        #: captures and checks a replay, so shape churn degrades the
        #: verdict before latency SLOs notice
        self.profiler = None

    # -- lifecycle ------------------------------------------------------
    def ensure_started(self) -> None:
        """Lazy sampler start from the (async) serving path."""
        self.sampler.ensure_started()

    async def aclose(self) -> None:
        await self.sampler.stop()

    # -- verdict --------------------------------------------------------
    def verdict(self) -> dict:
        """Burn-rate verdict fused with live QoS posture and the
        profiling plane's recompile-storm signal; also exports the
        ``seldon_health_*`` gauges."""
        out = self.monitor.verdict()
        level = out["level"]
        signals = list(out["signals"])
        if self.qos is not None:
            try:
                shed = int(getattr(self.qos, "shed_level", 0))
                open_breakers = list(getattr(self.qos, "open_breakers",
                                             lambda: [])())
            except Exception:
                shed, open_breakers = 0, []
            if shed > 0:
                level = max(level, 1)
                signals.append(f"shed-level-{shed}")
            if open_breakers:
                level = max(level, 1)
                signals.append("breaker-open")
                out["openBreakers"] = open_breakers
        if self.profiler is not None:
            try:
                storm = list(self.profiler.storm_segments())
            except Exception:
                storm = []
            if storm:
                level = max(level, 1)
                signals.append("recompile-storm")
                out["recompileStorm"] = storm
        out["level"] = level
        out["verdict"] = ("ok", "warn", "critical")[level]
        out["signals"] = signals
        out["service"] = self.service
        if self.deployment:
            out["deployment"] = self.deployment
        self._export(out)
        return out

    def _export(self, verdict: dict) -> None:
        if self.metrics is None:
            return
        try:
            dep = {"deployment": self.deployment or self.service}
            self.metrics.gauge_set(_VERDICT_GAUGE, verdict["level"], dep)
            for objective, rates in verdict.get("burn", {}).items():
                for window, rate in rates.items():
                    self.metrics.gauge_set(
                        _BURN_GAUGE, rate,
                        {**dep, "slo": objective, "window": window})
        except Exception:
            pass

    # -- control-plane snapshot (status.health) -------------------------
    def snapshot(self) -> dict:
        """Compact posture for the CR's ``status.health`` block."""
        v = self.verdict()
        return {
            "verdict": v["verdict"],
            "signals": v["signals"],
            "slo": v["slo"],
            "burn": v.get("burn", {}),
            "sampler": self.sampler.stats(),
            "flightRecorder": self.recorder.stats(),
        }

    # -- convenience ----------------------------------------------------
    def note_request(self, latency_ms: float, status: int) -> None:
        """Feed the burn monitor (5xx counts against availability)."""
        self.monitor.observe(latency_ms, error=status >= 500)

    @staticmethod
    def worst(planes: list["HealthPlane"]) -> Optional[str]:
        """Worst verdict across planes (deployment-level rollup)."""
        levels = [p.verdict()["level"] for p in planes]
        if not levels:
            return None
        return ("ok", "warn", "critical")[max(levels)]
