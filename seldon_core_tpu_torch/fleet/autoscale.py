"""Fleet autoscaler: replica count from SLO burn + FLOP demand vs capacity.

The first consumer of the observability planes' control signals
(ROADMAP item 3): per-engine attributed-FLOP capacity headroom
(``/admin/profile/capacity`` → observed vs achievable RPS) gives the
demand/capacity ratio; the health plane's SLO burn verdict
(``/admin/health``) is the emergency override — a critical burn scales
up even when the capacity math says the fleet should cope.

Pure decision logic (no I/O, injectable clock): the operator's reconcile
loop and the local harness (``operator/local.py LocalFleet``) both apply
its decisions.  Scale-UP is immediate — shedding load can't wait for a
cooldown; scale-DOWN only after ``cooldown_s`` of calm, so a bursty
drill doesn't flap the fleet.

Port of ``seldon_core_tpu/fleet/autoscale.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

from seldon_core_tpu_torch.fleet.config import FleetConfig

__all__ = ["AutoscaleDecision", "Autoscaler", "TARGET_UTILIZATION"]

#: steady-state utilization the fleet is sized for: demand at 70% of
#: aggregate achievable RPS leaves headroom for bursts and replica loss
TARGET_UTILIZATION = 0.7
#: scale down only when the smaller fleet would still sit below target
#: (hysteresis — without it the fleet oscillates at the boundary)
_DOWN_HYSTERESIS = 0.8


@dataclass(frozen=True)
class AutoscaleDecision:
    desired: int
    current: int
    reason: str

    @property
    def changed(self) -> bool:
        return self.desired != self.current

    def to_dict(self) -> dict:
        return {"desired": self.desired, "current": self.current,
                "reason": self.reason}


class Autoscaler:
    def __init__(self, config: FleetConfig, clock=time.monotonic):
        self.config = config
        self._clock = clock
        self._last_scale = 0.0
        self.last_decision: Optional[AutoscaleDecision] = None

    def _clamp(self, n: int) -> int:
        return max(self.config.min_replicas,
                   min(self.config.max_replicas, n))

    def decide(
        self,
        current: int,
        demand_rps: Optional[float] = None,
        capacity_rps: Optional[float] = None,
        burn_critical: bool = False,
        burn_warn: bool = False,
    ) -> AutoscaleDecision:
        """One tick: ``demand_rps`` is the fleet's observed request rate,
        ``capacity_rps`` its aggregate achievable rate (both from the
        replicas' capacity endpoints); burn flags from the health
        verdicts.  Missing signals hold steady — never scale blind."""
        now = self._clock()
        desired = current
        reason = "steady"
        util = None
        if demand_rps is not None and capacity_rps and capacity_rps > 0:
            util = demand_rps / capacity_rps
            target = self._clamp(
                max(1, math.ceil(current * util / TARGET_UTILIZATION))
            )
            if target > current:
                desired, reason = target, (
                    f"utilization {util:.2f} over target "
                    f"{TARGET_UTILIZATION}"
                )
            elif (target < current and not burn_warn and not burn_critical):
                # hysteresis: only shrink if the SMALLER fleet stays under
                # target, and only after the cooldown
                shrunk_util = (demand_rps / (capacity_rps / current * target)
                               if target else 0.0)
                if shrunk_util <= TARGET_UTILIZATION * _DOWN_HYSTERESIS:
                    if now - self._last_scale >= self.config.cooldown_s:
                        desired, reason = target, (
                            f"utilization {util:.2f} under target; "
                            f"cooldown elapsed"
                        )
                    else:
                        reason = "scale-down held by cooldown"
        if burn_critical:
            # SLO burn overrides the capacity math: add a replica even if
            # utilization looks fine (the burn IS the evidence it isn't)
            up = self._clamp(max(desired, current + 1))
            if up > desired:
                desired, reason = up, "SLO burn critical"
        elif desired == current and util is None:
            reason = "no capacity signal"
        desired = self._clamp(desired)
        if desired != current:
            self._last_scale = now
        decision = AutoscaleDecision(desired=desired, current=current,
                                     reason=reason)
        self.last_decision = decision
        return decision
