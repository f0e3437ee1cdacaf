"""QoS policy: the annotations and one predictor's live QoS state (port of
``seldon_core_tpu/qos/policy.py``).

``seldon.io/slo-p95-ms`` and the ``seldon.io/qos-*`` annotations become a
:class:`QosConfig` (:func:`qos_from_annotations`); the runner builds an
:class:`EngineQos` from it, which owns the admission controller, the
breakers of the remote nodes and the decision to serve the fallback
subgraph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from seldon_core_tpu_torch.qos.admission import (
    AdmissionConfig,
    AdmissionController,
)
from seldon_core_tpu_torch.qos.breaker import BreakerConfig, CircuitBreaker

__all__ = ["SLO_P95_ANNOTATION", "FALLBACK_ANNOTATION",
           "DEGRADE_LEVEL_ANNOTATION", "BREAKER_ANNOTATION", "QosConfig",
           "EngineQos", "qos_from_annotations"]

SLO_P95_ANNOTATION = "seldon.io/slo-p95-ms"
FALLBACK_ANNOTATION = "seldon.io/qos-fallback"
#: the shed level at which the fallback serves (1: low sheds, 2: normal
#: sheds, 3: high sheds)
DEGRADE_LEVEL_ANNOTATION = "seldon.io/qos-degrade-shed-level"
BREAKER_ANNOTATION = "seldon.io/qos-breaker"
BREAKER_MIN_CALLS_ANNOTATION = "seldon.io/qos-breaker-min-calls"
BREAKER_OPEN_MS_ANNOTATION = "seldon.io/qos-breaker-open-ms"
BREAKER_SLOW_MS_ANNOTATION = "seldon.io/qos-breaker-slow-ms"

_TRUE = ("1", "true", "yes")
_FALSE = ("", "0", "false", "no")


@dataclass
class QosConfig:
    name: str = ""
    slo_p95_ms: float = 0.0          # 0: no admission control
    fallback_node: str = ""          # "": no fallback subgraph
    degrade_shed_level: int = 2      # degrade once `normal` sheds
    breakers_enabled: bool = True
    breaker: BreakerConfig = field(default_factory=BreakerConfig)

    @property
    def admission_enabled(self) -> bool:
        return self.slo_p95_ms > 0


def _num(ann: dict, key: str, kind=float):
    raw = ann.get(key)
    if raw is None or str(raw).strip() == "":
        return None
    try:
        return kind(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(f"annotation {key} must be a {kind.__name__}, got "
                         f"{raw!r}") from None


def qos_from_annotations(ann: dict, name: str) -> Optional[QosConfig]:
    """The annotations as a validated :class:`QosConfig`, or None when QoS
    is off.  It is on when an SLO target, a fallback node or
    ``seldon.io/qos-breaker: "true"`` is given.  Invalid values raise
    ``ValueError``."""
    slo = _num(ann, SLO_P95_ANNOTATION)
    if slo is not None and slo <= 0:
        raise ValueError(
            f"annotation {SLO_P95_ANNOTATION} must be > 0, got {slo:g}")
    fallback = str(ann.get(FALLBACK_ANNOTATION, "") or "").strip()
    raw_breaker = str(ann.get(BREAKER_ANNOTATION, "")).strip().lower()
    if raw_breaker not in _TRUE + _FALSE:
        raise ValueError(f"annotation {BREAKER_ANNOTATION} must be a "
                         f"boolean, got {raw_breaker!r}")
    if slo is None and not fallback and raw_breaker not in _TRUE:
        return None
    level = _num(ann, DEGRADE_LEVEL_ANNOTATION, int)
    if level is not None and not 1 <= level <= 3:
        raise ValueError(f"annotation {DEGRADE_LEVEL_ANNOTATION} must be "
                         f"1..3, got {level}")
    breaker = BreakerConfig()
    min_calls = _num(ann, BREAKER_MIN_CALLS_ANNOTATION, int)
    if min_calls is not None:
        if min_calls < 1:
            raise ValueError(f"annotation {BREAKER_MIN_CALLS_ANNOTATION} "
                             f"must be >= 1, got {min_calls}")
        breaker.min_calls = min_calls
    open_ms = _num(ann, BREAKER_OPEN_MS_ANNOTATION)
    if open_ms is not None:
        if open_ms <= 0:
            raise ValueError(f"annotation {BREAKER_OPEN_MS_ANNOTATION} must "
                             f"be > 0, got {open_ms:g}")
        breaker.open_s = open_ms / 1000.0
    slow_ms = _num(ann, BREAKER_SLOW_MS_ANNOTATION)
    if slow_ms is not None:
        if slow_ms < 0:
            raise ValueError(f"annotation {BREAKER_SLOW_MS_ANNOTATION} must "
                             f"be >= 0, got {slow_ms:g}")
        breaker.slow_ms = slow_ms
    return QosConfig(
        name=name, slo_p95_ms=slo or 0.0, fallback_node=fallback,
        degrade_shed_level=level if level is not None else 2,
        breakers_enabled=raw_breaker not in ("0", "false", "no"),
        breaker=breaker)


class EngineQos:
    """One predictor's live QoS state: admission, breakers, degrade."""

    def __init__(self, config: QosConfig, metrics=None):
        self.config = config
        self.metrics = metrics
        self.admission: Optional[AdmissionController] = None
        if config.admission_enabled:
            self.admission = AdmissionController(
                AdmissionConfig(target_p95_ms=config.slo_p95_ms),
                name=config.name, metrics=metrics)
        self.breakers: list[CircuitBreaker] = []

    def make_breaker(self, component: str) -> CircuitBreaker:
        """A breaker for one component's client, kept for the degrade
        decision and the snapshot."""
        b = CircuitBreaker(self.config.breaker, name=component,
                           metrics=self.metrics)
        self.breakers.append(b)
        return b

    def open_breakers(self) -> list[str]:
        return [b.name for b in self.breakers if b.state != "closed"]

    @property
    def shed_level(self) -> int:
        return self.admission.shed_level if self.admission else 0

    def should_degrade(self) -> Optional[str]:
        """Why the fallback should serve (``breaker_open``,
        ``shed_level``), or None."""
        if not self.config.fallback_node:
            return None
        if self.open_breakers():
            return "breaker_open"
        if self.admission is not None and \
                self.shed_level >= self.config.degrade_shed_level:
            return "shed_level"
        return None

    def snapshot(self) -> dict:
        out: dict = {"shedLevel": self.shed_level}
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.breakers:
            out["breakers"] = [b.snapshot() for b in self.breakers]
            out["openBreakers"] = self.open_breakers()
        if self.config.fallback_node:
            out["fallback"] = self.config.fallback_node
            out["degraded"] = self.should_degrade() or ""
        return out
