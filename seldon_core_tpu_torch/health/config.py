"""Health-plane annotation config (admission-validated; graphlint GL10xx).

The ``seldon.io/health*`` family turns on the always-on observability
plane (docs/observability.md): the runtime introspection sampler, the
request flight recorder, and the SLO burn-rate monitor.  The plane is
enabled either explicitly (``seldon.io/health: "true"``) or implicitly
by declaring an availability objective (``seldon.io/slo-availability``)
— mirroring how ``seldon.io/slo-p95-ms`` turns on QoS admission control.

The parser honors the same contract as ``qos_from_annotations`` and
``trace_config_from_annotations``: raise ``ValueError`` with a
path-prefixed, annotation-name-bearing message on any malformed knob so
operator admission (``operator/compile.py health_config``) and graphlint
(GL1001) share one validation source.

A copy of ``seldon_core_tpu/health/config.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "HEALTH_ANNOTATION",
    "HEALTH_SAMPLE_MS_ANNOTATION",
    "HEALTH_TIMELINE_ANNOTATION",
    "HEALTH_FLIGHT_RECORDS_ANNOTATION",
    "SLO_AVAILABILITY_ANNOTATION",
    "SLO_P95_ANNOTATION",
    "HealthConfig",
    "health_config_from_annotations",
]

# -- annotations (validated at admission + graphlint GL10xx) -----------------
HEALTH_ANNOTATION = "seldon.io/health"
HEALTH_SAMPLE_MS_ANNOTATION = "seldon.io/health-sample-ms"
HEALTH_TIMELINE_ANNOTATION = "seldon.io/health-timeline"
HEALTH_FLIGHT_RECORDS_ANNOTATION = "seldon.io/health-flight-records"
SLO_AVAILABILITY_ANNOTATION = "seldon.io/slo-availability"
# Shared with the QoS family (qos/policy.py) — the latency SLO both sheds
# against (admission control) and burns against (this plane's monitor).
SLO_P95_ANNOTATION = "seldon.io/slo-p95-ms"

_TRUE = ("1", "true", "yes")
_FALSE = ("", "0", "false", "no")


@dataclass(frozen=True)
class HealthConfig:
    enabled: bool = False
    #: introspection sampler interval (ms)
    sample_ms: float = 1000.0
    #: bounded in-memory timeline length (samples kept per process)
    timeline: int = 600
    #: flight-recorder ring capacity (requests kept per process)
    flight_records: int = 1024
    #: availability objective in (0, 1), e.g. 0.999; None = latency-only
    slo_availability: Optional[float] = None
    #: latency objective (ms) shared with QoS; None = availability-only
    slo_p95_ms: Optional[float] = None


def health_config_from_annotations(ann: dict,
                                   where: str = "") -> HealthConfig:
    """Parse + validate the health annotation family; raises ``ValueError``
    with a path-prefixed message on any malformed knob."""
    at = f" at {where}" if where else ""

    flag = str(ann.get(HEALTH_ANNOTATION,
                       os.environ.get("SELDON_HEALTH", ""))).lower()
    if flag not in _TRUE and flag not in _FALSE:
        raise ValueError(
            f"{HEALTH_ANNOTATION}{at}: {flag!r} is not a boolean "
            f"(use one of {_TRUE + _FALSE[1:]})"
        )

    raw = ann.get(SLO_AVAILABILITY_ANNOTATION,
                  os.environ.get("SELDON_SLO_AVAILABILITY"))
    slo_availability = None
    if raw is not None and str(raw) != "":
        try:
            slo_availability = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{SLO_AVAILABILITY_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if not 0.0 < slo_availability < 1.0:
            raise ValueError(
                f"{SLO_AVAILABILITY_ANNOTATION}{at}: {slo_availability} "
                f"outside (0, 1) — an objective of 1.0 leaves no error "
                f"budget to burn"
            )

    # An availability objective implies monitoring, the same way
    # seldon.io/slo-p95-ms implies admission control.
    enabled = flag in _TRUE or slo_availability is not None

    raw = ann.get(HEALTH_SAMPLE_MS_ANNOTATION,
                  os.environ.get("SELDON_HEALTH_SAMPLE_MS"))
    sample_ms = 1000.0
    if raw is not None:
        try:
            sample_ms = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{HEALTH_SAMPLE_MS_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if sample_ms <= 0:
            raise ValueError(
                f"{HEALTH_SAMPLE_MS_ANNOTATION}{at}: must be > 0"
            )

    raw = ann.get(HEALTH_TIMELINE_ANNOTATION)
    timeline = 600
    if raw is not None:
        try:
            timeline = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{HEALTH_TIMELINE_ANNOTATION}{at}: {raw!r} is not an integer"
            ) from None
        if timeline <= 0:
            raise ValueError(f"{HEALTH_TIMELINE_ANNOTATION}{at}: must be > 0")

    raw = ann.get(HEALTH_FLIGHT_RECORDS_ANNOTATION)
    flight_records = 1024
    if raw is not None:
        try:
            flight_records = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{HEALTH_FLIGHT_RECORDS_ANNOTATION}{at}: {raw!r} is not "
                f"an integer"
            ) from None
        if flight_records <= 0:
            raise ValueError(
                f"{HEALTH_FLIGHT_RECORDS_ANNOTATION}{at}: must be > 0"
            )

    # The latency SLO is owned (and strictly validated) by the QoS family;
    # here it only parameterises the burn monitor, but a malformed value
    # still names the annotation it came from.
    raw = ann.get(SLO_P95_ANNOTATION)
    slo_p95_ms = None
    if raw is not None:
        try:
            slo_p95_ms = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"{SLO_P95_ANNOTATION}{at}: {raw!r} is not a number"
            ) from None
        if slo_p95_ms <= 0:
            raise ValueError(f"{SLO_P95_ANNOTATION}{at}: must be > 0")

    return HealthConfig(enabled=enabled, sample_ms=sample_ms,
                        timeline=timeline, flight_records=flight_records,
                        slo_availability=slo_availability,
                        slo_p95_ms=slo_p95_ms)
