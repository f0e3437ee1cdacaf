"""Fleet-plane annotation config (admission-validated; graphlint GL13xx).
Port of ``seldon_core_tpu/fleet/config.py``, unchanged: the pool, the
policies and the autoscaler that read it come with a later slice.

The fleet plane turns the gateway's single ``engine_url`` into a replica
pool (docs/scale-out.md).  Annotations:

- ``seldon.io/fleet-replicas`` — desired engine replica count; setting it
  turns the plane on.  The operator's local harness spawns that many
  in-process engines (``operator/local.py LocalFleet``); on a cluster it
  should match the predictor's ``replicas`` (GL1304 warns on skew).
- ``seldon.io/fleet-policy`` — routing policy: ``least-loaded`` (EWMA of
  in-flight + capacity headroom, the default), ``consistent-hash``
  (locality over the content-addressed cache key), or ``round-robin``.
- ``seldon.io/fleet-autoscale`` — enable the operator autoscale loop
  (SLO burn rate + attributed-FLOP demand vs fleet capacity).
- ``seldon.io/fleet-min-replicas`` / ``seldon.io/fleet-max-replicas`` —
  autoscale bounds (default: min 1, max = fleet-replicas).
- ``seldon.io/fleet-cooldown-s`` — minimum seconds between scale-DOWN
  decisions (scale-up is never delayed; shedding load can't wait).

The parser honors the same contract as ``placement_config_from_annotations``:
raise ``ValueError`` with a path-prefixed, annotation-name-bearing message
on any malformed knob so operator admission (``operator/compile.py
fleet_config``) and graphlint (GL1301) share one validation source.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "FLEET_REPLICAS_ANNOTATION",
    "FLEET_POLICY_ANNOTATION",
    "FLEET_AUTOSCALE_ANNOTATION",
    "FLEET_MIN_ANNOTATION",
    "FLEET_MAX_ANNOTATION",
    "FLEET_COOLDOWN_ANNOTATION",
    "POLICIES",
    "FleetConfig",
    "fleet_config_from_annotations",
]

# -- annotations (validated at admission + graphlint GL13xx) -----------------
FLEET_REPLICAS_ANNOTATION = "seldon.io/fleet-replicas"
FLEET_POLICY_ANNOTATION = "seldon.io/fleet-policy"
FLEET_AUTOSCALE_ANNOTATION = "seldon.io/fleet-autoscale"
FLEET_MIN_ANNOTATION = "seldon.io/fleet-min-replicas"
FLEET_MAX_ANNOTATION = "seldon.io/fleet-max-replicas"
FLEET_COOLDOWN_ANNOTATION = "seldon.io/fleet-cooldown-s"

POLICIES = ("least-loaded", "consistent-hash", "round-robin")


@dataclass(frozen=True)
class FleetConfig:
    enabled: bool = False
    #: desired replica count (the pool's steady-state membership)
    replicas: int = 1
    #: routing policy, one of POLICIES
    policy: str = "least-loaded"
    #: operator autoscale loop on/off
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 1
    #: minimum seconds between scale-down decisions
    cooldown_s: float = 60.0

    @property
    def knobs_set(self) -> bool:
        """Any non-default knob present (graphlint dead-knob check)."""
        return (self.policy != "least-loaded" or self.autoscale
                or self.min_replicas != 1 or self.max_replicas != 1
                or self.cooldown_s != 60.0)


def _parse_int(raw, name: str, at: str, minimum: int = 1) -> int:
    try:
        n = int(str(raw).strip())
    except (TypeError, ValueError):
        raise ValueError(
            f"{name}{at}: {raw!r} is not an integer replica count"
        ) from None
    if n < minimum:
        raise ValueError(f"{name}{at}: {n} must be >= {minimum}")
    return n


def _parse_bool(raw, name: str, at: str) -> bool:
    v = str(raw).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name}{at}: {raw!r} is not a boolean")


def fleet_config_from_annotations(ann: dict, where: str = "") -> FleetConfig:
    """Parse + validate the fleet annotation family; raises ``ValueError``
    with a path-prefixed message on any malformed knob.

    ``seldon.io/fleet-replicas`` absent → plane off (the other knobs, if
    any, are still validated so graphlint can warn about dead knobs)."""
    at = f" at {where}" if where else ""

    policy = "least-loaded"
    raw = ann.get(FLEET_POLICY_ANNOTATION)
    if raw is not None:
        policy = str(raw).strip().lower()
        if policy not in POLICIES:
            raise ValueError(
                f"{FLEET_POLICY_ANNOTATION}{at}: unknown policy {raw!r} "
                f"(expected one of {', '.join(POLICIES)})"
            )

    autoscale = False
    raw = ann.get(FLEET_AUTOSCALE_ANNOTATION)
    if raw is not None:
        autoscale = _parse_bool(raw, FLEET_AUTOSCALE_ANNOTATION, at)

    min_replicas = 1
    raw = ann.get(FLEET_MIN_ANNOTATION)
    if raw is not None:
        min_replicas = _parse_int(raw, FLEET_MIN_ANNOTATION, at)

    cooldown_s = 60.0
    raw = ann.get(FLEET_COOLDOWN_ANNOTATION)
    if raw is not None:
        try:
            cooldown_s = float(str(raw).strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"{FLEET_COOLDOWN_ANNOTATION}{at}: {raw!r} is not a number "
                f"of seconds"
            ) from None
        if cooldown_s < 0:
            raise ValueError(
                f"{FLEET_COOLDOWN_ANNOTATION}{at}: {cooldown_s} must be >= 0"
            )

    raw = ann.get(FLEET_REPLICAS_ANNOTATION)
    enabled = raw is not None
    replicas = (_parse_int(raw, FLEET_REPLICAS_ANNOTATION, at)
                if enabled else 1)

    max_replicas = max(replicas, min_replicas)
    raw = ann.get(FLEET_MAX_ANNOTATION)
    if raw is not None:
        max_replicas = _parse_int(raw, FLEET_MAX_ANNOTATION, at)
    if max_replicas < min_replicas:
        raise ValueError(
            f"{FLEET_MAX_ANNOTATION}{at}: max {max_replicas} < min "
            f"{min_replicas}"
        )
    if enabled and not min_replicas <= replicas <= max_replicas:
        raise ValueError(
            f"{FLEET_REPLICAS_ANNOTATION}{at}: {replicas} outside the "
            f"[{min_replicas}, {max_replicas}] autoscale bounds"
        )
    if not enabled:
        # knobs still validated above; report them via knobs_set
        return FleetConfig(
            enabled=False, policy=policy, autoscale=autoscale,
            min_replicas=min_replicas, max_replicas=max_replicas,
            cooldown_s=cooldown_s,
        )
    return FleetConfig(
        enabled=True, replicas=replicas, policy=policy, autoscale=autoscale,
        min_replicas=min_replicas, max_replicas=max_replicas,
        cooldown_s=cooldown_s,
    )
