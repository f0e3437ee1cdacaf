"""Placement-plane annotation config (admission-validated; graphlint GL12xx).
Port of ``seldon_core_tpu/placement/config.py``, unchanged but for
``AXIS_ORDER``, which the reference takes from ``parallel/mesh.py``
(a module that imports jax) and the port keeps here.

Two annotations drive the plane (docs/sharding.md):

- ``seldon.io/mesh`` — the device-mesh spec, a comma-separated list of
  ``axis=size`` pairs over the parallel-layer axes (``dp``, ``pp``,
  ``tp``), e.g. ``"dp=4"`` or ``"dp=2,tp=2"``.  Setting it turns the
  plane on: the mesh manager builds a device mesh with those axes, the
  planner assigns every fused segment a device, and segments
  with shardable batch dims execute one sharded dispatch over ``dp``.
- ``seldon.io/placement`` — explicit per-segment device overrides, a
  comma-separated list of ``segment=device`` pairs (device is the
  ordinal inside the mesh), e.g. ``"mean=0,head=3"``.  Overridden
  segments skip the greedy HBM bin-pack.

The parser honors the same contract as ``profile_config_from_annotations``:
raise ``ValueError`` with a path-prefixed, annotation-name-bearing message
on any malformed knob so operator admission (``operator/compile.py
placement_config``) and graphlint (GL1201) share one validation source.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "MESH_ANNOTATION",
    "PLACEMENT_ANNOTATION",
    "PlacementConfig",
    "placement_config_from_annotations",
]

#: the parallel-layer mesh axes, outermost first (``parallel/mesh.py`` of
#: the reference)
AXIS_ORDER = ("dp", "pp", "tp")

# -- annotations (validated at admission + graphlint GL12xx) -----------------
MESH_ANNOTATION = "seldon.io/mesh"
PLACEMENT_ANNOTATION = "seldon.io/placement"


@dataclass(frozen=True)
class PlacementConfig:
    enabled: bool = False
    #: axis sizes in AXIS_ORDER; unnamed axes are 1
    dp: int = 1
    pp: int = 1
    tp: int = 1
    #: explicit (segment name → device ordinal) placements
    overrides: tuple = field(default_factory=tuple)

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp}

    def spec(self) -> str:
        """Canonical mesh-spec string (size-1 axes elided)."""
        parts = [f"{a}={s}" for a, s in self.axis_sizes().items() if s > 1]
        return ",".join(parts) or "dp=1"

    def override_map(self) -> dict[str, int]:
        return dict(self.overrides)


def _parse_mesh_spec(raw: str, at: str) -> dict[str, int]:
    sizes: dict[str, int] = {}
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        axis, sep, size = part.partition("=")
        axis = axis.strip().lower()
        if not sep:
            raise ValueError(
                f"{MESH_ANNOTATION}{at}: {part!r} is not an axis=size pair "
                f"(e.g. \"dp=4\" or \"dp=2,tp=2\")"
            )
        if axis not in AXIS_ORDER:
            raise ValueError(
                f"{MESH_ANNOTATION}{at}: unknown mesh axis {axis!r} "
                f"(expected one of {', '.join(AXIS_ORDER)})"
            )
        if axis in sizes:
            raise ValueError(
                f"{MESH_ANNOTATION}{at}: axis {axis!r} given twice"
            )
        try:
            n = int(size.strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"{MESH_ANNOTATION}{at}: {size.strip()!r} is not an "
                f"integer size for axis {axis!r}"
            ) from None
        if n < 1:
            raise ValueError(
                f"{MESH_ANNOTATION}{at}: axis {axis}={n} must be >= 1"
            )
        sizes[axis] = n
    if not sizes:
        raise ValueError(
            f"{MESH_ANNOTATION}{at}: empty mesh spec (e.g. \"dp=4\")"
        )
    return sizes


def _parse_overrides(raw: str, at: str) -> tuple:
    out: list[tuple[str, int]] = []
    seen: set[str] = set()
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        seg, sep, dev = part.rpartition("=")
        if not sep or not seg.strip():
            raise ValueError(
                f"{PLACEMENT_ANNOTATION}{at}: {part!r} is not a "
                f"segment=device pair (e.g. \"mean=0,head=3\")"
            )
        seg = seg.strip()
        if seg in seen:
            raise ValueError(
                f"{PLACEMENT_ANNOTATION}{at}: segment {seg!r} placed twice"
            )
        try:
            ordinal = int(dev.strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"{PLACEMENT_ANNOTATION}{at}: {dev.strip()!r} is not a "
                f"device ordinal for segment {seg!r}"
            ) from None
        if ordinal < 0:
            raise ValueError(
                f"{PLACEMENT_ANNOTATION}{at}: device ordinal {ordinal} "
                f"for segment {seg!r} must be >= 0"
            )
        seen.add(seg)
        out.append((seg, ordinal))
    if not out:
        raise ValueError(
            f"{PLACEMENT_ANNOTATION}{at}: empty placement override"
        )
    return tuple(out)


def placement_config_from_annotations(ann: dict,
                                      where: str = "") -> PlacementConfig:
    """Parse + validate the placement annotation family; raises
    ``ValueError`` with a path-prefixed message on any malformed knob.

    ``seldon.io/mesh`` absent → plane off (overrides, if any, are still
    validated so graphlint can warn about dead knobs)."""
    at = f" at {where}" if where else ""

    overrides: tuple = ()
    raw = ann.get(PLACEMENT_ANNOTATION)
    if raw is not None:
        overrides = _parse_overrides(raw, at)

    raw = ann.get(MESH_ANNOTATION)
    if raw is None:
        return PlacementConfig(enabled=False, overrides=overrides)
    sizes = _parse_mesh_spec(raw, at)
    dp, pp, tp = (sizes.get(a, 1) for a in AXIS_ORDER)
    for seg, ordinal in overrides:
        if ordinal >= dp * pp * tp:
            raise ValueError(
                f"{PLACEMENT_ANNOTATION}{at}: segment {seg!r} placed on "
                f"device {ordinal} but the mesh has only {dp * pp * tp} "
                f"device(s)"
            )
    return PlacementConfig(enabled=True, dp=dp, pp=pp, tp=tp,
                           overrides=overrides)
