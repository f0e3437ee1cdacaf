"""HBM-aware segment→device placement (port of
``seldon_core_tpu/placement/planner.py``, unchanged; the admission lint's
GL1204 plans with it).

The planner answers "which device does each fused segment live on" from
three inputs, in priority order:

1. ``seldon.io/placement`` overrides — the operator pins a segment to a
   mesh device ordinal and the planner obeys (an override of an unknown
   segment is rejected at admission, GL1203).
2. Shardability — a segment whose members all declare shardable batch
   dims executes as ONE sharded dispatch spanning the whole ``dp`` axis,
   so its "placement" is the submesh, not a single device (its weights
   are replicated per dp group).  With a ``tp`` axis and per-param
   layouts (``placement/layouts.py``) the span becomes a **tp span**:
   the covered weight bytes divide by ``tp`` instead of replicating, so
   a segment whose peak HBM exceeds one device's budget can still be
   planned — the per-device charge is ``tp_bytes/tp + the replicated
   remainder``, and a plan that would hard-stop with GL1204 at tp=1
   fits at tp=2.
3. Greedy bin-packing for the rest: segments sorted by descending HBM
   estimate, each onto the least-loaded device — the classic LPT
   heuristic, within 4/3 of optimal makespan, which is more than enough
   when the real budgets come from PR 9's compile ledgers anyway.

HBM estimates prefer the measured ``memory_analysis().peak_hbm_bytes``
from ``profiling/compilewatch.py`` (populated after first compile) and
fall back to the signature registry's static ``hbm_bytes`` sum, so the
``/admin/placement`` report sharpens as traffic warms the segments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["SegmentFacts", "Assignment", "PlacementPlan", "plan_placement"]


@dataclass(frozen=True)
class SegmentFacts:
    """What the planner needs to know about one fused segment."""

    name: str
    hbm_bytes: int = 0
    #: measured peak from the compile ledger (0 until first compile)
    measured_hbm_bytes: int = 0
    shardable: bool = False
    members: tuple = ()
    #: bytes covered by per-param tp layouts (0 = nothing tp-shards);
    #: these divide by ``tp`` in the per-device charge, the rest
    #: replicates
    tp_shardable_bytes: int = 0

    @property
    def estimate(self) -> int:
        return self.measured_hbm_bytes or self.hbm_bytes

    def per_device_bytes(self, tp: int) -> int:
        """HBM one device holds when this segment spans a ``tp`` group:
        the layout-covered fraction divides, the remainder replicates.
        The covered *fraction* comes from the static split so a larger
        measured peak scales proportionally."""
        est = self.estimate
        if tp < 2 or not self.tp_shardable_bytes or not est:
            return est
        frac = min(1.0, self.tp_shardable_bytes / max(1, self.hbm_bytes))
        return int(est * frac / tp + est * (1.0 - frac))


@dataclass(frozen=True)
class Assignment:
    segment: str
    #: mesh device ordinals this segment dispatches to
    devices: tuple
    hbm_bytes: int
    source: str  # "override" | "sharded" | "tp-span" | "bin-pack"
    #: tp-span only: HBM each device in the span holds (sharded share
    #: of the weights + the replicated remainder)
    tp_bytes_per_device: int = 0
    #: tp-span only: the mesh slice the span partitions over ("tp=2",
    #: "dp=2,tp=2")
    mesh_slice: str = ""


@dataclass
class PlacementPlan:
    mesh_spec: str
    n_devices: int
    assignments: list = field(default_factory=list)
    #: device ordinal → summed HBM estimate of resident segments
    device_hbm_bytes: dict = field(default_factory=dict)
    #: device ordinals whose load exceeds the advisory per-device capacity
    over_capacity: list = field(default_factory=list)

    def to_dict(self) -> dict:
        out = {
            "mesh": self.mesh_spec,
            "devices": self.n_devices,
            "segments": [
                {
                    "segment": a.segment,
                    "devices": list(a.devices),
                    "hbmBytes": int(a.hbm_bytes),
                    "source": a.source,
                    **({"meshSlice": a.mesh_slice,
                        "tpBytesPerDevice": int(a.tp_bytes_per_device)}
                       if a.source == "tp-span" else {}),
                }
                for a in self.assignments
            ],
            "deviceHbmBytes": {
                str(k): int(v) for k, v in sorted(self.device_hbm_bytes.items())
            },
        }
        if self.over_capacity:
            out["overCapacity"] = list(self.over_capacity)
        return out


def plan_placement(
    segments: Sequence[SegmentFacts],
    n_devices: int,
    dp: int = 1,
    tp: int = 1,
    mesh_spec: str = "dp=1",
    overrides: Optional[dict] = None,
    capacity_bytes: Optional[int] = None,
) -> PlacementPlan:
    """Assign every segment; deterministic for a given input order.

    ``capacity_bytes`` (per device) is advisory here — feasibility is an
    admission-time ERROR (GL1204); at runtime the plan is still produced
    so ``/admin/placement`` can show the operator the overflow.  With
    ``tp > 1`` a segment carrying ``tp_shardable_bytes`` is planned as a
    **tp span**: it dispatches across every mesh device, each charged
    the per-device share (layout-covered bytes ÷ tp + the replicated
    remainder) — the path that turns "peak HBM exceeds one device"
    (GL1204 at tp=1) into a feasible plan."""
    overrides = dict(overrides or {})
    plan = PlacementPlan(mesh_spec=mesh_spec, n_devices=n_devices)
    load: dict[int, int] = {d: 0 for d in range(max(1, n_devices))}

    pinned: list[tuple[SegmentFacts, int]] = []
    spanned: list[SegmentFacts] = []
    packed: list[SegmentFacts] = []
    for seg in segments:
        if seg.name in overrides:
            pinned.append((seg, overrides[seg.name]))
        elif (seg.shardable and dp > 1) or (
                tp > 1 and seg.tp_shardable_bytes):
            spanned.append(seg)
        else:
            packed.append(seg)

    for seg, ordinal in pinned:
        ordinal = min(ordinal, max(load))
        load[ordinal] += seg.estimate
        plan.assignments.append(Assignment(
            seg.name, (ordinal,), seg.estimate, "override"))

    all_devices = tuple(range(max(1, n_devices)))
    slice_axes = [a for a in (("dp", dp), ("tp", tp)) if a[1] > 1]
    mesh_slice = ",".join(f"{a}={n}" for a, n in slice_axes) or "dp=1"
    for seg in spanned:
        tp_span = tp > 1 and bool(seg.tp_shardable_bytes)
        # tp span: each device holds the sharded share; dp-only span:
        # replicated weights, every device holds a full copy
        per_dev = seg.per_device_bytes(tp) if tp_span else seg.estimate
        for d in all_devices:
            load[d] += per_dev
        plan.assignments.append(Assignment(
            seg.name, all_devices, seg.estimate,
            "tp-span" if tp_span else "sharded",
            tp_bytes_per_device=per_dev if tp_span else 0,
            mesh_slice=mesh_slice if tp_span else ""))

    # LPT: largest first, each onto the currently least-loaded device
    for seg in sorted(packed, key=lambda s: -s.estimate):
        ordinal = min(load, key=lambda d: (load[d], d))
        load[ordinal] += seg.estimate
        plan.assignments.append(Assignment(
            seg.name, (ordinal,), seg.estimate, "bin-pack"))

    # restore caller ordering so /admin/placement reads like the plan
    order = {s.name: i for i, s in enumerate(segments)}
    plan.assignments.sort(key=lambda a: order.get(a.segment, 1 << 30))
    plan.device_hbm_bytes = {d: b for d, b in load.items() if b}
    if capacity_bytes:
        plan.over_capacity = sorted(
            d for d, b in load.items() if b > capacity_bytes)
    return plan
