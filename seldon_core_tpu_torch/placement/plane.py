"""PlacementPlane: one object per engine or deployment owning the device
mesh, the segment-to-device placement plan, and the sharded-dispatch
telemetry the admin surfaces read (port of
``seldon_core_tpu/placement/plane.py``).

Construction builds (or fetches from the process-local registry,
``meshes.py``) the :class:`~seldon_core_tpu_torch.parallel.mesh.Mesh` for the
deployment's ``seldon.io/mesh`` annotation on its device's kind, or takes
one given (``mesh=``: ``make_mesh(devices=[...])``, where a device may
repeat, as two ranks on one card or on the CPU).  ``attach_plan`` binds the
engine's plan and arms the sharded executor
(``graph/plan.py`` :meth:`FusedSegment.enable_sharding`) on every segment
whose members declare shardable batch dims, or whose weights the tp
layouts cover.  ``/admin/placement`` and ``status.placement`` read
:meth:`describe` / :meth:`snapshot`; each sharded dispatch lands in the
``seldon_placement_*`` metrics, one count per mesh rank (the device label
is the rank's ordinal, the planner's device numbering).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from seldon_core_tpu_torch.placement.config import PlacementConfig
from seldon_core_tpu_torch.placement.meshes import device_count, mesh_for
from seldon_core_tpu_torch.placement.planner import (
    PlacementPlan,
    SegmentFacts,
    plan_placement,
)

__all__ = ["PlacementPlane", "segment_facts"]

_DISPATCH_COUNTER = "seldon_placement_dispatches_total"
_SHARDED_COUNTER = "seldon_placement_sharded_dispatches_total"
_SEGMENTS_GAUGE = "seldon_placement_segments"
_DEVICE_HBM_GAUGE = "seldon_placement_device_hbm_bytes"
_TP_SPANS_GAUGE = "seldon_placement_tp_spans"
_TP_BYTES_GAUGE = "seldon_placement_tp_bytes_per_device"


def _member_units(root_node, names: set) -> dict:
    """name -> engine node for the segment members under ``root_node``."""
    units: dict = {}

    def visit(n) -> None:
        if n.unit.name in names:
            units[n.unit.name] = n
        for c in n.children:
            visit(c)

    visit(root_node)
    return units


def _member_signature(node):
    """The member's static signature: the model_class registry first, then
    the built-in table."""
    from seldon_core_tpu_torch.models import BUILTIN_SIGNATURES, signature_for

    mc = node.unit.parameters.get("model_class")
    if isinstance(mc, str) and mc:
        return signature_for(mc)
    if node.unit.implementation:
        return BUILTIN_SIGNATURES.get(node.unit.implementation)
    return None


def _parity_probe(seg, dp: int):
    """The arm-time parity probe: ``2 * dp`` rows from the entry node's
    static signature, drawn from ``RandomState(0)``.  None when the
    signature does not pin every non-batch dim (the segment then arms
    ``unprobed``)."""
    from seldon_core_tpu_torch.graph.plan import _entry_signature

    sig = _entry_signature(seg.root_node)
    if sig is None or sig.input_shape is None or any(
            d is None for d in sig.input_shape[1:]):
        return None
    shape = (2 * dp,) + tuple(sig.input_shape[1:])
    dt = np.dtype(sig.input_dtype or "float32")
    rng = np.random.RandomState(0)
    if dt.kind in ("i", "u"):
        return rng.randint(0, 8, size=shape).astype(dt)
    return rng.uniform(size=shape).astype(dt)


def _tp_specs(seg) -> dict:
    """member name -> {param key -> tp axis tuple} from the signature
    registry."""
    names = {s.name for s in seg.members}
    out: dict = {}
    for name, node in _member_units(seg.root_node, names).items():
        sig = _member_signature(node)
        if sig is not None and sig.tp_param_specs:
            out[name] = dict(sig.tp_param_specs)
    return out


def _tp_shardable_bytes(seg, tp: int, tp_specs: dict) -> int:
    """Bytes of the segment's params the tp layouts (declared specs first,
    the rule table second) cover at this ``tp``: the planner's numerator
    for the per-device split."""
    if tp < 2:
        return 0
    from seldon_core_tpu_torch.placement import layouts

    total = 0
    for st in seg.members:
        layout = layouts.resolve_layout(
            st.params, declared=tp_specs.get(st.name), tp=tp)
        if layout:
            total += layouts.tp_param_bytes(st.params, layout)
    return total


def segment_facts(seg, tp: int = 1) -> SegmentFacts:
    """Planner inputs for one live :class:`FusedSegment`.

    Static bytes come from the signature registry; the measured peak is
    the largest ``peak_hbm_bytes`` of the segment's buckets (its graph
    pool on the card, 0 on the CPU).  Shardability needs EVERY member to
    carry a signature declaring a row-wise serving function
    (``batch_shardable``)."""
    names = {s.name for s in seg.members}
    units = _member_units(seg.root_node, names)
    hbm = 0
    shardable = len(units) == len(names) and bool(names)
    for name in names:
        node = units.get(name)
        sig = _member_signature(node) if node is not None else None
        if sig is None:
            shardable = False
            continue
        hbm += sig.hbm_bytes
        if not sig.batch_shardable:
            shardable = False
    measured = 0
    for cost in list(seg.cost_by_bucket.values()) + list(
            seg.shard_cost_by_bucket.values()):
        measured = max(measured, int(cost.get("peak_hbm_bytes", 0) or 0))
    return SegmentFacts(
        name=seg.name, hbm_bytes=hbm, measured_hbm_bytes=measured,
        shardable=shardable, members=tuple(sorted(names)),
        tp_shardable_bytes=_tp_shardable_bytes(seg, tp, _tp_specs(seg)),
    )


class PlacementPlane:
    def __init__(self, config: PlacementConfig, metrics=None,
                 deployment: str = "",
                 capacity_bytes: Optional[int] = None,
                 device="cuda", mesh=None):
        """The mesh is ``mesh`` when given, else the registry's for
        ``config`` on ``device``'s kind, which raises ``MeshPlanError``
        when the spec wants more CUDA devices than are visible: a runtime
        with a smaller inventory than the admission lint saw fails at
        construction, not at the first sharded dispatch."""
        self.config = config
        self.metrics = metrics
        self.deployment = deployment
        self.capacity_bytes = capacity_bytes
        from seldon_core_tpu_torch.parallel.mesh import (
            MeshPlanError,
            check_one_process,
        )

        if mesh is None:
            mesh = mesh_for(config, device=device)
        elif dict(mesh.shape) != config.axis_sizes():
            raise MeshPlanError(f"mesh {mesh!r} is not the spec "
                                f"{config.spec()!r}")
        check_one_process(mesh, "the placement plane's sharded segments")
        self.mesh = mesh
        self._plan_lock = threading.Lock()
        self._graph_plan = None
        self._segments: list = []
        self.sharded_segments: list[str] = []
        self.n_sharded_dispatches = 0

    # -- wiring ---------------------------------------------------------
    def attach_plan(self, graph_plan) -> None:
        """Bind the engine's plan; arm the sharded executor on every
        shardable segment."""
        with self._plan_lock:
            self._graph_plan = graph_plan
            self._segments = list(graph_plan.segments)
            self.sharded_segments = []
            for seg in self._segments:
                facts = segment_facts(seg, tp=self.config.tp)
                # a dp axis with row-shardable members, and/or a tp axis
                # with per-param layouts: a pure-tp mesh arms on weights
                dp_armable = facts.shardable and self.config.dp > 1
                tp_armable = self.config.tp > 1 and facts.tp_shardable_bytes
                if (dp_armable or tp_armable) and seg.enable_sharding(
                        self.mesh, on_dispatch=self._note_sharded,
                        tp_param_specs=_tp_specs(seg),
                        probe=_parity_probe(seg, self.config.dp)):
                    self.sharded_segments.append(seg.name)
                    if seg.batcher is not None:
                        # every coalesced batch splits evenly over dp
                        seg.batcher.config.shard_rows = seg.shard_rows
        if self.metrics is not None:
            try:
                self.metrics.gauge_set(
                    _SEGMENTS_GAUGE, len(self._segments),
                    {"deployment": self.deployment or "engine"})
            except Exception:
                pass

    # -- telemetry ------------------------------------------------------
    def _note_sharded(self, seg_name: str, rows: int) -> None:
        """One sharded dispatch: every rank of the mesh ran its share."""
        self.n_sharded_dispatches += 1
        if self.metrics is None:
            return
        try:
            dep = self.deployment or "engine"
            self.metrics.counter_inc(
                _SHARDED_COUNTER, {"deployment": dep, "segment": seg_name})
            for rank in range(self.mesh.devices.size):
                self.metrics.counter_inc(
                    _DISPATCH_COUNTER,
                    {"deployment": dep, "device": str(rank)})
        except Exception:
            pass

    # -- posture --------------------------------------------------------
    def placement(self) -> PlacementPlan:
        """The current placement plan, derived again on every read so the
        byte estimates sharpen as buckets are captured."""
        with self._plan_lock:
            segs = list(self._segments)
        facts = [segment_facts(s, tp=self.config.tp) for s in segs]
        plan = plan_placement(
            facts, n_devices=self.config.n_devices, dp=self.config.dp,
            tp=self.config.tp, mesh_spec=self.config.spec(),
            overrides=self.config.override_map(),
            capacity_bytes=self.capacity_bytes,
        )
        if self.metrics is not None:
            try:
                dep = self.deployment or "engine"
                for d, b in plan.device_hbm_bytes.items():
                    self.metrics.gauge_set(
                        _DEVICE_HBM_GAUGE, float(b),
                        {"deployment": dep, "device": str(d)})
                spans = [a for a in plan.assignments
                         if a.source == "tp-span"]
                self.metrics.gauge_set(
                    _TP_SPANS_GAUGE, float(len(spans)),
                    {"deployment": dep})
                for a in spans:
                    self.metrics.gauge_set(
                        _TP_BYTES_GAUGE, float(a.tp_bytes_per_device),
                        {"deployment": dep, "segment": a.segment})
            except Exception:
                pass
        return plan

    def mesh_shape(self) -> str:
        return self.config.spec()

    def armed_segments(self) -> list:
        """The live segments the sharded executor is armed on."""
        with self._plan_lock:
            return [s for s in self._segments if s.shard_slice]

    def tp_spans(self) -> list:
        """Armed tp spans, from the live segments: which params shard, over
        which mesh slice, and the bytes of pieces one tp rank holds
        (measured from their storage)."""
        with self._plan_lock:
            segs = list(self._segments)
        spans = []
        for seg in segs:
            if seg.shard_tp < 2:
                continue
            spans.append({
                "segment": seg.name,
                "meshSlice": seg.shard_slice,
                "shardedParamBytes": int(seg.tp_sharded_param_bytes),
                "tpBytesPerDevice": seg.tp_bytes_per_device,
                "params": {m: sorted(lay)
                           for m, lay in seg.tp_layouts.items()},
            })
        return spans

    def describe(self) -> dict:
        """The ``/admin/placement`` payload."""
        plan = self.placement()
        out = plan.to_dict()
        out.update({
            "deployment": self.deployment,
            "devicesVisible": device_count(),
            "shardedSegments": list(self.sharded_segments),
            "shardedDispatches": self.n_sharded_dispatches,
        })
        spans = self.tp_spans()
        if spans:
            out["tpSpans"] = spans
        if self.capacity_bytes:
            out["deviceCapacityBytes"] = int(self.capacity_bytes)
        return out

    # -- control-plane snapshot (status.placement) ----------------------
    def snapshot(self) -> dict:
        """Compact posture for the CR's ``status.placement`` block."""
        plan = self.placement()
        out = {
            "mesh": self.config.spec(),
            "devices": self.config.n_devices,
            "segments": {
                a.segment: list(a.devices) for a in plan.assignments
            },
            "shardedSegments": list(self.sharded_segments),
        }
        spans = self.tp_spans()
        if spans:
            out["tpSpans"] = {s["segment"]: s["meshSlice"] for s in spans}
        return out
