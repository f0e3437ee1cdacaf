"""GL18xx — plan-level residency verification (``analysis/planlint.py``;
port of ``seldon_core_tpu/analysis/planlint.py``).

An engine that orchestrates opaque microservices finds a misrouted
tensor only at runtime.  Here the spec carries enough to construct the
fused plan offline — zero weights, nothing runs: the plan DAG comes from :func:`graphlint._static_segments`
(the same derivation the plan compiler uses), signatures from the
static registry, and residency policy from the pure model the runtime
itself exports (``runtime/device_plane.py`` tiers,
``runtime/device_registry.py`` ownership).  This pass propagates a
per-edge **ResidencyState** lattice

    {host-bytes, shm lane, loopback ref, HBM handle}
        × partition {replicated, dp, tp}
        × ownership {shared, one-shot/donated}

through every segment, router, cache, and remote edge under the
deployment's ``seldon.io/device-plane`` + ``seldon.io/mesh``
annotations, pricing each residency transition with the same per-hop
costs the compile ledger observes.  Rules:

- **GL1801 ERROR** — an edge that structurally downgrades to bytes on
  every request: the plane is on and a remote fast path requested, but
  the peer's transport can never negotiate loopback/shm (device refs
  ride the proto/framed codecs only — a REST edge has no deviceRef
  field).
- **GL1802 ERROR** — a cache or fan-out edge receiving a donated
  one-shot handle that a second consumer will observe after the first
  resolve consumed it (``related`` carries producer + second consumer).
- **GL1803 WARN** — a tp→dp reshard inside a fused span: a tp-sharded
  member feeds a weighted member with no tp layout, forcing an implicit
  gather/reshard round trip mid-segment.
- **GL1804 WARN** — the walk deadline (GL3xx model) becomes infeasible
  once per-edge D2H/H2D transition costs are added.
- **GL1805 INFO** — the full planned residency map, one entry per edge,
  surfaced on ``status.analysis`` at admission.

Active when the ``seldon.io/device-plane`` annotation family is present
(any posture — a plane-off graph still gets its map, with every remote
edge priced at host-bytes).  The CLI injects the family with ``--plan
on|off`` so examples can be verified in both postures.  Spec-only: no
model instantiation, no weights — cheap enough for admission.
``GraphPlan.residency_map`` (``graph/plan.py``) answers from
:func:`plan_edges` too, so the live plan and the lint cannot drift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from seldon_core_tpu_torch.analysis.findings import (
    RESIDENCY_DEADLINE_INFEASIBLE,
    RESIDENCY_DONATED_SHARED,
    RESIDENCY_MAP_REPORT,
    RESIDENCY_RESHARD_HOST_TRIP,
    RESIDENCY_STRUCTURAL_DOWNGRADE,
    Finding,
    make_finding,
)
from seldon_core_tpu_torch.graph.spec import PredictiveUnit
from seldon_core_tpu_torch.runtime.device_plane import (
    DEVICE_PLANE_ANNOTATION,
    DEVICE_PLANE_PREFIX,
    DEVICE_PLANE_REMOTE_ANNOTATION,
    TIER_HBM_HANDLE,
    TIER_HOST_BYTES,
    DevicePlaneConfig,
    device_plane_config_from_annotations,
    negotiated_remote_tier,
    tier_transfers,
)
from seldon_core_tpu_torch.runtime.device_registry import (
    OWNERSHIP_ONE_SHOT,
    OWNERSHIP_SHARED,
)

#: effective rate and fixed overhead of one host↔device hop for
#: transition pricing: the device plane's pageable shm hop (``put_shm``
#: then ``resolve``: one D2H into a fresh segment, one H2D off it) on an
#: NVIDIA H100 80GB HBM3 at 700 W, from two runs of ``chip_smoke.py``
#: phase ``lint``: half the 1 KiB round trip, 0.74 and 1.13 ms a hop;
#: 64 MiB each way over the rest of its round trip, 0.61 and 0.42 GB/s
#: (page faults of each fresh segment included); their means here.
#: (The reference prices 8 GB/s and 0.05 ms, figures of its TPU host.)
TRANSFER_GBPS = 0.52
HOP_OVERHEAD_MS = 0.93

PARTITION_REPLICATED = "replicated"
PARTITION_DP = "dp"
PARTITION_TP = "tp"

#: bytes per element for transition pricing; unknown dtypes price as 4
_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8, "complex64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "float16": 2, "bfloat16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1, "float8_e4m3fn": 1,
    "float8_e5m2": 1, "int4": 1,
}


@dataclass(frozen=True)
class ResidencyState:
    """One point of the residency lattice: where the payload lives on
    an edge, how it is partitioned over the mesh, and who may observe
    the handle."""

    tier: str       # runtime/device_plane.py RESIDENCY_TIERS
    partition: str  # replicated | dp | tp
    ownership: str  # runtime/device_registry.py OWNERSHIP_*

    def __str__(self) -> str:
        return f"{self.tier}/{self.partition}/{self.ownership}"


@dataclass(frozen=True)
class PlanEdge:
    """One request-flow edge of the plan DAG with its planned state."""

    src: str        # producer node name ("<request>" for the entry edge)
    dst: str        # consumer node name
    path: str       # unit path of the consumer (finding anchor)
    state: ResidencyState
    remote: bool    # crosses a transport boundary
    fused: bool     # interior to one jitted segment


def _remote(u: PredictiveUnit) -> bool:
    return bool(u.endpoint.service_host) and u.endpoint.type != "LOCAL"


def _payload_bytes(u: PredictiveUnit, rows: int) -> int:
    """Transition-pricing estimate of the payload this node hands on:
    its declared output (or input, for passthroughs) with unknown dims
    priced at ``rows``."""
    from seldon_core_tpu_torch.analysis.graphlint import _node_signature

    sig, _ = _node_signature(u)
    if sig is None:
        return 0
    shape = sig.output_shape if sig.output_shape is not None \
        else sig.input_shape
    dtype = sig.output_dtype or sig.input_dtype or "float32"
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= rows if d is None else int(d)
    return n * _DTYPE_BYTES.get(str(dtype), 4)


def _transition_cost_ms(state: ResidencyState, nbytes: int) -> float:
    """Price of crossing one edge at this residency tier: per-hop
    dispatch overhead plus bytes over the transfer bandwidth for every
    hop the tier pays (``tier_transfers`` — the pure cost model the
    runtime exports)."""
    hops = tier_transfers(state.tier)
    if not hops:
        return 0.0
    per_hop = nbytes / (TRANSFER_GBPS * 1e9) * 1e3
    return len(hops) * (HOP_OVERHEAD_MS + per_hop)


def _mesh_config(ann: dict):
    """(dp, tp) from ``seldon.io/mesh``, or (1, 1) when absent/invalid
    (GL12xx owns reporting malformed mesh annotations)."""
    from seldon_core_tpu_torch.placement.config import (
        MESH_ANNOTATION,
        PLACEMENT_ANNOTATION,
        placement_config_from_annotations,
    )

    if not any(k in ann for k in (MESH_ANNOTATION, PLACEMENT_ANNOTATION)):
        return 1, 1
    try:
        cfg = placement_config_from_annotations(ann, "lint")
    except ValueError:
        return 1, 1
    if not cfg.enabled:
        return 1, 1
    return cfg.dp, cfg.tp


def _node_partition(u: PredictiveUnit, in_segment: bool,
                    dp: int, tp: int) -> str:
    """PartitionSpec summary of this node's output under the mesh: tp
    members hand on feature-sharded activations, dp-shardable members
    batch-sharded rows, everything else replicated.  Outside a fused
    segment the interpreter holds whole arrays — replicated."""
    if not in_segment:
        return PARTITION_REPLICATED
    from seldon_core_tpu_torch.analysis.graphlint import _node_signature

    sig, _ = _node_signature(u)
    if sig is None:
        return PARTITION_REPLICATED
    if tp > 1 and sig.tp_param_specs:
        return PARTITION_TP
    if dp > 1 and sig.batch_shardable:
        return PARTITION_DP
    return PARTITION_REPLICATED


def _cache_enabled(ann: dict) -> bool:
    from seldon_core_tpu_torch.analysis.graphlint import CACHE_ANNOTATION

    if CACHE_ANNOTATION not in ann:
        return False
    from seldon_core_tpu_torch.caching import config_from_annotations

    try:
        return config_from_annotations(ann, "lint") is not None
    except ValueError:
        return False  # GL701 owns the report


def plan_edges(root: PredictiveUnit, ann: dict,
               prefix: str = "") -> list[PlanEdge]:
    """The abstract interpretation itself: construct the fused plan the
    spec compiles to and classify every request-flow edge into a
    :class:`ResidencyState`.  Pure — no findings, reusable by tests and
    by ``GraphPlan.residency_map`` parity checks."""
    from seldon_core_tpu_torch.analysis.graphlint import (
        PLAN_ANNOTATION,
        _join,
        _static_segments,
    )

    try:
        plane = device_plane_config_from_annotations(ann, "lint")
    except ValueError:
        plane = None
    if plane is None:
        plane = DevicePlaneConfig(enabled=False)
    dp, tp = _mesh_config(ann)
    mode = str(ann.get(PLAN_ANNOTATION, "walk")).strip().lower()
    segments = _static_segments(root) if mode == "fused" else []
    seg_of: dict[int, int] = {}
    for i, seg in enumerate(segments):
        for u in seg:
            seg_of[id(u)] = i

    edges: list[PlanEdge] = []

    def classify(p: Optional[PredictiveUnit], u: PredictiveUnit,
                 path: str) -> PlanEdge:
        in_seg = id(u) in seg_of
        fused = (p is not None and in_seg
                 and seg_of.get(id(p)) == seg_of[id(u)])
        remote = _remote(u)
        partition = _node_partition(u, in_seg, dp, tp)
        if fused:
            state = ResidencyState(TIER_HBM_HANDLE, partition,
                                   OWNERSHIP_SHARED)
        elif remote:
            tier = negotiated_remote_tier(plane, u.endpoint.type)
            own = (OWNERSHIP_ONE_SHOT if tier != TIER_HOST_BYTES
                   else OWNERSHIP_SHARED)
            state = ResidencyState(tier, PARTITION_REPLICATED, own)
        elif p is None:
            # entry edge: the gateway hands the engine parsed host bytes
            state = ResidencyState(TIER_HOST_BYTES, PARTITION_REPLICATED,
                                   OWNERSHIP_SHARED)
        else:
            # in-process interpreter boundary: tensors pass by
            # reference between nodes of one engine walk
            state = ResidencyState(TIER_HBM_HANDLE, partition,
                                   OWNERSHIP_SHARED)
        return PlanEdge(
            src=p.name if p is not None else "<request>", dst=u.name,
            path=path, state=state, remote=remote, fused=fused,
        )

    def visit(u: PredictiveUnit, p: Optional[PredictiveUnit],
              path: str) -> None:
        edges.append(classify(p, u, path))
        for c in u.children:
            visit(c, u, _join(path, c.name))

    visit(root, None, _join(prefix, root.name))
    return edges


def lint_plan_residency(root: PredictiveUnit, ann: dict,
                        prefix: str = "") -> list[Finding]:
    """GL18xx findings for one graph (annotation-gated; see module
    docstring).  Called by ``graphlint.lint_graph`` after the per-plane
    passes, so operator admission and the CLI get it for free."""
    keys = [k for k in ann
            if k == DEVICE_PLANE_ANNOTATION
            or k.startswith(DEVICE_PLANE_PREFIX)]
    if not keys:
        return []
    try:
        plane = device_plane_config_from_annotations(ann, "lint")
    except ValueError:
        return []  # GL1701 (device-plane pass) already rejected it
    from seldon_core_tpu_torch.analysis.graphlint import (
        WALK_DEADLINE_ANNOTATION,
        _join,
        _num,
        _static_segments,
    )

    findings: list[Finding] = []
    edges = plan_edges(root, ann, prefix)
    by_dst = {e.dst: e for e in edges}
    path0 = _join(prefix, root.name)

    # GL1801: plane on, remote fast path requested, but the edge's
    # transport structurally cannot carry a device ref
    if plane is not None and plane.enabled and plane.remote != "off":
        for e in edges:
            if e.remote and e.state.tier == TIER_HOST_BYTES:
                findings.append(make_finding(
                    RESIDENCY_STRUCTURAL_DOWNGRADE, e.path,
                    f"edge {e.src} -> {e.dst} downgrades to bytes on "
                    f"every request: {DEVICE_PLANE_ANNOTATION} is on with "
                    f"remote={plane.remote!r} but the peer's "
                    f"{by_name(root, e.dst).endpoint.type} transport has "
                    "no deviceRef field, so loopback/shm can never "
                    "negotiate — use GRPC for this edge or set "
                    f"{DEVICE_PLANE_REMOTE_ANNOTATION}=off to make the "
                    "byte wire explicit",
                ))

    # GL1802: a donated one-shot handle with more than one observer
    findings.extend(_donated_second_consumer(root, ann, edges, prefix))

    # GL1803: tp→dp reshard forced inside a fused span
    from seldon_core_tpu_torch.analysis.graphlint import PLAN_ANNOTATION

    dp, tp = _mesh_config(ann)
    mode = str(ann.get(PLAN_ANNOTATION, "walk")).strip().lower()
    if dp > 1 and tp > 1 and mode == "fused":
        findings.extend(_reshard_in_span(
            _static_segments(root), edges, by_dst))

    # GL1804: GL3xx deadline model + per-edge transition costs
    deadline_ms = _num(ann.get(WALK_DEADLINE_ANNOTATION))
    if deadline_ms and deadline_ms > 0:
        findings.extend(_deadline_with_transitions(
            root, ann, edges, deadline_ms, prefix))

    # GL1805: the planned residency map itself
    entries = "; ".join(
        f"{e.src}->{e.dst} {e.state}" for e in edges)
    findings.append(make_finding(
        RESIDENCY_MAP_REPORT, path0,
        f"planned residency ({len(edges)} edge(s), device plane "
        f"{'on' if plane is not None and plane.enabled else 'off'}): "
        f"{entries}",
    ))
    return findings


def by_name(root: PredictiveUnit, name: str) -> PredictiveUnit:
    for u in root.walk():
        if u.name == name:
            return u
    raise KeyError(name)


def _donated_second_consumer(root: PredictiveUnit, ann: dict,
                             edges: list[PlanEdge],
                             prefix: str) -> list[Finding]:
    """GL1802, two structural shapes:

    - **fan-out**: a non-router node dispatches the SAME payload to ≥2
      children concurrently and ≥2 of those edges ride a one-shot ref —
      the first child's resolve consumes, every sibling observes a dead
      handle.
    - **cache**: the prediction cache is enabled and the final response
      edge rides a one-shot ref (the root is a ref-negotiating remote) —
      the cache retains the handle AND the client consumes it, so every
      cache hit replays a dead ref.
    """
    from seldon_core_tpu_torch.analysis.graphlint import _join

    findings: list[Finding] = []
    by_dst = {e.dst: e for e in edges}

    def visit(u: PredictiveUnit, path: str) -> None:
        if u.resolved_type != "ROUTER" and len(u.children) >= 2:
            oneshot = [c for c in u.children
                       if by_dst[c.name].state.ownership
                       == OWNERSHIP_ONE_SHOT]
            if len(oneshot) >= 2:
                first, second = oneshot[0], oneshot[1]
                findings.append(make_finding(
                    RESIDENCY_DONATED_SHARED, path,
                    f"fan-out hands one donated one-shot handle to "
                    f"{len(oneshot)} consumers ({', '.join(c.name for c in oneshot)}): "
                    f"the first resolve consumes it and "
                    f"{second.name!r} observes a dead ref — drop to "
                    "shared ownership (shm lane / bytes) on all but one "
                    "edge, or materialize before the fan-out",
                    related=(
                        (_join(path, first.name),
                         "first consumer: resolve consumes the donated "
                         "handle"),
                        (_join(path, second.name),
                         "second consumer: observes the handle after "
                         "consume"),
                    ),
                ))
        for c in u.children:
            visit(c, _join(path, c.name))

    visit(root, _join(prefix, root.name))

    if _cache_enabled(ann):
        root_edge = by_dst.get(root.name)
        if root_edge is not None and root_edge.remote \
                and root_edge.state.ownership == OWNERSHIP_ONE_SHOT:
            path0 = _join(prefix, root.name)
            findings.append(make_finding(
                RESIDENCY_DONATED_SHARED, path0,
                f"the response edge from remote root {root.name!r} rides "
                "a donated one-shot ref while the prediction cache is on: "
                "the cache retains the handle and the client's first read "
                "consumes it, so every cache hit replays a dead ref — "
                "disable the cache, or cap the edge at shared ownership "
                "(device-plane-remote=off for this predictor)",
                related=(
                    (path0, "producer: mints the one-shot reply handle"),
                    (path0 + "/<prediction-cache>",
                     "second consumer: the cache replays the handle "
                     "after the client consumed it"),
                ),
            ))
    return findings


def _reshard_in_span(segments, edges: list[PlanEdge],
                     by_dst: dict) -> list[Finding]:
    """GL1803: inside one fused segment, a tp-sharded member feeding a
    weighted member with no tp layout.  The consumer needs replicated
    (or dp-rows) activations, so the compiler must insert an all-gather
    across the tp group mid-segment — on an interpreter-less span that
    is an implicit host round trip on every dispatch."""
    findings: list[Finding] = []
    from seldon_core_tpu_torch.analysis.graphlint import _node_signature

    for seg in segments:
        members = {id(u) for u in seg}
        for u in seg:
            for c in u.children:
                if id(c) not in members:
                    continue
                # dataflow direction: chains feed parent→child; a
                # combiner aggregates child→parent
                if u.resolved_type == "COMBINER":
                    a, b = c, u
                elif c.resolved_type == "COMBINER":
                    continue  # data reaches it via its own children
                else:
                    a, b = u, c
                sa, _ = _node_signature(a)
                sb, _ = _node_signature(b)
                if sa is None or sb is None:
                    continue
                if not sa.tp_param_specs or sb.tp_param_specs:
                    continue
                if not sb.hbm_bytes:
                    continue  # weightless ops propagate the sharding
                edge = by_dst.get(c.name)
                path = edge.path if edge is not None else b.name
                findings.append(make_finding(
                    RESIDENCY_RESHARD_HOST_TRIP, path,
                    f"tp→dp reshard inside fused span "
                    f"{seg[0].name!r}: {a.name!r} hands on tp-sharded "
                    f"activations but weighted member {b.name!r} "
                    "declares no tp layout, forcing an implicit "
                    "all-gather/reshard round trip on every dispatch — "
                    f"register tp_param_specs for {b.name!r}'s class or "
                    "split the span at this edge",
                ))
    return findings


def _deadline_with_transitions(root: PredictiveUnit, ann: dict,
                               edges: list[PlanEdge], deadline_ms: float,
                               prefix: str) -> list[Finding]:
    """GL1804: the GL301 critical-path model with per-edge residency
    transition costs added.  Only fires when the budgets ALONE fit the
    deadline (GL301 owns the other case) but budgets + transitions do
    not — the gap is purely the residency plan, so the fix is residency
    (plane posture, transports), not budgets."""
    from seldon_core_tpu_torch.analysis.graphlint import _join, _num

    by_dst = {e.dst: e for e in edges}
    rows = int(_num(ann.get("seldon.io/batch-max-size")) or 1)

    def critical(u: PredictiveUnit, with_edges: bool) -> float:
        own = _num(u.parameters.get("timeout_ms")) or 0.0
        if with_edges:
            e = by_dst[u.name]
            own += _transition_cost_ms(
                e.state, _payload_bytes(u, rows))
        return own + max((critical(c, with_edges) for c in u.children),
                         default=0.0)

    base = critical(root, False)
    total = critical(root, True)
    if base <= deadline_ms < total:
        return [make_finding(
            RESIDENCY_DEADLINE_INFEASIBLE, _join(prefix, root.name),
            f"critical path fits the {deadline_ms:g}ms walk deadline on "
            f"node budgets alone ({base:g}ms) but not once per-edge "
            f"residency transitions are priced in ({total:.2f}ms at "
            f"{TRANSFER_GBPS:g} GB/s, {HOP_OVERHEAD_MS:g}ms/hop) — "
            "promote byte/shm edges to ref tiers or raise the deadline",
        )]
    return []
