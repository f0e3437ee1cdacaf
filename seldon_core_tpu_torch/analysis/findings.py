"""Finding model shared by both graphlint passes (port of
``seldon_core_tpu/analysis/findings.py``: the same codes, severities and
messages, so a finding of the port and of the reference compare equal).

A finding is one diagnosed defect with a **stable code** (tests, CI
greps, and operator status all key on it), a severity, the unit path or
``file:line`` it anchors to, and a human message.  Codes are grouped:

- ``GL0xx`` — spec-level (parse/validation) failures
- ``GL1xx`` — structural graph invariants
- ``GL2xx`` — shape/dtype signature propagation
- ``GL3xx`` — resource / deadline feasibility
- ``GL6xx`` — graph-plan fusion report (which segments fuse, and why the
  rest stay interpreter boundaries)
- ``GL7xx`` — prediction-cache admission (annotation validation +
  cacheability: RNG routers, stateful components, and
  per-request-meta-dependent nodes are uncacheable; forcing them cached
  is an error)
- ``GL8xx`` — QoS admission (``seldon.io/slo-p95-ms`` /
  ``seldon.io/qos-*`` annotation validation, fallback-subgraph
  resolution and robustness against the signature registry, SLO
  feasibility vs per-node budgets)
- ``GL9xx`` — tracing admission (``seldon.io/tracing`` /
  ``seldon.io/trace-*`` annotation validation, knobs set while the
  subsystem is off, effective-config report)
- ``GL10xx`` — health-plane admission (``seldon.io/health*`` /
  ``seldon.io/slo-availability`` annotation validation, knobs set while
  the plane is off, effective sampler/recorder/SLO report)
- ``GL11xx`` — profiling-plane admission (``seldon.io/profile*``
  annotation validation, knobs set while the plane is off, effective
  sampler/compile-watch report)
- ``GL12xx`` — placement-plane admission (``seldon.io/mesh`` /
  ``seldon.io/placement`` annotation validation, mesh oversubscription
  vs the visible device count, overrides naming unknown segments,
  per-device HBM feasibility against the GL3xx budget, effective
  mesh/placement report)
- ``GL15xx`` — artifact-plane admission (``seldon.io/artifact-*``
  annotation validation, artifacts requested without a fused graph
  plan, effective store/precompile/parity report)
- ``GL16xx`` — trace-lint (``analysis/tracelint.py``): the signature
  registry verified against reality by abstractly tracing each
  registered callable on fake tensors (``FakeTensorMode``: no execution,
  no weights) — declared-vs-traced drift, implicit float64 promotion,
  host syncs inside ``pure_fn`` nodes, and mesh-axis divisibility
  against ``seldon.io/mesh``
- ``GL17xx`` — device-plane admission (``seldon.io/device-plane*``
  annotation validation, plane knobs set while the plane is off,
  effective enable/remote-mode report)
- ``GL18xx`` — plan-level residency verification
  (``analysis/planlint.py``): an abstract interpreter over the fused
  plan the spec will compile to, propagating a per-edge ResidencyState
  (tier x partition x ownership) under the ``seldon.io/device-plane``
  and ``seldon.io/mesh`` annotations — structural byte downgrades,
  donated one-shot handles with a second consumer, tp→dp reshards
  inside fused spans, transition-cost deadline feasibility, and the
  full planned residency map
- ``RL4xx`` — blocking calls on async hot paths (repo lint)
- ``RL5xx`` — host-sync JAX ops inside jit'd hot paths (repo lint; the
  port has no jit'd bodies, the rules stay so findings over one source
  text equal the reference's)
- ``RL6xx`` — asyncio concurrency lint (``analysis/asynclint.py``):
  event-loop races on shared mutable state (check-then-act split by an
  ``await``, unlocked cross-await mutation), fire-and-forget
  ``create_task``, locks held across remote awaits, and unguarded
  ``asyncio.gather``
- ``RL7xx`` — DeviceTensorRef lifecycle lint (``analysis/ownlint.py``):
  AST dataflow over one-shot registry refs — use-after-consume,
  double-consume across branches, resolution sites without a
  byte-downgrade error path, and ``ShmChannel`` lanes not closed on
  all exits

Codes are append-only: never renumber or reuse a retired code.
"""

from __future__ import annotations

from dataclasses import dataclass

ERROR = "ERROR"
WARN = "WARN"
INFO = "INFO"

SEVERITIES = (ERROR, WARN, INFO)

# -- graph checker ----------------------------------------------------------
SPEC_INVALID = "GL001"          # spec failed to parse/validate at all
GRAPH_CYCLE = "GL101"           # node reachable from itself
DUPLICATE_NAME = "GL102"        # two nodes share a name
COMBINER_ARITY = "GL103"        # COMBINER with < 2 children
ROUTER_NO_CHILDREN = "GL104"    # ROUTER with no children
IMPL_TYPE_MISMATCH = "GL105"    # implementation's natural type != node type
METHOD_TYPE_MISMATCH = "GL106"  # declared method unsupported for node type
ROUTER_BRANCH_MISMATCH = "GL107"  # router config disagrees with child count
DTYPE_MISMATCH = "GL201"        # edge dtype disagreement
SHAPE_MISMATCH = "GL202"        # edge shape disagreement
UNKNOWN_SIGNATURE = "GL203"     # model_class not in the signature registry
COMBINER_INPUT_DIVERGENCE = "GL204"  # combiner children disagree on output sig
DEADLINE_INFEASIBLE = "GL301"   # per-node budgets cannot fit the walk deadline
HBM_OVER_BUDGET = "GL302"       # estimated HBM footprint exceeds the budget
HBM_NEAR_BUDGET = "GL303"       # estimated HBM footprint > 80% of the budget
PLAN_SEGMENT_FUSED = "GL601"    # graph-plan: nodes fused into one segment
PLAN_NODE_BOUNDARY = "GL602"    # graph-plan: node stays an interpreter boundary
PLAN_NOTHING_FUSED = "GL603"    # fused mode requested but no segment fused
PLAN_MODE_INVALID = "GL604"     # seldon.io/graph-plan value unknown
CACHE_ANNOTATION_INVALID = "GL701"  # seldon.io/prediction-cache* value invalid
CACHE_FORCED_UNCACHEABLE = "GL702"  # node forced `cacheable` but unsafe
CACHE_SUBTREE_CACHEABLE = "GL703"   # cache report: subtree serves from cache
CACHE_NODE_UNCACHEABLE = "GL704"    # cache report: node always bypasses
CACHE_NOTHING_CACHEABLE = "GL705"   # cache enabled but nothing cacheable
QOS_ANNOTATION_INVALID = "GL801"    # seldon.io/slo-p95-ms / qos-* value invalid
QOS_FALLBACK_UNKNOWN = "GL802"      # qos-fallback names a node not in the graph
QOS_FALLBACK_IS_ROOT = "GL803"      # qos-fallback names the graph root
QOS_FALLBACK_REPORT = "GL804"       # qos report: the fallback subtree
QOS_FALLBACK_FRAGILE = "GL805"      # fallback subtree itself remote/unproven
QOS_SLO_INFEASIBLE = "GL806"        # node budgets cannot fit the p95 SLO
TRACE_ANNOTATION_INVALID = "GL901"  # seldon.io/trace-* value invalid
TRACE_KNOBS_WITHOUT_TRACING = "GL902"  # trace-* knobs set, tracing off
TRACE_CONFIG_REPORT = "GL903"       # trace report: effective config
HEALTH_ANNOTATION_INVALID = "GL1001"  # seldon.io/health* / slo-availability invalid
HEALTH_KNOBS_WITHOUT_HEALTH = "GL1002"  # health-* knobs set, plane off
HEALTH_CONFIG_REPORT = "GL1003"     # health report: effective config
PROFILE_ANNOTATION_INVALID = "GL1101"  # seldon.io/profile* value invalid
PROFILE_KNOBS_WITHOUT_PROFILE = "GL1102"  # profile-* knobs set, plane off
PROFILE_CONFIG_REPORT = "GL1103"    # profile report: effective config
MESH_ANNOTATION_INVALID = "GL1201"  # seldon.io/mesh / placement value invalid
MESH_OVERSUBSCRIBED = "GL1202"      # mesh axis product > visible devices
PLACEMENT_UNKNOWN_SEGMENT = "GL1203"  # override names no fused segment
PLACEMENT_HBM_INFEASIBLE = "GL1204"  # per-device HBM exceeds the GL3xx budget
PLACEMENT_CONFIG_REPORT = "GL1205"  # placement report: mesh + assignments
PLACEMENT_WITHOUT_MESH = "GL1206"   # placement overrides set, mesh absent
PLACEMENT_TP_INDIVISIBLE = "GL1207"  # param dim indivisible by tp under the effective layout
FLEET_ANNOTATION_INVALID = "GL1301"  # seldon.io/fleet-* value invalid
FLEET_KNOBS_WITHOUT_FLEET = "GL1302"  # fleet knobs set, fleet-replicas absent
FLEET_AUTOSCALE_BLIND = "GL1303"    # autoscale on, no health/profile signals
FLEET_REPLICAS_MISMATCH = "GL1304"  # fleet-replicas != predictor replicas
FLEET_CONFIG_REPORT = "GL1305"      # fleet report: effective config
FLEET_OBS_ANNOTATION_INVALID = "GL1401"  # seldon.io/fleet-obs-* value invalid
FLEET_OBS_WITHOUT_FLEET = "GL1402"  # fleet-obs knobs set, fleet absent
FLEET_OBS_CONFIG_REPORT = "GL1403"  # fleet-obs report: effective config
ARTIFACT_ANNOTATION_INVALID = "GL1501"  # seldon.io/artifact-* value invalid
ARTIFACTS_WITHOUT_PLAN = "GL1502"   # artifact knobs set, graph-plan not fused
ARTIFACT_CONFIG_REPORT = "GL1503"   # artifact report: effective config
DEVICE_PLANE_ANNOTATION_INVALID = "GL1701"  # seldon.io/device-plane* invalid
DEVICE_PLANE_KNOBS_WITHOUT_PLANE = "GL1702"  # plane knobs set, plane off
DEVICE_PLANE_CONFIG_REPORT = "GL1703"  # device-plane report: effective config
TRACE_SIGNATURE_DRIFT = "GL1601"    # declared output shape/dtype != traced
TRACE_IMPLICIT_PROMOTION = "GL1602"  # float64/weak-type escapes the segment
TRACE_CALLBACK_IN_PURE_FN = "GL1603"  # host callback inside a pure_fn node
TRACE_MESH_INDIVISIBLE = "GL1604"   # dp/tp axis does not divide its dim
RESIDENCY_STRUCTURAL_DOWNGRADE = "GL1801"  # edge downgrades to bytes always
RESIDENCY_DONATED_SHARED = "GL1802"  # one-shot handle has a second consumer
RESIDENCY_RESHARD_HOST_TRIP = "GL1803"  # tp→dp reshard inside a fused span
RESIDENCY_DEADLINE_INFEASIBLE = "GL1804"  # deadline + transition costs
RESIDENCY_MAP_REPORT = "GL1805"     # residency report: the planned map

# -- repo lint --------------------------------------------------------------
BLOCKING_CALL_IN_ASYNC = "RL401"  # time.sleep / sync HTTP in an async def
SYNC_OPEN_IN_ASYNC = "RL402"      # file I/O in an async def
HOST_SYNC_IN_JIT = "RL501"        # block_until_ready/device_get under jit
HOST_MATERIALIZE_IN_JIT = "RL502"  # np.asarray/.item() on tracers under jit
UNLOCKED_CHECK_THEN_ACT = "RL601"  # check → await → act, no asyncio.Lock
SHARED_MUTATION_ACROSS_AWAIT = "RL602"  # shared container mutated across await
DISCARDED_TASK = "RL603"          # asyncio.create_task() result dropped
LOCK_HELD_ACROSS_REMOTE_AWAIT = "RL604"  # asyncio.Lock over remote await
GATHER_WITHOUT_RETURN_EXCEPTIONS = "RL605"  # bare gather in try-less scope
REF_USE_AFTER_CONSUME = "RL701"   # one-shot ref used after resolve consumed it
REF_DOUBLE_CONSUME = "RL702"      # ref consumed again after a branch consumed
REF_NO_DOWNGRADE_PATH = "RL703"   # resolve site without a byte-downgrade path
SHM_LANE_NOT_CLOSED = "RL704"     # ShmChannel lane not closed on all exits

#: every code → default severity; the single source of truth for docs
CODE_SEVERITY = {
    SPEC_INVALID: ERROR,
    GRAPH_CYCLE: ERROR,
    DUPLICATE_NAME: ERROR,
    COMBINER_ARITY: ERROR,
    ROUTER_NO_CHILDREN: ERROR,
    IMPL_TYPE_MISMATCH: ERROR,
    METHOD_TYPE_MISMATCH: WARN,
    ROUTER_BRANCH_MISMATCH: WARN,
    DTYPE_MISMATCH: ERROR,
    SHAPE_MISMATCH: ERROR,
    UNKNOWN_SIGNATURE: INFO,
    COMBINER_INPUT_DIVERGENCE: ERROR,
    DEADLINE_INFEASIBLE: ERROR,
    HBM_OVER_BUDGET: ERROR,
    HBM_NEAR_BUDGET: WARN,
    PLAN_SEGMENT_FUSED: INFO,
    PLAN_NODE_BOUNDARY: INFO,
    PLAN_NOTHING_FUSED: WARN,
    PLAN_MODE_INVALID: ERROR,
    CACHE_ANNOTATION_INVALID: ERROR,
    CACHE_FORCED_UNCACHEABLE: ERROR,
    CACHE_SUBTREE_CACHEABLE: INFO,
    CACHE_NODE_UNCACHEABLE: INFO,
    CACHE_NOTHING_CACHEABLE: WARN,
    QOS_ANNOTATION_INVALID: ERROR,
    QOS_FALLBACK_UNKNOWN: ERROR,
    QOS_FALLBACK_IS_ROOT: ERROR,
    QOS_FALLBACK_REPORT: INFO,
    QOS_FALLBACK_FRAGILE: WARN,
    QOS_SLO_INFEASIBLE: WARN,
    TRACE_ANNOTATION_INVALID: ERROR,
    TRACE_KNOBS_WITHOUT_TRACING: WARN,
    TRACE_CONFIG_REPORT: INFO,
    HEALTH_ANNOTATION_INVALID: ERROR,
    HEALTH_KNOBS_WITHOUT_HEALTH: WARN,
    HEALTH_CONFIG_REPORT: INFO,
    PROFILE_ANNOTATION_INVALID: ERROR,
    PROFILE_KNOBS_WITHOUT_PROFILE: WARN,
    PROFILE_CONFIG_REPORT: INFO,
    MESH_ANNOTATION_INVALID: ERROR,
    MESH_OVERSUBSCRIBED: ERROR,
    PLACEMENT_UNKNOWN_SEGMENT: ERROR,
    PLACEMENT_HBM_INFEASIBLE: ERROR,
    PLACEMENT_CONFIG_REPORT: INFO,
    PLACEMENT_WITHOUT_MESH: WARN,
    PLACEMENT_TP_INDIVISIBLE: ERROR,
    FLEET_ANNOTATION_INVALID: ERROR,
    FLEET_KNOBS_WITHOUT_FLEET: WARN,
    FLEET_AUTOSCALE_BLIND: WARN,
    FLEET_REPLICAS_MISMATCH: WARN,
    FLEET_CONFIG_REPORT: INFO,
    FLEET_OBS_ANNOTATION_INVALID: ERROR,
    FLEET_OBS_WITHOUT_FLEET: WARN,
    FLEET_OBS_CONFIG_REPORT: INFO,
    ARTIFACT_ANNOTATION_INVALID: ERROR,
    ARTIFACTS_WITHOUT_PLAN: WARN,
    ARTIFACT_CONFIG_REPORT: INFO,
    DEVICE_PLANE_ANNOTATION_INVALID: ERROR,
    DEVICE_PLANE_KNOBS_WITHOUT_PLANE: WARN,
    DEVICE_PLANE_CONFIG_REPORT: INFO,
    TRACE_SIGNATURE_DRIFT: ERROR,
    TRACE_IMPLICIT_PROMOTION: WARN,
    TRACE_CALLBACK_IN_PURE_FN: ERROR,
    TRACE_MESH_INDIVISIBLE: ERROR,
    RESIDENCY_STRUCTURAL_DOWNGRADE: ERROR,
    RESIDENCY_DONATED_SHARED: ERROR,
    RESIDENCY_RESHARD_HOST_TRIP: WARN,
    RESIDENCY_DEADLINE_INFEASIBLE: WARN,
    RESIDENCY_MAP_REPORT: INFO,
    BLOCKING_CALL_IN_ASYNC: ERROR,
    SYNC_OPEN_IN_ASYNC: WARN,
    HOST_SYNC_IN_JIT: ERROR,
    HOST_MATERIALIZE_IN_JIT: ERROR,
    UNLOCKED_CHECK_THEN_ACT: ERROR,
    SHARED_MUTATION_ACROSS_AWAIT: WARN,
    DISCARDED_TASK: ERROR,
    LOCK_HELD_ACROSS_REMOTE_AWAIT: WARN,
    GATHER_WITHOUT_RETURN_EXCEPTIONS: WARN,
    REF_USE_AFTER_CONSUME: ERROR,
    REF_DOUBLE_CONSUME: ERROR,
    REF_NO_DOWNGRADE_PATH: WARN,
    SHM_LANE_NOT_CLOSED: WARN,
}


@dataclass(frozen=True)
class Finding:
    code: str
    severity: str  # ERROR | WARN | INFO
    path: str      # unit path ("p/root/child") or source location ("f.py:12")
    message: str
    #: secondary (path, message) anchors for multi-location findings —
    #: e.g. GL1802's producer and second consumer.  Rendered as SARIF
    #: ``relatedLocations`` by the CLI.
    related: tuple = ()

    def to_dict(self) -> dict:
        d = {
            "code": self.code,
            "severity": self.severity,
            "path": self.path,
            "message": self.message,
        }
        if self.related:
            d["related"] = [{"path": p, "message": m}
                            for p, m in self.related]
        return d

    def __str__(self) -> str:
        return f"{self.severity:5s} {self.code} {self.path}: {self.message}"


def make_finding(code: str, path: str, message: str,
                 severity: str | None = None,
                 related: tuple = ()) -> Finding:
    return Finding(code, severity or CODE_SEVERITY[code], path, message,
                   tuple(related))


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == ERROR]


def worst_severity(findings: list[Finding]) -> str | None:
    for sev in SEVERITIES:
        if any(f.severity == sev for f in findings):
            return sev
    return None
