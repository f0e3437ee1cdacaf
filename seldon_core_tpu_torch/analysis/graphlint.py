"""Static graph checker: deploy-time verification of inference graphs
(port of ``seldon_core_tpu/analysis/graphlint.py``: the same passes,
codes and messages).

Runs entirely on the spec — no model instantiation, no weights — so it
is cheap enough for operator admission and for CI over every shipped
example.  Three pass families:

1. **Structural** (GL1xx): cycles, duplicate names, combiner arity ≥ 2,
   router children, implementation/type and method/type compatibility.
2. **Signatures** (GL2xx): shape/dtype propagation through
   transformer→model→combiner edges using the static registry in
   ``seldon_core_tpu_torch/models/__init__.py``; mismatches report the full
   unit path.
3. **Feasibility** (GL3xx): critical-path sum of per-node ``timeout_ms``
   budgets vs. the graph-level ``seldon.io/engine-walk-timeout-ms``
   deadline, and estimated resident-weight HBM footprint vs. the device
   budget (``seldon.io/tpu-chips`` × :data:`HBM_PER_CHIP_GB`, or an
   explicit ``seldon.io/tpu-hbm-gb``).  The annotation names stay the
   reference's: the specs in ``examples/graphs/`` are shared.
4. **Graph-plan fusion** (GL6xx, only when ``seldon.io/graph-plan`` is
   set): predicts which subgraphs the plan compiler (``graph/plan.py``)
   will fuse into single segments and reports why every other node
   stays an interpreter boundary.

The per-plane admission passes (GL7xx-GL17xx) and the GL18xx residency
pass (``analysis/planlint.py``) follow; the GL16xx trace pass
(``analysis/tracelint.py``) runs when torch and the port's trace
providers are already loaded.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from seldon_core_tpu_torch.analysis.findings import (
    ARTIFACT_ANNOTATION_INVALID,
    ARTIFACT_CONFIG_REPORT,
    ARTIFACTS_WITHOUT_PLAN,
    CACHE_ANNOTATION_INVALID,
    CACHE_FORCED_UNCACHEABLE,
    CACHE_NODE_UNCACHEABLE,
    CACHE_NOTHING_CACHEABLE,
    CACHE_SUBTREE_CACHEABLE,
    COMBINER_ARITY,
    COMBINER_INPUT_DIVERGENCE,
    DEADLINE_INFEASIBLE,
    DEVICE_PLANE_ANNOTATION_INVALID,
    DEVICE_PLANE_CONFIG_REPORT,
    DEVICE_PLANE_KNOBS_WITHOUT_PLANE,
    DTYPE_MISMATCH,
    DUPLICATE_NAME,
    FLEET_ANNOTATION_INVALID,
    FLEET_AUTOSCALE_BLIND,
    FLEET_CONFIG_REPORT,
    FLEET_KNOBS_WITHOUT_FLEET,
    FLEET_OBS_ANNOTATION_INVALID,
    FLEET_OBS_CONFIG_REPORT,
    FLEET_OBS_WITHOUT_FLEET,
    FLEET_REPLICAS_MISMATCH,
    GRAPH_CYCLE,
    HBM_NEAR_BUDGET,
    HBM_OVER_BUDGET,
    HEALTH_ANNOTATION_INVALID,
    HEALTH_CONFIG_REPORT,
    HEALTH_KNOBS_WITHOUT_HEALTH,
    IMPL_TYPE_MISMATCH,
    MESH_ANNOTATION_INVALID,
    MESH_OVERSUBSCRIBED,
    METHOD_TYPE_MISMATCH,
    PLACEMENT_CONFIG_REPORT,
    PLACEMENT_HBM_INFEASIBLE,
    PLACEMENT_UNKNOWN_SEGMENT,
    PLACEMENT_WITHOUT_MESH,
    PLAN_MODE_INVALID,
    PLAN_NODE_BOUNDARY,
    PLAN_NOTHING_FUSED,
    PLAN_SEGMENT_FUSED,
    PROFILE_ANNOTATION_INVALID,
    PROFILE_CONFIG_REPORT,
    PROFILE_KNOBS_WITHOUT_PROFILE,
    QOS_ANNOTATION_INVALID,
    QOS_FALLBACK_FRAGILE,
    QOS_FALLBACK_IS_ROOT,
    QOS_FALLBACK_REPORT,
    QOS_FALLBACK_UNKNOWN,
    QOS_SLO_INFEASIBLE,
    ROUTER_BRANCH_MISMATCH,
    ROUTER_NO_CHILDREN,
    SHAPE_MISMATCH,
    SPEC_INVALID,
    TRACE_ANNOTATION_INVALID,
    TRACE_CONFIG_REPORT,
    TRACE_KNOBS_WITHOUT_TRACING,
    UNKNOWN_SIGNATURE,
    Finding,
    errors,
    make_finding,
)
from seldon_core_tpu_torch.graph.spec import (
    BUILTIN_IMPLEMENTATIONS,
    UNIT_TYPES,
    GraphValidationError,
    PredictiveUnit,
)
from seldon_core_tpu_torch.models import (
    BUILTIN_SIGNATURES,
    ModelSignature,
    signature_for,
)

WALK_DEADLINE_ANNOTATION = "seldon.io/engine-walk-timeout-ms"
CHIPS_ANNOTATION = "seldon.io/tpu-chips"
HBM_BUDGET_ANNOTATION = "seldon.io/tpu-hbm-gb"
#: per-device memory budget in GiB for ``seldon.io/tpu-chips``: an NVIDIA
#: H100 80GB HBM3 reports about 79.2 GiB of ``total_memory`` to torch
#: (``chip_smoke.py`` phase ``lint`` checks this figure against the card);
#: the reference's 16.0 is a TPU v5e chip's
HBM_PER_CHIP_GB = 79.0

#: implementation → the unit type its graph role requires
IMPL_NATURAL_TYPE = {
    "SIMPLE_MODEL": "MODEL",
    "SIMPLE_ROUTER": "ROUTER",
    "RANDOM_ABTEST": "ROUTER",
    "EPSILON_GREEDY": "ROUTER",
    "AVERAGE_COMBINER": "COMBINER",
}

#: unit type → methods the engine walk can ever invoke on it
METHODS_FOR_TYPE = {
    "MODEL": {"predict", "send_feedback", "stream"},
    "ROUTER": {"route", "send_feedback"},
    "COMBINER": {"aggregate", "send_feedback"},
    "TRANSFORMER": {"transform_input", "send_feedback"},
    "OUTPUT_TRANSFORMER": {"transform_output", "send_feedback"},
}


class GraphAnalysisError(Exception):
    """Raised by admission when a spec carries ERROR-severity findings.

    The operator's admission (the gateway and operator slice) turns it
    into a failed compile and surfaces ``findings`` on the CR's status.

    ``findings`` may include the WARN/INFO context from the rejecting
    predictors (e.g. the GL1805 residency map) — it is ordered errors
    first, and the message names only the ERRORs that caused rejection."""

    def __init__(self, findings: list[Finding]):
        fs = list(findings)
        errors = [f for f in fs if f.severity == "ERROR"]
        self.findings = errors + [f for f in fs if f.severity != "ERROR"]
        lines = "; ".join(str(f) for f in errors or fs)
        super().__init__(
            f"graphlint: {len(errors or fs)} error finding(s): {lines}"
        )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_graph(
    graph: Any,
    annotations: Optional[dict] = None,
    path_prefix: str = "",
) -> list[Finding]:
    """Lint one predictor graph (dict, JSON string, or PredictiveUnit).

    ``annotations`` supplies the deployment/predictor-scope flags the
    feasibility passes read (walk deadline, chip count, HBM budget).
    """
    ann = annotations or {}
    findings: list[Finding] = []

    if isinstance(graph, (str, bytes)):
        try:
            graph = json.loads(graph)
        except ValueError as e:
            return [make_finding(SPEC_INVALID, path_prefix or "<spec>",
                                 f"not valid JSON: {e}")]
    if isinstance(graph, dict):
        cyc = _find_dict_cycle(graph, path_prefix)
        if cyc is not None:
            # a cyclic spec cannot even be parsed into a tree — stop here
            return [cyc]
        try:
            unit = PredictiveUnit.from_dict(graph)
        except (GraphValidationError, TypeError, KeyError, ValueError) as e:
            return [make_finding(SPEC_INVALID, path_prefix or "<spec>",
                                 f"spec does not parse: {e}")]
    elif isinstance(graph, PredictiveUnit):
        unit = graph
        cyc = _find_unit_cycle(unit, path_prefix)
        if cyc is not None:
            return [cyc]
    else:
        return [make_finding(SPEC_INVALID, path_prefix or "<spec>",
                             f"unsupported spec type {type(graph).__name__}")]

    findings.extend(_structural_pass(unit, path_prefix))
    if not errors(findings):
        findings.extend(_signature_pass(unit, path_prefix))
        findings.extend(_deadline_pass(unit, ann, path_prefix))
        findings.extend(_hbm_pass(unit, ann, path_prefix))
        findings.extend(_plan_pass(unit, ann, path_prefix))
        findings.extend(_cache_pass(unit, ann, path_prefix))
        findings.extend(_qos_pass(unit, ann, path_prefix))
        findings.extend(_trace_pass(unit, ann, path_prefix))
        findings.extend(_health_pass(unit, ann, path_prefix))
        findings.extend(_profile_pass(unit, ann, path_prefix))
        findings.extend(_placement_pass(unit, ann, path_prefix))
        findings.extend(_fleet_pass(unit, ann, path_prefix))
        findings.extend(_fleet_obs_pass(unit, ann, path_prefix))
        findings.extend(_artifact_pass(unit, ann, path_prefix))
        findings.extend(_device_plane_pass(unit, ann, path_prefix))
        findings.extend(_residency_pass(unit, ann, path_prefix))
        findings.extend(_tracelint_pass(unit, ann, path_prefix))
    return findings


def _residency_pass(root: "PredictiveUnit", ann: dict,
                    prefix: str) -> list[Finding]:
    """GL18xx: abstract-interpret the fused plan's per-edge residency
    (analysis/planlint.py) — gated there on the ``seldon.io/device-plane``
    family being present.  Lazy import: planlint reads this module's
    segment/signature helpers at import time."""
    from seldon_core_tpu_torch.analysis.planlint import lint_plan_residency

    return lint_plan_residency(root, ann, prefix)


def _tracelint_pass(root: "PredictiveUnit", ann: dict,
                    prefix: str) -> list[Finding]:
    """GL16xx: trace-verify the registry entries this graph serves
    (analysis/tracelint.py).  Gated on torch AND the port's trace
    providers (``models/traceable.py``) being ALREADY imported: a
    spec-only lint never pays the traces, while ``--trace``/``--self``
    CLI runs and processes that loaded the providers get the full trace
    check."""
    import sys

    if ("torch" not in sys.modules or
            "seldon_core_tpu_torch.models.traceable" not in sys.modules):
        return []
    from seldon_core_tpu_torch.analysis.tracelint import lint_unit_traces

    return lint_unit_traces(root, ann, prefix)


def lint_deployment(dep: Any) -> list[Finding]:
    """Lint every predictor graph of a SeldonDeployment (object or dict).

    Finding paths are prefixed with the predictor name, so one rejected
    deployment pinpoints the exact graph and node."""
    from seldon_core_tpu_torch.operator.spec import SeldonDeployment

    if isinstance(dep, dict):
        try:
            dep = SeldonDeployment.from_dict(dep)
        except (GraphValidationError, TypeError, KeyError, ValueError) as e:
            return [make_finding(SPEC_INVALID, "<deployment>",
                                 f"spec does not parse: {e}")]
    findings: list[Finding] = []
    for p in dep.predictors:
        ann = {**dep.annotations, **p.annotations}
        findings.extend(lint_graph(p.graph, ann, path_prefix=p.name))
        findings.extend(_fleet_replicas_check(p, ann))
    return findings


def _fleet_replicas_check(p: Any, ann: dict) -> list[Finding]:
    """GL1304: ``seldon.io/fleet-replicas`` disagreeing with the
    predictor's ``replicas`` field means the gateway pool and the
    compiled workload will run DIFFERENT sizes — the pool routes over
    phantom (or missing) members until reconcile converges.  Deployment
    scope only: lint_graph has no predictor spec to compare against."""
    from seldon_core_tpu_torch.fleet import (
        FLEET_REPLICAS_ANNOTATION,
        fleet_config_from_annotations,
    )

    if FLEET_REPLICAS_ANNOTATION not in ann:
        return []
    try:
        cfg = fleet_config_from_annotations(ann, "lint")
    except ValueError:
        return []  # GL1301 (in _fleet_pass) already reported it
    if not cfg.enabled or cfg.replicas == p.replicas:
        return []
    return [make_finding(
        FLEET_REPLICAS_MISMATCH, _join(p.name, p.graph.name),
        f"{FLEET_REPLICAS_ANNOTATION}={cfg.replicas} but the predictor "
        f"declares replicas={p.replicas} — the gateway pool and the "
        "compiled workload would disagree on fleet size",
    )]


# ---------------------------------------------------------------------------
# structural pass (GL1xx)
# ---------------------------------------------------------------------------

def _find_dict_cycle(d: dict, prefix: str) -> Optional[Finding]:
    """Detect a node dict reachable from itself (programmatic specs can
    alias dicts; JSON cannot, but admission sees dicts, not JSON)."""
    stack: list[int] = []

    def visit(node: dict, path: str) -> Optional[Finding]:
        if id(node) in stack:
            return make_finding(
                GRAPH_CYCLE, path,
                f"node {node.get('name', '?')!r} is its own ancestor",
            )
        stack.append(id(node))
        try:
            for c in node.get("children", []) or []:
                if isinstance(c, dict):
                    out = visit(c, _join(path, c.get("name", "?")))
                    if out is not None:
                        return out
        finally:
            stack.pop()
        return None

    return visit(d, _join(prefix, d.get("name", "?")))


def _find_unit_cycle(unit: PredictiveUnit, prefix: str) -> Optional[Finding]:
    stack: list[int] = []

    def visit(u: PredictiveUnit, path: str) -> Optional[Finding]:
        if id(u) in stack:
            return make_finding(GRAPH_CYCLE, path,
                                f"node {u.name!r} is its own ancestor")
        stack.append(id(u))
        try:
            for c in u.children:
                out = visit(c, _join(path, c.name))
                if out is not None:
                    return out
        finally:
            stack.pop()
        return None

    return visit(unit, _join(prefix, unit.name))


def _structural_pass(root: PredictiveUnit, prefix: str) -> list[Finding]:
    findings: list[Finding] = []
    seen: dict[str, str] = {}  # name → first path

    def visit(u: PredictiveUnit, path: str) -> None:
        if u.name in seen:
            findings.append(make_finding(
                DUPLICATE_NAME, path,
                f"duplicate node name {u.name!r} (first at {seen[u.name]})",
            ))
        else:
            seen[u.name] = path
        t = u.resolved_type
        if t not in UNIT_TYPES:
            findings.append(make_finding(
                SPEC_INVALID, path, f"unknown unit type {t!r}"))
        impl = u.implementation
        if impl and impl not in BUILTIN_IMPLEMENTATIONS:
            findings.append(make_finding(
                SPEC_INVALID, path, f"unknown implementation {impl!r}"))
        elif impl and u.type and IMPL_NATURAL_TYPE.get(impl) != u.type:
            findings.append(make_finding(
                IMPL_TYPE_MISMATCH, path,
                f"implementation {impl} plays the "
                f"{IMPL_NATURAL_TYPE[impl]} role but the node is typed "
                f"{u.type}; the engine would call the wrong method on it",
            ))
        if t == "COMBINER" and len(u.children) < 2:
            findings.append(make_finding(
                COMBINER_ARITY, path,
                f"COMBINER has {len(u.children)} child(ren); aggregation "
                "needs at least 2",
            ))
        if t == "ROUTER" and not u.children:
            findings.append(make_finding(
                ROUTER_NO_CHILDREN, path, "ROUTER has no children to route to"))
        if impl == "RANDOM_ABTEST" and len(u.children) not in (0, 2):
            findings.append(make_finding(
                ROUTER_BRANCH_MISMATCH, path,
                f"RANDOM_ABTEST splits over exactly 2 branches but has "
                f"{len(u.children)} children",
            ))
        if impl == "EPSILON_GREEDY" and u.children:
            n = u.parameters.get("n_branches", 2)
            if isinstance(n, (int, float)) and int(n) != len(u.children):
                findings.append(make_finding(
                    ROUTER_BRANCH_MISMATCH, path,
                    f"EPSILON_GREEDY n_branches={int(n)} but the node has "
                    f"{len(u.children)} children",
                ))
        if u.methods:
            allowed = METHODS_FOR_TYPE.get(t, set())
            bad = [m for m in u.methods if m.lower() not in allowed]
            if bad:
                findings.append(make_finding(
                    METHOD_TYPE_MISMATCH, path,
                    f"methods {bad} are never invoked on a {t} node "
                    f"(allowed: {sorted(allowed)})",
                ))
        for c in u.children:
            visit(c, _join(path, c.name))

    visit(root, _join(prefix, root.name))
    return findings


# ---------------------------------------------------------------------------
# signature pass (GL2xx)
# ---------------------------------------------------------------------------

def _node_signature(u: PredictiveUnit) -> tuple[Optional[ModelSignature], bool]:
    """(signature, known): the node's declared contract, if any."""
    model_class = u.parameters.get("model_class")
    if isinstance(model_class, str) and model_class:
        sig = signature_for(model_class)
        return sig, sig is not None
    if u.implementation:
        return BUILTIN_SIGNATURES.get(u.implementation), True
    return None, True  # remote/container node: no static contract


def _shapes_compatible(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    return all(x is None or y is None or x == y for x, y in zip(a, b))


def _fmt(shape: Optional[tuple], dtype: Optional[str]) -> str:
    dims = "?" if shape is None else \
        "[" + ", ".join("?" if d is None else str(d) for d in shape) + "]"
    return f"{dtype or '?'}{dims}"


def _signature_pass(root: PredictiveUnit, prefix: str) -> list[Finding]:
    findings: list[Finding] = []

    def check_edge(path: str, src: str,
                   in_shape, in_dtype, sig: ModelSignature) -> None:
        if in_dtype and sig.input_dtype and in_dtype != sig.input_dtype:
            findings.append(make_finding(
                DTYPE_MISMATCH, path,
                f"receives {_fmt(in_shape, in_dtype)} from {src} but "
                f"expects dtype {sig.input_dtype}",
            ))
        elif (in_shape is not None and sig.input_shape is not None
                and not _shapes_compatible(in_shape, sig.input_shape)):
            findings.append(make_finding(
                SHAPE_MISMATCH, path,
                f"receives {_fmt(in_shape, in_dtype)} from {src} but "
                f"expects {_fmt(sig.input_shape, sig.input_dtype)}",
            ))

    def transformed(u: PredictiveUnit, path: str, in_shape, in_dtype,
                    src: str, sig: Optional[ModelSignature]) -> tuple:
        """(shape, dtype, src) after this node transforms the payload."""
        if sig is not None:
            check_edge(path, src, in_shape, in_dtype, sig)
            if sig.output_shape is not None or sig.output_dtype is not None:
                return sig.output_shape, sig.output_dtype, u.name
            if sig.input_shape is None and sig.input_dtype is None:
                # all-None signature = declared passthrough (outlier scorer)
                return in_shape, in_dtype, src
        # transforms the payload with no declared output contract
        return None, None, u.name

    def visit(u: PredictiveUnit, path: str, in_shape, in_dtype,
              src: str) -> tuple:
        """Returns the (shape, dtype) this subtree hands to its consumer."""
        t = u.resolved_type
        sig, known = _node_signature(u)
        if not known:
            findings.append(make_finding(
                UNKNOWN_SIGNATURE, path,
                f"model_class {u.parameters.get('model_class')!r} has no "
                "registered signature; edge checks skipped",
            ))
        # downward transform: MODEL.predict / TRANSFORMER.transform_input /
        # leaf OUTPUT_TRANSFORMER.transform_output (graph/engine.py order);
        # ROUTER/COMBINER/non-leaf OUTPUT_TRANSFORMER descend as-is
        out_shape, out_dtype, my_src = in_shape, in_dtype, src
        if t in ("MODEL", "TRANSFORMER") or (
                t == "OUTPUT_TRANSFORMER" and not u.children):
            out_shape, out_dtype, my_src = transformed(
                u, path, in_shape, in_dtype, src, sig)
        if not u.children:
            return out_shape, out_dtype
        child_outs = [
            visit(c, _join(path, c.name), out_shape, out_dtype, my_src)
            for c in u.children
        ]
        if t == "COMBINER":
            kn = [(c.name, o) for c, o in zip(u.children, child_outs)
                  if o != (None, None)]
            if len(kn) >= 2:
                (n0, o0) = kn[0]
                for n1, o1 in kn[1:]:
                    d_ok = not (o0[1] and o1[1]) or o0[1] == o1[1]
                    s_ok = (o0[0] is None or o1[0] is None
                            or _shapes_compatible(o0[0], o1[0]))
                    if not (d_ok and s_ok):
                        findings.append(make_finding(
                            COMBINER_INPUT_DIVERGENCE, path,
                            f"children {n0!r} ({_fmt(*o0)}) and {n1!r} "
                            f"({_fmt(*o1)}) produce incompatible outputs; "
                            "aggregation would fail at request time",
                        ))
            common = child_outs[0]
            return common if all(o == common for o in child_outs) else (None, None)
        # ROUTER picks one child; other types take the first child's output
        if t == "ROUTER":
            common = child_outs[0]
            merged = (common if all(o == common for o in child_outs)
                      else (None, None))
        else:
            merged = child_outs[0]
        if t == "OUTPUT_TRANSFORMER":
            # non-leaf: transform_output applies to the merged child output
            out_shape, out_dtype, _ = transformed(
                u, path, merged[0], merged[1], u.children[0].name, sig)
            return out_shape, out_dtype
        return merged

    visit(root, _join(prefix, root.name), None, None, "<request>")
    return findings


# ---------------------------------------------------------------------------
# feasibility passes (GL3xx)
# ---------------------------------------------------------------------------

def _num(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _deadline_pass(root: PredictiveUnit, ann: dict,
                   prefix: str) -> list[Finding]:
    deadline_ms = _num(ann.get(WALK_DEADLINE_ANNOTATION))
    if not deadline_ms or deadline_ms <= 0:
        return []

    def critical(u: PredictiveUnit, path: str) -> tuple[float, list[str]]:
        """(worst-case ms, chain) along the deepest budgeted path.  Child
        fan-out is concurrent (asyncio.gather), so siblings take max."""
        own = _num(u.parameters.get("timeout_ms")) or 0.0
        best: tuple[float, list[str]] = (0.0, [])
        for c in u.children:
            sub = critical(c, _join(path, c.name))
            if sub[0] > best[0]:
                best = sub
        chain = ([f"{u.name}({own:g}ms)"] if own else []) + best[1]
        return own + best[0], chain

    total, chain = critical(root, _join(prefix, root.name))
    if total > deadline_ms:
        return [make_finding(
            DEADLINE_INFEASIBLE, _join(prefix, root.name),
            f"critical path {' -> '.join(chain)} needs {total:g}ms but "
            f"{WALK_DEADLINE_ANNOTATION} is {deadline_ms:g}ms — the walk "
            "deadline always fires before the nodes' own budgets",
        )]
    return []


def _hbm_pass(root: PredictiveUnit, ann: dict, prefix: str) -> list[Finding]:
    budget_gb = _num(ann.get(HBM_BUDGET_ANNOTATION))
    if budget_gb is None:
        chips = _num(ann.get(CHIPS_ANNOTATION))
        if not chips or chips <= 0:
            return []
        budget_gb = chips * HBM_PER_CHIP_GB
    total = 0
    for u in root.walk():
        sig, _ = _node_signature(u)
        if sig is not None:
            total += sig.hbm_bytes
    total_gb = total / (1 << 30)
    path = _join(prefix, root.name)
    if total_gb > budget_gb:
        return [make_finding(
            HBM_OVER_BUDGET, path,
            f"estimated resident weights {total_gb:.2f} GiB exceed the "
            f"{budget_gb:g} GiB slice budget",
        )]
    if total_gb > 0.8 * budget_gb:
        return [make_finding(
            HBM_NEAR_BUDGET, path,
            f"estimated resident weights {total_gb:.2f} GiB are above 80% "
            f"of the {budget_gb:g} GiB slice budget (no headroom for KV "
            "caches/activations)",
        )]
    return []


# ---------------------------------------------------------------------------
# graph-plan fusion pass (GL6xx)
# ---------------------------------------------------------------------------

PLAN_ANNOTATION = "seldon.io/graph-plan"
#: node types the plan compiler may fuse (mirrors graph/plan.py)
PLAN_FUSIBLE_TYPES = ("MODEL", "TRANSFORMER", "OUTPUT_TRANSFORMER",
                      "COMBINER")
#: built-ins with a pure on-device implementation the compiler can trace
#: (SIMPLE_MODEL is float64-on-host by contract, so it never fuses)
PLAN_FUSIBLE_BUILTINS = ("AVERAGE_COMBINER",)


def _plan_boundary_reason(u: PredictiveUnit) -> Optional[str]:
    """Why this node statically cannot fuse, or None if it can.

    Mirrors the runtime test in ``graph/plan.py`` with the knowledge the
    spec carries: the signature registry's ``pure_fn`` flag stands in for
    "exposes a pure tensor function" (the runtime inspects the live
    object; admission cannot)."""
    t = u.resolved_type
    if t == "ROUTER":
        return "ROUTER: data-dependent branch choice cannot be traced"
    if t not in PLAN_FUSIBLE_TYPES:
        return f"type {t} is not fusible"
    if u.endpoint.service_host and u.endpoint.type != "LOCAL":
        return "remote endpoint: crosses a transport boundary"
    if u.implementation:
        if u.implementation in PLAN_FUSIBLE_BUILTINS:
            return None
        return (f"built-in {u.implementation} has no pure on-device "
                "implementation")
    mc = u.parameters.get("model_class")
    if not (isinstance(mc, str) and mc):
        return "no implementation or model_class to resolve in-process"
    sig = signature_for(mc)
    if sig is None:
        return (f"model_class {mc!r} has no registered signature; the "
                "plan compiler cannot prove a pure tensor function")
    if not sig.pure_fn:
        return (f"model_class {mc!r} is not registered as a pure tensor "
                "function (learning/stateful component)")
    return None


def _plan_pass(root: PredictiveUnit, ann: dict,
               prefix: str) -> list[Finding]:
    """Fusion-feasibility report for ``seldon.io/graph-plan`` graphs:
    which segments the plan compiler will fuse (GL601) and why every
    other node stays an interpreter boundary (GL602).  Advisory — the
    runtime re-derives fusibility from the live components; this pass
    gives the same answer from the spec alone so a CI gate can catch
    fusion regressions at admission time."""
    mode = str(ann.get(PLAN_ANNOTATION, "walk")).strip().lower()
    if mode == "walk":
        return []
    if mode != "fused":
        return [make_finding(
            PLAN_MODE_INVALID, _join(prefix, root.name),
            f"{PLAN_ANNOTATION}={mode!r} is not a plan mode "
            "(expected 'fused' or 'walk')",
        )]
    findings: list[Finding] = []
    segments: list[list[str]] = []

    def subtree_fusible(u: PredictiveUnit) -> bool:
        if _plan_boundary_reason(u) is not None:
            return False
        if u.resolved_type == "COMBINER" and not u.children:
            return False
        return all(subtree_fusible(c) for c in u.children)

    def visit(u: PredictiveUnit, path: str) -> None:
        if subtree_fusible(u):
            segments.append([n.name for n in u.walk()])
            findings.append(make_finding(
                PLAN_SEGMENT_FUSED, path,
                f"fuses {len(segments[-1])} node(s) into one jitted "
                f"segment: {' -> '.join(segments[-1])}",
            ))
            return
        # fusible MODEL/TRANSFORMER chain above the first boundary
        run: list[PredictiveUnit] = []
        cur = u
        while (cur.resolved_type in ("MODEL", "TRANSFORMER")
               and len(cur.children) == 1
               and _plan_boundary_reason(cur) is None):
            run.append(cur)
            cur = cur.children[0]
        if run:
            segments.append([n.name for n in run])
            findings.append(make_finding(
                PLAN_SEGMENT_FUSED, path,
                f"fuses a {len(run)}-node chain into one jitted segment: "
                f"{' -> '.join(segments[-1])} (rest interpreted)",
            ))
            visit(cur, _join(path, cur.name))
            return
        reason = _plan_boundary_reason(u) or \
            "a descendant prevents whole-subtree fusion"
        findings.append(make_finding(
            PLAN_NODE_BOUNDARY, path,
            f"stays an interpreter boundary: {reason}",
        ))
        for c in u.children:
            visit(c, _join(path, c.name))

    visit(root, _join(prefix, root.name))
    if not segments:
        findings.append(make_finding(
            PLAN_NOTHING_FUSED, _join(prefix, root.name),
            f"{PLAN_ANNOTATION}=fused requested but no segment fuses — "
            "the engine will fall back to the interpreted walk",
        ))
    return findings


# ---------------------------------------------------------------------------
# prediction-cache pass (GL7xx)
# ---------------------------------------------------------------------------

#: cache annotations validated here (values live in caching/store.py)
CACHE_ANNOTATION = "seldon.io/prediction-cache"


def _cache_boundary_reason(u: PredictiveUnit) -> Optional[str]:
    """Why this node can never serve from the prediction cache, or None.

    Mirrors the runtime test (``caching/policy.py``: pure tensor function
    AND deterministic) with what the spec can prove.  Determinism comes
    from the signature registry (``models/__init__.py``) — RNG routers,
    learning components, and per-request-meta-dependent classes register
    ``deterministic=False`` there, so this pass never hardcodes names."""
    if u.parameters.get("cacheable") is False:
        return "opted out (`cacheable: false` parameter)"
    t = u.resolved_type
    if t == "ROUTER":
        sig = BUILTIN_SIGNATURES.get(u.implementation or "")
        if sig is not None and not sig.deterministic:
            return (f"router {u.implementation} is registered "
                    "non-deterministic (RNG/learned routing state)")
        return "ROUTER: data-dependent control flow re-runs per request"
    if u.endpoint.service_host and u.endpoint.type != "LOCAL":
        return "remote endpoint: determinism cannot be proven over transport"
    if u.implementation:
        sig = BUILTIN_SIGNATURES.get(u.implementation)
        if sig is None:
            return (f"built-in {u.implementation} has no registered "
                    "signature; determinism cannot be proven")
        if not sig.deterministic:
            return (f"built-in {u.implementation} is registered "
                    "non-deterministic")
        if not sig.pure_fn:
            return (f"built-in {u.implementation} is not a pure on-device "
                    "tensor function")
        return None
    mc = u.parameters.get("model_class")
    if not (isinstance(mc, str) and mc):
        return "no implementation or model_class to resolve in-process"
    sig = signature_for(mc)
    if sig is None:
        return (f"model_class {mc!r} has no registered signature; "
                "determinism cannot be proven")
    if not sig.deterministic:
        return (f"model_class {mc!r} is registered non-deterministic "
                "(stateful/learning or per-request-meta-dependent output)")
    if not sig.pure_fn:
        return (f"model_class {mc!r} is not registered as a pure tensor "
                "function")
    return None


def _cache_pass(root: PredictiveUnit, ann: dict,
                prefix: str) -> list[Finding]:
    """Prediction-cache admission (GL7xx, active when
    ``seldon.io/prediction-cache`` is set): validates the annotation
    values (GL701), reports which maximal subtrees will serve from the
    engine-tier cache (GL703) and why every other node always bypasses
    (GL704), and ERRORS on nodes force-annotated ``cacheable: true`` that
    the runtime would have to bypass (GL702) — an unsatisfiable spec must
    reject at admission, not silently under-cache in production."""
    if CACHE_ANNOTATION not in ann:
        return []
    from seldon_core_tpu_torch.caching import config_from_annotations

    path0 = _join(prefix, root.name)
    try:
        cfg = config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(CACHE_ANNOTATION_INVALID, path0, str(e))]
    if cfg is None:
        return []
    findings: list[Finding] = []
    cacheable_subtrees: list[list[str]] = []

    def subtree_ok(u: PredictiveUnit) -> bool:
        if _cache_boundary_reason(u) is not None:
            return False
        if u.resolved_type == "COMBINER" and not u.children:
            return False
        return all(subtree_ok(c) for c in u.children)

    def first_reason(u: PredictiveUnit) -> Optional[str]:
        r = _cache_boundary_reason(u)
        if r is not None:
            return f"{u.name}: {r}"
        for c in u.children:
            rr = first_reason(c)
            if rr is not None:
                return rr
        return None

    def visit(u: PredictiveUnit, path: str) -> None:
        ok = subtree_ok(u)
        if u.parameters.get("cacheable") is True and not ok:
            findings.append(make_finding(
                CACHE_FORCED_UNCACHEABLE, path,
                f"annotated `cacheable: true` but the subtree can never "
                f"serve from the cache ({first_reason(u)}); the runtime "
                "would silently bypass — fix the node or drop the "
                "annotation",
            ))
            # fall through: still report the boundary structure below
        if ok:
            cacheable_subtrees.append([n.name for n in u.walk()])
            findings.append(make_finding(
                CACHE_SUBTREE_CACHEABLE, path,
                f"caches as one unit ({len(cacheable_subtrees[-1])} "
                f"node(s)): {' -> '.join(cacheable_subtrees[-1])}",
            ))
            return
        reason = _cache_boundary_reason(u) or \
            "a descendant prevents whole-subtree caching"
        findings.append(make_finding(
            CACHE_NODE_UNCACHEABLE, path,
            f"always bypasses the prediction cache: {reason}",
        ))
        for c in u.children:
            visit(c, _join(path, c.name))

    visit(root, path0)
    if not cacheable_subtrees:
        findings.append(make_finding(
            CACHE_NOTHING_CACHEABLE, path0,
            f"{CACHE_ANNOTATION} enabled but no subtree is cacheable — "
            "only the gateway tier (raw-body dedup) will cache",
        ))
    return findings


# ---------------------------------------------------------------------------
# QoS pass (GL8xx)
# ---------------------------------------------------------------------------

SLO_ANNOTATION = "seldon.io/slo-p95-ms"
QOS_FALLBACK_ANNOTATION = "seldon.io/qos-fallback"


def _fallback_fragility(u: PredictiveUnit) -> Optional[str]:
    """Why this fallback-subtree node may not survive the overload that
    triggered degraded mode — checked against the signature registry,
    like the plan/cache passes.  A fallback that is itself remote, or
    whose latency/purity the registry cannot vouch for, is a WARN: the
    degraded path exists precisely for when the expensive path is sick,
    so it should be provably local and cheap."""
    if u.endpoint.service_host and u.endpoint.type != "LOCAL":
        return ("remote endpoint: the fallback would depend on another "
                "pod exactly when the system is degraded")
    mc = u.parameters.get("model_class")
    if isinstance(mc, str) and mc:
        sig = signature_for(mc)
        if sig is None:
            return (f"model_class {mc!r} has no registered signature; the "
                    "fallback's cost cannot be proven cheap")
    return None


def _qos_pass(root: PredictiveUnit, ann: dict,
              prefix: str) -> list[Finding]:
    """QoS admission (GL8xx, active when any ``seldon.io/slo-p95-ms`` /
    ``seldon.io/qos-*`` annotation is set): validates annotation values
    (GL801), resolves the ``seldon.io/qos-fallback`` subgraph (GL802
    unknown node / GL803 root are ERRORs — a deployment whose degraded
    mode can never engage must reject at admission, not discover it
    during its first overload), reports the fallback subtree (GL804),
    warns when that subtree is itself fragile under overload per the
    signature registry (GL805), and warns when per-node ``timeout_ms``
    budgets already exceed the p95 SLO target (GL806 — the limit
    controller would shed forever chasing an unreachable target)."""
    from seldon_core_tpu_torch.qos import qos_from_annotations

    qos_keys = [k for k in ann
                if k == SLO_ANNOTATION or k.startswith("seldon.io/qos-")]
    if not qos_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = qos_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(QOS_ANNOTATION_INVALID, path0, str(e))]
    if cfg is None:
        return []
    findings: list[Finding] = []
    nodes = {u.name: u for u in root.walk()}
    if cfg.fallback_node:
        target = nodes.get(cfg.fallback_node)
        if target is None:
            findings.append(make_finding(
                QOS_FALLBACK_UNKNOWN, path0,
                f"{QOS_FALLBACK_ANNOTATION}={cfg.fallback_node!r} names a "
                f"node that is not in the graph (nodes: "
                f"{sorted(nodes)})",
            ))
        elif target is root:
            findings.append(make_finding(
                QOS_FALLBACK_IS_ROOT, path0,
                f"{QOS_FALLBACK_ANNOTATION}={cfg.fallback_node!r} names "
                "the graph root: falling back to the primary is not a "
                "degraded mode",
            ))
        else:
            sub = [n.name for n in target.walk()]
            findings.append(make_finding(
                QOS_FALLBACK_REPORT, path0,
                f"degraded mode serves the {len(sub)}-node subtree "
                f"{' -> '.join(sub)} when a breaker opens or shed level "
                f">= {cfg.degrade_shed_level}",
            ))
            for n in target.walk():
                reason = _fallback_fragility(n)
                if reason is not None:
                    findings.append(make_finding(
                        QOS_FALLBACK_FRAGILE,
                        _join(path0, n.name),
                        f"fallback subtree node {n.name!r}: {reason}",
                    ))
    if cfg.slo_p95_ms:
        def critical(u: PredictiveUnit) -> float:
            own = _num(u.parameters.get("timeout_ms")) or 0.0
            return own + max((critical(c) for c in u.children), default=0.0)

        worst = critical(root)
        if worst > cfg.slo_p95_ms:
            findings.append(make_finding(
                QOS_SLO_INFEASIBLE, path0,
                f"per-node timeout_ms budgets allow a {worst:g}ms critical "
                f"path but {SLO_ANNOTATION} targets {cfg.slo_p95_ms:g}ms — "
                "the admission controller would shed towards an "
                "unreachable p95",
            ))
    return findings


# ---------------------------------------------------------------------------
# tracing admission pass (GL9xx)
# ---------------------------------------------------------------------------

def _trace_pass(root: PredictiveUnit, ann: dict,
                prefix: str) -> list[Finding]:
    """Tracing admission (GL9xx, active when any ``seldon.io/tracing`` /
    ``seldon.io/trace-*`` annotation is set): validates the annotation
    values through the same parser the operator and engine use (GL901 —
    an out-of-range ``trace-sample`` or non-numeric ``trace-slow-ms``
    rejects here, before a deployment ships with silently-disabled
    observability), warns when trace knobs are set while the subsystem
    itself is off (GL902), and reports the effective head/tail sampling
    configuration (GL903)."""
    from seldon_core_tpu_torch.utils.tracing import (
        EXPORT_ANNOTATION,
        SAMPLE_ANNOTATION,
        SLOW_MS_ANNOTATION,
        TRACING_ANNOTATION,
        TRACING_MAX_ANNOTATION,
        trace_config_from_annotations,
    )

    family = {TRACING_ANNOTATION, TRACING_MAX_ANNOTATION,
              SAMPLE_ANNOTATION, EXPORT_ANNOTATION, SLOW_MS_ANNOTATION}
    trace_keys = [k for k in ann if k in family]
    if not trace_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = trace_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(TRACE_ANNOTATION_INVALID, path0, str(e))]
    if not cfg.enabled:
        knobs = sorted(k for k in trace_keys if k != TRACING_ANNOTATION)
        if knobs:
            return [make_finding(
                TRACE_KNOBS_WITHOUT_TRACING, path0,
                f"{', '.join(knobs)} set but {TRACING_ANNOTATION} is not "
                "enabled — the knobs have no effect",
            )]
        return []
    detail = (f"tracing on: head sample rate {cfg.sample_rate:g}; tail "
              f"keeps error traces and traces >= {cfg.slow_ms:g}ms; "
              f"ring {cfg.max_traces}")
    if cfg.export_path:
        detail += f"; OTLP JSON-lines export -> {cfg.export_path}"
    return [make_finding(TRACE_CONFIG_REPORT, path0, detail)]


def _health_pass(root: PredictiveUnit, ann: dict,
                 prefix: str) -> list[Finding]:
    """Health-plane admission (GL10xx, active when any ``seldon.io/health*``
    or ``seldon.io/slo-availability`` annotation is set): validates the
    family through the same parser the operator and runtimes use (GL1001
    — a malformed sample interval or an availability objective outside
    (0, 1) rejects here, before a deployment ships with a silently-dead
    burn monitor), warns when health knobs are set while the plane itself
    is off (GL1002), and reports the effective sampler / flight-recorder
    / SLO configuration (GL1003)."""
    from seldon_core_tpu_torch.health.config import (
        HEALTH_ANNOTATION,
        HEALTH_FLIGHT_RECORDS_ANNOTATION,
        HEALTH_SAMPLE_MS_ANNOTATION,
        HEALTH_TIMELINE_ANNOTATION,
        SLO_AVAILABILITY_ANNOTATION,
        health_config_from_annotations,
    )

    family = {HEALTH_ANNOTATION, HEALTH_SAMPLE_MS_ANNOTATION,
              HEALTH_TIMELINE_ANNOTATION, HEALTH_FLIGHT_RECORDS_ANNOTATION,
              SLO_AVAILABILITY_ANNOTATION}
    health_keys = [k for k in ann if k in family]
    if not health_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = health_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(HEALTH_ANNOTATION_INVALID, path0, str(e))]
    if not cfg.enabled:
        knobs = sorted(k for k in health_keys if k != HEALTH_ANNOTATION)
        if knobs:
            return [make_finding(
                HEALTH_KNOBS_WITHOUT_HEALTH, path0,
                f"{', '.join(knobs)} set but {HEALTH_ANNOTATION} is not "
                f"enabled (and no {SLO_AVAILABILITY_ANNOTATION} objective "
                "implies it) — the knobs have no effect",
            )]
        return []
    detail = (f"health plane on: sampler every {cfg.sample_ms:g}ms "
              f"(timeline {cfg.timeline}); flight recorder keeps "
              f"{cfg.flight_records} requests")
    slo_bits = []
    if cfg.slo_availability is not None:
        slo_bits.append(f"availability >= {cfg.slo_availability:g}")
    if cfg.slo_p95_ms is not None:
        slo_bits.append(f"p95 <= {cfg.slo_p95_ms:g}ms")
    detail += ("; burn monitor: " + ", ".join(slo_bits) if slo_bits
               else "; no SLO declared — burn monitor idle")
    return [make_finding(HEALTH_CONFIG_REPORT, path0, detail)]


def _profile_pass(root: PredictiveUnit, ann: dict,
                  prefix: str) -> list[Finding]:
    """Profiling-plane admission (GL11xx, active when any
    ``seldon.io/profile*`` annotation is set): validates the family
    through the same parser the operator and runtimes use (GL1101 — a
    sampling rate outside (0, 1000] or a storm threshold below 2 rejects
    here, before a deployment ships with a silently-dead profiler),
    warns when profile knobs are set while the plane itself is off
    (GL1102), and reports the effective sampler / compile-watch
    configuration (GL1103)."""
    from seldon_core_tpu_torch.profiling.config import (
        PROFILE_ANNOTATION,
        PROFILE_HZ_ANNOTATION,
        PROFILE_STACKS_ANNOTATION,
        PROFILE_STORM_ANNOTATION,
        PROFILE_WINDOW_S_ANNOTATION,
        profile_config_from_annotations,
    )

    family = {PROFILE_ANNOTATION, PROFILE_HZ_ANNOTATION,
              PROFILE_STACKS_ANNOTATION, PROFILE_WINDOW_S_ANNOTATION,
              PROFILE_STORM_ANNOTATION}
    profile_keys = [k for k in ann if k in family]
    if not profile_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = profile_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(PROFILE_ANNOTATION_INVALID, path0, str(e))]
    if not cfg.enabled:
        knobs = sorted(k for k in profile_keys if k != PROFILE_ANNOTATION)
        if knobs:
            return [make_finding(
                PROFILE_KNOBS_WITHOUT_PROFILE, path0,
                f"{', '.join(knobs)} set but {PROFILE_ANNOTATION} is not "
                "enabled — the knobs have no effect",
            )]
        return []
    detail = (f"profiling plane on: host sampler at {cfg.hz:g}Hz "
              f"(stack table {cfg.stacks}, capture windows up to "
              f"{cfg.window_s:g}s); recompile storm at "
              f">= {cfg.storm} compiles/segment/min")
    return [make_finding(PROFILE_CONFIG_REPORT, path0, detail)]


def _static_segments(root: PredictiveUnit) -> list[list[PredictiveUnit]]:
    """The fused segments the plan compiler will form, derived from the
    spec exactly as :func:`_plan_pass` derives them (whole fusible
    subtrees, else maximal MODEL/TRANSFORMER chains).  A segment's name
    at runtime is its first member's node name — placement overrides
    reference these."""
    segments: list[list[PredictiveUnit]] = []

    def subtree_fusible(u: PredictiveUnit) -> bool:
        if _plan_boundary_reason(u) is not None:
            return False
        if u.resolved_type == "COMBINER" and not u.children:
            return False
        return all(subtree_fusible(c) for c in u.children)

    def visit(u: PredictiveUnit) -> None:
        if subtree_fusible(u):
            segments.append(list(u.walk()))
            return
        run: list[PredictiveUnit] = []
        cur = u
        while (cur.resolved_type in ("MODEL", "TRANSFORMER")
               and len(cur.children) == 1
               and _plan_boundary_reason(cur) is None):
            run.append(cur)
            cur = cur.children[0]
        if run:
            segments.append(run)
            visit(cur)
            return
        for c in u.children:
            visit(c)

    visit(root)
    return segments


def _visible_devices() -> int:
    """CUDA device count, but ONLY when torch is already loaded in this
    process (the runtimes always have it; a spec-only lint run must not
    pay the import).  0 → the oversubscription check is skipped."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        return int(torch.cuda.device_count())
    except Exception:
        return 0


def _placement_pass(root: PredictiveUnit, ann: dict,
                    prefix: str) -> list[Finding]:
    """Placement-plane admission (GL12xx, active when ``seldon.io/mesh``
    or ``seldon.io/placement`` is set): validates both annotations
    through the same parser the operator and runtimes use (GL1201),
    rejects meshes whose axis product exceeds the visible device
    inventory (GL1202 — ``dp=16`` on 8 devices fails here, not at the
    first sharded dispatch), rejects overrides naming segments the plan
    compiler will not form (GL1203), proves per-device HBM feasibility
    against the GL3xx budget split across the mesh (GL1204 — with a ``tp``
    axis, segments whose members declare ``tp_param_specs`` plan as tp
    spans first, so covered weights divide by tp instead of replicating
    and a spec infeasible at tp=1 can admit at tp=2), warns when
    overrides are set without a mesh (GL1206), and reports the effective
    mesh + assignments including planned tp spans (GL1205)."""
    from seldon_core_tpu_torch.placement.config import (
        MESH_ANNOTATION,
        PLACEMENT_ANNOTATION,
        placement_config_from_annotations,
    )

    family = {MESH_ANNOTATION, PLACEMENT_ANNOTATION}
    placement_keys = [k for k in ann if k in family]
    if not placement_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = placement_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(MESH_ANNOTATION_INVALID, path0, str(e))]
    if not cfg.enabled:
        if cfg.overrides:
            return [make_finding(
                PLACEMENT_WITHOUT_MESH, path0,
                f"{PLACEMENT_ANNOTATION} set but {MESH_ANNOTATION} is "
                "absent — without a mesh there is no placement plane and "
                "the pins have no effect",
            )]
        return []
    findings: list[Finding] = []
    visible = _visible_devices()
    if visible and cfg.n_devices > visible:
        findings.append(make_finding(
            MESH_OVERSUBSCRIBED, path0,
            f"{MESH_ANNOTATION}={cfg.spec()!r} wants {cfg.n_devices} "
            f"device(s) but only {visible} are visible — the runtime "
            "would fail to build the mesh",
        ))
    mode = str(ann.get(PLAN_ANNOTATION, "walk")).strip().lower()
    segments = _static_segments(root) if mode == "fused" else []
    seg_names = [seg[0].name for seg in segments]
    if mode == "fused":
        for seg_name in cfg.override_map():
            if seg_name not in seg_names:
                known = ", ".join(seg_names) or "none"
                findings.append(make_finding(
                    PLACEMENT_UNKNOWN_SEGMENT, path0,
                    f"{PLACEMENT_ANNOTATION} pins segment {seg_name!r} "
                    "but the plan compiler will not form a segment with "
                    f"that root (segments: {known})",
                ))
    # per-device HBM feasibility: the GL3xx slice budget divided across
    # the mesh must hold the planner's worst-loaded device
    budget_gb = _num(ann.get(HBM_BUDGET_ANNOTATION))
    if budget_gb is None:
        chips = _num(ann.get(CHIPS_ANNOTATION))
        budget_gb = chips * HBM_PER_CHIP_GB if chips and chips > 0 else None
    tp_spans: list = []
    if budget_gb is not None and budget_gb > 0 and segments:
        from seldon_core_tpu_torch.placement.planner import (
            SegmentFacts,
            plan_placement,
        )

        facts = []
        for seg in segments:
            hbm = 0
            shardable = True
            tp_bytes = 0
            for u in seg:
                sig, _ = _node_signature(u)
                if sig is None:
                    shardable = False
                    continue
                hbm += sig.hbm_bytes
                if not sig.batch_shardable:
                    shardable = False
                # static tp-shardability: a member declaring per-param
                # layouts contributes its weights to the tp span (the
                # runtime's resolve_layout sharpens this to the exact
                # covered bytes; GL1207 rejects indivisible dims)
                if cfg.tp > 1 and sig.tp_param_specs:
                    tp_bytes += sig.hbm_bytes
            facts.append(SegmentFacts(
                name=seg[0].name, hbm_bytes=hbm, measured_hbm_bytes=0,
                shardable=shardable and cfg.dp > 1,
                members=tuple(sorted(u.name for u in seg)),
                tp_shardable_bytes=tp_bytes,
            ))
        per_device = budget_gb * (1 << 30) / cfg.n_devices
        plan = plan_placement(
            facts, n_devices=cfg.n_devices, dp=cfg.dp, tp=cfg.tp,
            mesh_spec=cfg.spec(),
            overrides={k: min(v, cfg.n_devices - 1)
                       for k, v in cfg.override_map().items()},
            capacity_bytes=int(per_device),
        )
        tp_spans = [a for a in plan.assignments if a.source == "tp-span"]
        if plan.over_capacity:
            worst = max(plan.device_hbm_bytes.values(), default=0)
            findings.append(make_finding(
                PLACEMENT_HBM_INFEASIBLE, path0,
                f"worst-loaded device holds {worst / (1 << 30):.2f} GiB "
                f"of weights but the {budget_gb:g} GiB slice budget "
                f"leaves only {per_device / (1 << 30):.2f} GiB per "
                f"device across {cfg.n_devices} device(s) "
                f"(over-capacity devices: "
                f"{', '.join(str(d) for d in plan.over_capacity)})",
            ))
    detail = f"placement plane on: mesh {cfg.spec()!r} over {cfg.n_devices} device(s)"
    if cfg.override_map():
        pins = ", ".join(f"{s}->{d}" for s, d in
                         sorted(cfg.override_map().items()))
        detail += f"; pinned: {pins}"
    if mode == "fused":
        detail += f"; {len(segments)} fused segment(s) to place"
    else:
        detail += ("; graph-plan is not 'fused' — no segments to place "
                   "until it is")
    if tp_spans:
        spans = ", ".join(
            f"{a.segment}(tp={cfg.tp}, "
            f"{a.tp_bytes_per_device / (1 << 20):.2f} MiB/device)"
            for a in tp_spans)
        detail += f"; planned tp span(s): {spans}"
    findings.append(make_finding(PLACEMENT_CONFIG_REPORT, path0, detail))
    return findings


def _fleet_pass(root: PredictiveUnit, ann: dict,
                prefix: str) -> list[Finding]:
    """Fleet-plane admission (GL13xx, active when any ``seldon.io/fleet-*``
    annotation is set): validates the family through the same parser the
    gateway and operator use (GL1301), warns when routing/autoscale knobs
    are set without ``seldon.io/fleet-replicas`` — they are dead without
    the pool (GL1302) — and when autoscale is on but neither the health
    plane nor the profiling plane is, leaving the scaler blind to burn
    and demand signals (GL1303), and reports the effective config
    (GL1305).  GL1304 (replicas vs predictor spec) runs at deployment
    scope in lint_deployment."""
    from seldon_core_tpu_torch.fleet import (
        FLEET_AUTOSCALE_ANNOTATION,
        FLEET_REPLICAS_ANNOTATION,
        fleet_config_from_annotations,
    )

    fleet_keys = [k for k in ann
                  if k.startswith("seldon.io/fleet-")
                  and not k.startswith("seldon.io/fleet-obs-")]
    if not fleet_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = fleet_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(FLEET_ANNOTATION_INVALID, path0, str(e))]
    if not cfg.enabled:
        return [make_finding(
            FLEET_KNOBS_WITHOUT_FLEET, path0,
            f"{', '.join(sorted(fleet_keys))} set but "
            f"{FLEET_REPLICAS_ANNOTATION} is absent — without a replica "
            "count there is no pool and the knobs have no effect",
        )]
    findings: list[Finding] = []
    if cfg.autoscale:
        health_on = any(
            k.startswith("seldon.io/health") or k == "seldon.io/slo-availability"
            for k in ann
        )
        profile_on = any(k.startswith("seldon.io/profile") for k in ann)
        if not health_on and not profile_on:
            findings.append(make_finding(
                FLEET_AUTOSCALE_BLIND, path0,
                f"{FLEET_AUTOSCALE_ANNOTATION} is on but neither the "
                "health plane (seldon.io/health / slo-availability) nor "
                "the profiling plane (seldon.io/profile) is — the "
                "autoscaler has no burn or demand signal and will only "
                "ever hold",
            ))
    detail = (
        f"fleet plane on: {cfg.replicas} replica(s), policy "
        f"{cfg.policy!r}, autoscale "
        f"{'on' if cfg.autoscale else 'off'}"
    )
    if cfg.autoscale:
        detail += (
            f" (bounds [{cfg.min_replicas}, {cfg.max_replicas}], "
            f"cooldown {cfg.cooldown_s:g}s)"
        )
    findings.append(make_finding(FLEET_CONFIG_REPORT, path0, detail))
    return findings


def _fleet_obs_pass(root: PredictiveUnit, ann: dict,
                    prefix: str) -> list[Finding]:
    """Fleet-observability admission (GL14xx, active when any
    ``seldon.io/fleet-obs-*`` annotation is set): validates the family
    through the same parser the gateway and operator use (GL1401), warns
    when obs knobs are set without ``seldon.io/fleet-replicas`` — a
    one-replica deployment has no fleet to observe, so the scraper and
    the skew analysis never run (GL1402) — and reports the effective
    config (GL1403)."""
    from seldon_core_tpu_torch.fleet import (
        FLEET_REPLICAS_ANNOTATION,
        fleet_config_from_annotations,
        observe_config_from_annotations,
    )

    obs_keys = [k for k in ann if k.startswith("seldon.io/fleet-obs-")]
    if not obs_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = observe_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(FLEET_OBS_ANNOTATION_INVALID, path0, str(e))]
    findings: list[Finding] = []
    try:
        fleet_cfg = fleet_config_from_annotations(ann, "lint")
        fleet_on = fleet_cfg.enabled
    except ValueError:
        fleet_on = False  # GL1301 already reports the broken fleet knob
    if not fleet_on:
        findings.append(make_finding(
            FLEET_OBS_WITHOUT_FLEET, path0,
            f"{', '.join(sorted(obs_keys))} set but "
            f"{FLEET_REPLICAS_ANNOTATION} is absent — with no replica "
            "set there is nothing to scrape or compare, the knobs have "
            "no effect",
        ))
    findings.append(make_finding(
        FLEET_OBS_CONFIG_REPORT, path0,
        f"fleet observability on: scrape cache {cfg.interval_ms:g}ms, "
        f"per-replica timeout {cfg.timeout_ms:g}ms, concurrency "
        f"{cfg.concurrency}, outlier threshold {cfg.mad_k:g} MADs, "
        f"decision ring {cfg.audit_capacity}",
    ))
    return findings


def _artifact_pass(root: PredictiveUnit, ann: dict,
                   prefix: str) -> list[Finding]:
    """Artifact-plane admission (GL15xx, active when any
    ``seldon.io/artifact-*`` annotation is set): validates the family
    through the same parser the operator uses (GL1501), warns when the
    artifact store is configured without ``seldon.io/graph-plan=fused``
    — only fused segments are AOT-compiled, so a walk-mode graph never
    produces or hydrates an executable and every boot stays cold
    (GL1502) — and reports the effective store/precompile/parity config
    (GL1503)."""
    from seldon_core_tpu_torch.artifacts import (
        ARTIFACTS_ANNOTATION,
        ARTIFACT_PREFIX,
        artifact_config_from_annotations,
    )

    art_keys = [k for k in ann
                if k == ARTIFACTS_ANNOTATION or k.startswith(ARTIFACT_PREFIX)]
    if not art_keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = artifact_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(ARTIFACT_ANNOTATION_INVALID, path0, str(e))]
    if cfg is None or not cfg.enabled:
        return []
    findings: list[Finding] = []
    mode = str(ann.get(PLAN_ANNOTATION, "walk")).strip().lower()
    if mode != "fused":
        findings.append(make_finding(
            ARTIFACTS_WITHOUT_PLAN, path0,
            f"{', '.join(sorted(art_keys))} set but "
            f"{PLAN_ANNOTATION} is not 'fused' — only fused segments "
            "are AOT-serialized, so no executable is ever published or "
            "hydrated and every boot compiles cold",
        ))
    findings.append(make_finding(
        ARTIFACT_CONFIG_REPORT, path0,
        f"artifact plane on: store {cfg.store!r}, precompile "
        f"{'on' if cfg.precompile else 'off'}, parity gate "
        f"{'on' if cfg.parity else 'off'}, publish "
        f"{'on' if cfg.publish else 'off'}",
    ))
    return findings


def _device_plane_pass(root: PredictiveUnit, ann: dict,
                       prefix: str) -> list[Finding]:
    """GL17xx: device-plane admission.  Validates the
    ``seldon.io/device-plane*`` family through the same parser the
    operator uses (GL1701), warns when sub-knobs are set while the
    master switch is off — the configured remote fast path silently
    never engages (GL1702) — and reports the effective enable/remote
    posture (GL1703)."""
    from seldon_core_tpu_torch.runtime.device_plane import (
        DEVICE_PLANE_ANNOTATION,
        DEVICE_PLANE_PREFIX,
        device_plane_config_from_annotations,
    )

    keys = [k for k in ann
            if k == DEVICE_PLANE_ANNOTATION
            or k.startswith(DEVICE_PLANE_PREFIX)]
    if not keys:
        return []
    path0 = _join(prefix, root.name)
    try:
        cfg = device_plane_config_from_annotations(ann, "lint")
    except ValueError as e:
        return [make_finding(DEVICE_PLANE_ANNOTATION_INVALID, path0, str(e))]
    if cfg is None or not cfg.enabled:
        knobs = sorted(k for k in keys if k != DEVICE_PLANE_ANNOTATION)
        if knobs:
            return [make_finding(
                DEVICE_PLANE_KNOBS_WITHOUT_PLANE, path0,
                f"{', '.join(knobs)} set but {DEVICE_PLANE_ANNOTATION} is "
                "off — remote edges stay on the byte wire and cache edges "
                "keep defensive host copies",
            )]
        return []
    return [make_finding(
        DEVICE_PLANE_CONFIG_REPORT, path0,
        f"device plane on: cache/chain edges hand out HBM handles, "
        f"meta-only routers skip D2H, remote fast path {cfg.remote!r} "
        "(loopback refs in-process, shm staging same-host, bytes across "
        "hosts)",
    )]


def _join(prefix: str, name: str) -> str:
    name = name or "?"
    return f"{prefix}/{name}" if prefix else name
