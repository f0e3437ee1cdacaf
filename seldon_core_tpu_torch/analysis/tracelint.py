"""GL16xx — trace-lint: verify the signature registry against reality
(port of ``seldon_core_tpu/analysis/tracelint.py``).

The GL2xx shape/dtype pass and every downstream consumer (cache keys,
graph-plan fusion, HBM estimates, tp sharding) trust the *hand-declared*
:class:`~seldon_core_tpu_torch.models.ModelSignature` registry.  Nothing
else checks it — a drifted entry silently corrupts every edge check built
on it.  This pass closes the loop: each registered callable that has a
trace provider (``models/traceable.py``; third parties use
``register_trace_provider``) is traced **abstractly** on fake tensors —
``torch._subclasses.fake_tensor.FakeTensorMode``, under a
``TorchDispatchMode`` that records every aten op — on the CPU path, so
every kernel wrapper takes its plain version (K1's ctypes launch cannot
take a fake tensor).  No weights are allocated, nothing executes, no
device is touched.  The declaration is checked against the trace:

- **GL1601 ERROR** — declared output shape/dtype disagrees with the
  traced output (or the declared input contract fails to trace at all).
- **GL1602 WARN** — a float64 op output inside the traced function:
  float64 doubles memory and falls off the tensor cores.  The
  reference's weak-type half has no counterpart: torch has no weak
  types.
- **GL1603 ERROR** — a host sync inside a node declared ``pure_fn``:
  ``aten._local_scalar_dense`` (``.item()``, ``.tolist()``, ``float()``
  of a tensor) as the dispatch mode sees it, and what the CPU path hides
  from it — copies to the CPU (``.cpu()``, ``.to("cpu")``, ``.numpy()``)
  and a tensor's ``print`` — seen at the Python surface.  A sync breaks
  fusion (a CUDA graph cannot capture it), caching and artifact export,
  all of which key on ``pure_fn``.  The sync is recorded and the trace
  goes on with a zero in place of the value.
- **GL1604 ERROR** — a ``dp``/``tp`` axis in ``seldon.io/mesh`` that
  does not evenly divide the dimension it would shard: ``dp`` against a
  fixed declared batch dim, ``tp`` against the traced parameter dims
  named by ``tp_param_specs``.
- **GL1207 ERROR** — the *effective* tp layout (declared
  ``tp_param_specs`` merged over ``placement/layouts.py``'s rule table)
  names a traced param dim ``tp`` does not divide.

Dtypes in messages carry the reference's names (``float32``,
``bfloat16``), not ``torch.float32``.  Activation: the graph pass runs
only when torch and the port's trace providers are already loaded
(``--self`` and ``--trace`` CLI runs load both), so a spec-only lint
never pays the traces.  Traces are cached per (model_class, input
binding) so a process traces each model once.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

from seldon_core_tpu_torch.analysis.findings import (
    PLACEMENT_TP_INDIVISIBLE,
    TRACE_CALLBACK_IN_PURE_FN,
    TRACE_IMPLICIT_PROMOTION,
    TRACE_MESH_INDIVISIBLE,
    TRACE_SIGNATURE_DRIFT,
    Finding,
    make_finding,
)
from seldon_core_tpu_torch.models import (
    ModelSignature,
    SIGNATURES,
    signature_for,
    trace_target_for,
)

#: ANY dims bind to these probe sizes (batch dim vs inner dims) — any
#: fixed value works; the trace only needs concrete ints.
PROBE_BATCH = 8
PROBE_DIM = 16

#: tensor methods that copy to the host or read a value there, which a
#: fake CPU tensor answers without an aten op
_HOST_METHODS = frozenset({"cpu", "numpy", "__repr__", "__str__",
                           "__format__"})


class _Trace:
    """What one abstract trace of ``fn(params, X)`` yielded."""

    def __init__(self) -> None:
        self.error: Optional[str] = None
        self.out_shapes: list = []      # [(shape, dtype-str, weak)] per leaf
        self.f64_eqns: list = []        # aten ops producing float64
        self.callback_prims: list = []  # host syncs seen
        self.param_dims: dict = {}      # "path/leaf" -> shape tuple


#: (model_class, bound input shape, input dtype) → _Trace
_TRACE_CACHE: dict = {}


def _bind_input_shape(sig: ModelSignature) -> tuple:
    shape = sig.input_shape if sig.input_shape is not None \
        else (None, None)
    return tuple(
        (PROBE_BATCH if i == 0 else PROBE_DIM) if d is None else d
        for i, d in enumerate(shape)
    )


def dtype_name(dtype: Any) -> str:
    """``torch.float32`` → ``float32``, the reference's spelling."""
    return str(dtype).replace("torch.", "")


def _tensors(tree: Any, prefix: str = ""):
    """``(path_key, tensor)`` over a params or output tree: dicts, lists,
    tuples (named ones too) and ``nn.Module`` parameters and buffers, path
    keys ``/``-joined (``"0/w"``, ``"blocks/0/c1/q/values"``), as the
    reference's ``_keystr`` joins a jax pytree path."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield (prefix[:-1] if prefix else ""), tree
    elif isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield prefix + name.replace(".", "/"), t
    elif isinstance(tree, dict):
        for k in tree:
            yield from _tensors(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _tensors(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}{i}/")


def _zero_like_scalar(t: Any):
    import torch

    if t.dtype == torch.bool:
        return False
    return 0.0 if t.dtype.is_floating_point or t.dtype.is_complex else 0


class _KernelMask:
    """The trace's observer of kernel calls (``ops/cost.py``
    :func:`observing`): on the CPU path a hand-written kernel's wrapper
    runs its plain version, whose ops are not what the card runs (K1's
    plain product is float64, exact where the kernel accumulates in
    int32), so the recorders skip them."""

    def __init__(self) -> None:
        self.depth = 0

    @contextlib.contextmanager
    def kernel(self, flops: float, bytes_accessed: float):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1


def _recorders(trace: _Trace, mask: _KernelMask):
    """The dispatch mode recording every aten op (float64 outputs, scalar
    reads) and the function mode catching the host copies a CPU fake
    tensor answers without one; neither records inside a kernel call."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    scalar_read = torch.ops.aten._local_scalar_dense.default

    class OpRecorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if func is scalar_read and not mask.depth:
                trace.callback_prims.append(name)
                return _zero_like_scalar(args[0])
            out = func(*args, **(kwargs or {}))
            if not mask.depth:
                for _, t in _tensors(out):
                    if t.dtype == torch.float64:
                        trace.f64_eqns.append(name)
            return out

    class HostRecorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            to_cpu = name == "to" and any(
                str(a) == "cpu" for a in (*args[1:], kwargs.get("device")))
            if (name in _HOST_METHODS or to_cpu) and not mask.depth:
                trace.callback_prims.append(f"Tensor.{name}")
                if name == "numpy":  # a fake tensor has no storage
                    t = args[0]
                    try:
                        dt = np.dtype(dtype_name(t.dtype))
                    except TypeError:  # bfloat16 has no numpy dtype
                        dt = np.float32
                    return np.zeros(tuple(t.shape), dtype=dt)
            return func(*args, **kwargs)

    return OpRecorder(), HostRecorder()


def _trace_model(model_class: str, sig: ModelSignature) -> Optional[_Trace]:
    """Trace one registry entry; None when it has no provider."""
    in_shape = _bind_input_shape(sig)
    in_dtype = sig.input_dtype or "float32"
    key = (model_class, in_shape, in_dtype)
    if key in _TRACE_CACHE:
        return _TRACE_CACHE[key]

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from seldon_core_tpu_torch.ops import cost

    trace = _Trace()
    with FakeTensorMode(allow_non_fake_inputs=True):
        target = trace_target_for(model_class)
        if target is None:
            return None
        try:
            for pkey, leaf in _tensors(target.params):
                trace.param_dims[pkey] = tuple(leaf.shape)
            x = torch.empty(in_shape, dtype=getattr(torch, in_dtype))
            mask = _KernelMask()
            ops, host = _recorders(trace, mask)
            # not under inference_mode: it hides the scalar reads from
            # the dispatch mode
            with cost.observing(mask), host, ops:
                out = target.fn(target.params, x)
            for _, leaf in _tensors(out):
                trace.out_shapes.append((
                    tuple(leaf.shape), dtype_name(leaf.dtype), False))
        except Exception as e:  # trace failure IS the finding (GL1601)
            trace.error = f"{type(e).__name__}: {e}"
    _TRACE_CACHE[key] = trace
    return trace


def _fmt(shape: Optional[tuple], dtype: Optional[str]) -> str:
    dims = "?" if shape is None else \
        "[" + ", ".join("?" if d is None else str(d) for d in shape) + "]"
    return f"{dtype or '?'}{dims}"


def lint_signature(model_class: str, sig: Optional[ModelSignature] = None,
                   path: Optional[str] = None) -> list[Finding]:
    """GL1601/GL1602/GL1603 for one registry entry (empty when the class
    has no trace provider — not statically traceable is not a defect)."""
    sig = sig if sig is not None else signature_for(model_class)
    if sig is None:
        return []
    at = path or model_class
    trace = _trace_model(model_class, sig)
    if trace is None:
        return []
    if trace.error is not None:
        return [make_finding(
            TRACE_SIGNATURE_DRIFT, at,
            f"{model_class}: declared input "
            f"{_fmt(sig.input_shape, sig.input_dtype)} does not trace: "
            f"{trace.error}",
        )]

    findings: list[Finding] = []

    if sig.output_shape is not None or sig.output_dtype is not None:
        if len(trace.out_shapes) != 1:
            findings.append(make_finding(
                TRACE_SIGNATURE_DRIFT, at,
                f"{model_class}: declares one output "
                f"{_fmt(sig.output_shape, sig.output_dtype)} but traces "
                f"to {len(trace.out_shapes)} output leaves",
            ))
        else:
            shape, dtype, _weak = trace.out_shapes[0]
            declared = sig.output_shape
            shape_ok = declared is None or (
                len(declared) == len(shape)
                and all(d is None or d == s
                        for d, s in zip(declared, shape)))
            dtype_ok = sig.output_dtype is None or sig.output_dtype == dtype
            if not (shape_ok and dtype_ok):
                findings.append(make_finding(
                    TRACE_SIGNATURE_DRIFT, at,
                    f"{model_class}: declared output "
                    f"{_fmt(sig.output_shape, sig.output_dtype)} but "
                    f"tracing {_fmt(_bind_input_shape(sig), sig.input_dtype)}"
                    f" yields {_fmt(shape, dtype)} — the registry has "
                    "drifted from the callable",
                ))

    if trace.f64_eqns:
        findings.append(make_finding(
            TRACE_IMPLICIT_PROMOTION, at,
            f"{model_class}: float64 intermediates from "
            f"{sorted(set(trace.f64_eqns))} — float64 doubles memory and "
            "runs off the tensor cores; pin dtypes explicitly",
        ))

    if sig.pure_fn and trace.callback_prims:
        findings.append(make_finding(
            TRACE_CALLBACK_IN_PURE_FN, at,
            f"{model_class}: declared pure_fn but the trace contains "
            f"host sync(s) {sorted(set(trace.callback_prims))} — a host "
            "sync breaks fusion (a CUDA graph cannot capture it), the "
            "prediction cache, and artifact export, which all key on "
            "pure_fn",
        ))
    return findings


def lint_registry(model_classes=None) -> list[Finding]:
    """Trace-verify every registry entry (the ``--self`` / CI gate)."""
    findings: list[Finding] = []
    for mc in sorted(model_classes or SIGNATURES):
        findings.extend(lint_signature(mc))
    return findings


def _mesh_findings(model_class: str, sig: ModelSignature, cfg: Any,
                   at: str) -> list[Finding]:
    """GL1604 for one node against the parsed placement config."""
    findings: list[Finding] = []
    if cfg.dp > 1 and sig.batch_shardable and sig.input_shape:
        batch = sig.input_shape[0]
        if batch is not None and batch % cfg.dp:
            findings.append(make_finding(
                TRACE_MESH_INDIVISIBLE, at,
                f"{model_class}: mesh axis dp={cfg.dp} does not divide "
                f"the declared batch dim {batch} — the sharded dispatch "
                "cannot split this batch evenly",
            ))
    if cfg.tp > 1:
        trace = _trace_model(model_class, sig)
        param_dims = trace.param_dims if trace and not trace.error else {}
        flagged: set = set()
        for key, spec in sorted((sig.tp_param_specs or {}).items()):
            dims = None
            matched = None
            for pkey, shape in param_dims.items():
                if pkey == key or pkey.endswith("/" + key) or key in pkey:
                    dims, matched = shape, pkey
                    break
            if dims is None:
                continue  # provider absent or key unmatched — nothing to check
            for axis, axis_name in enumerate(spec):
                if axis_name != "tp" or axis >= len(dims):
                    continue
                if dims[axis] % cfg.tp:
                    flagged.add(matched)
                    findings.append(make_finding(
                        TRACE_MESH_INDIVISIBLE, at,
                        f"{model_class}: tp_param_specs shards param "
                        f"{key!r} dim {axis} (= {dims[axis]}) over "
                        f"tp={cfg.tp}, which does not divide it — "
                        "uneven shards replicate instead of splitting",
                    ))
        # GL1207: the EFFECTIVE layout (declared specs merged over the
        # SpecLayout rule table) against the traced param shapes — a rule
        # the operator never wrote can still name an indivisible dim
        # (e.g. a qkv head dim at an odd head count), and silently
        # replicating a matrix the planner budgeted as sharded turns the
        # feasible tp-span plan back into an HBM overflow at load time.
        from seldon_core_tpu_torch.placement import layouts

        for pkey, axis, dim in layouts.check_divisibility(
                param_dims, cfg.tp, declared=sig.tp_param_specs):
            if pkey in flagged:
                continue  # declared-spec violation already reported above
            findings.append(make_finding(
                PLACEMENT_TP_INDIVISIBLE, at,
                f"{model_class}: the tp layout shards param {pkey!r} "
                f"dim {axis} (= {dim}) over tp={cfg.tp}, which does not "
                "divide it — the runtime would replicate this param, "
                "breaking the tp-span HBM plan; pick a divisible tp or "
                "declare a replicated spec for it",
            ))
    return findings


def lint_unit_traces(root: Any, ann: dict, prefix: str) -> list[Finding]:
    """The graphlint pass entry: trace-verify every model node of one
    predictor graph, plus GL1604 mesh divisibility when ``seldon.io/mesh``
    is set.  Caller guarantees torch is already imported."""
    from seldon_core_tpu_torch.placement.config import (
        MESH_ANNOTATION,
        placement_config_from_annotations,
    )

    cfg = None
    if ann.get(MESH_ANNOTATION) is not None:
        try:
            cfg = placement_config_from_annotations(ann)
        except ValueError:
            cfg = None  # GL1201 (placement pass) already reported it

    findings: list[Finding] = []

    def visit(u: Any, path: str) -> None:
        model_class = u.parameters.get("model_class")
        if isinstance(model_class, str) and model_class:
            sig = signature_for(model_class)
            if sig is not None:
                findings.extend(lint_signature(model_class, sig, path=path))
                if cfg is not None and cfg.enabled:
                    findings.extend(
                        _mesh_findings(model_class, sig, cfg, path))
        for c in u.children:
            visit(c, f"{path}/{c.name}")

    visit(root, f"{prefix}/{root.name}" if prefix else root.name)
    return findings
