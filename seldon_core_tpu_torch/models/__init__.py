"""Models served by the port, and their static serving signatures (port of
the registry in ``seldon_core_tpu/models/__init__.py``).

Every model class the port ships registers a :class:`ModelSignature`
keyed by the ``module:Class`` string users write in a node's
``model_class`` parameter.  The graph-plan compiler (``graph/plan.py``)
reads the entry signature of a fused segment from here to warm every
batcher bucket at boot (``seldon.io/graph-plan-warmup``); the prediction
cache reads ``deterministic``; the admission lint (``analysis/``) reads
all of it.  Third-party components register their own with
:func:`register_signature`; an unregistered class simply has no static
contract.  The table imports nothing but the standard library.

The trace providers (:func:`register_trace_provider`) say how the GL16xx
trace-lint (``analysis/tracelint.py``) builds each class's serving
function and parameters on fake tensors; the model zoo's own live in
``models/traceable.py``, installed on first use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["ANY", "ModelSignature", "SIGNATURES", "BUILTIN_SIGNATURES",
           "register_signature", "signature_for", "TraceTarget",
           "TRACE_PROVIDERS", "register_trace_provider", "trace_target_for"]

#: wildcard dimension — matches any size (batch, sequence length, ...)
ANY = None

Shape = tuple  # of int | None


@dataclass(frozen=True)
class ModelSignature:
    """Static serving contract of one model class.

    ``None`` anywhere means "unknown/any": a ``None`` dim matches every
    size; a ``None`` shape or dtype disables the corresponding check.
    ``hbm_bytes`` is the resident-weights estimate (KV caches and
    activations are workload-dependent and deliberately excluded).

    ``pure_fn`` declares that the class serves through a pure tensor
    function (``predict_fn``) with no per-request host state — the static
    precondition the graph-plan compiler needs to fuse the node into a
    segment.

    ``deterministic`` declares that identical inputs always produce
    identical outputs — False for RNG routers, learning/stateful
    components, and anything with per-request-meta-dependent output.

    ``routes_on`` (routers only) declares what the ``route()`` decision
    reads: ``"tensor"`` (the values) or ``"meta"`` (meta and names only).
    A meta-only router is called without the tensor when the device plane
    is on, so no D2H is paid for it.

    ``batch_shardable`` declares that the serving function is row-wise
    over the leading batch dim (row *i* of the output depends only on row
    *i* of the input), the precondition for splitting a batch over a
    mesh's ``dp`` axis.  ``tp_param_specs`` optionally maps parameter keys
    to partition axis tuples (e.g. ``{"0/w": (None, "tp")}``) so large
    weight matrices shard over the ``tp`` axis.  The admission lint's
    placement, residency and trace passes read both, and the placement
    plane's sharded executor acts on them (``graph/plan.py``).
    """

    input_shape: Optional[Shape] = None
    input_dtype: Optional[str] = None
    output_shape: Optional[Shape] = None
    output_dtype: Optional[str] = None
    hbm_bytes: int = 0
    pure_fn: bool = False
    deterministic: bool = True
    batch_shardable: bool = True
    tp_param_specs: Optional[dict] = None
    routes_on: str = "tensor"


def _dense_bytes(sizes: tuple, dtype_bytes: int = 4) -> int:
    total = 0
    for m, n in zip(sizes[:-1], sizes[1:]):
        total += (m * n + n) * dtype_bytes
    return total


_PKG = "seldon_core_tpu_torch.models"

#: module:Class → signature, for every model class shipped in this package
SIGNATURES: dict[str, ModelSignature] = {
    f"{_PKG}.iris:IrisClassifier": ModelSignature(
        input_shape=(ANY, 4), input_dtype="float32",
        output_shape=(ANY, 3), output_dtype="float32",
        hbm_bytes=_dense_bytes((4, 3)),
        pure_fn=True,
    ),
    f"{_PKG}.mlp:MNISTMLP": ModelSignature(
        input_shape=(ANY, 784), input_dtype="float32",
        output_shape=(ANY, 10), output_dtype="float32",
        hbm_bytes=_dense_bytes((784, 512, 256, 10)),
        pure_fn=True,
        # column-parallel hidden layers (512 and 256 divide every power-
        # of-two tp); the final (256, 10) layer replicates
        tp_param_specs={
            "0/w": (None, "tp"), "0/b": ("tp",),
            "1/w": (None, "tp"), "1/b": ("tp",),
        },
    ),
    f"{_PKG}.mlp:MNISTMLPClassifier": ModelSignature(
        input_shape=(ANY, 784), input_dtype="float32",
        output_shape=(ANY,), output_dtype="int32",
        hbm_bytes=_dense_bytes((784, 512, 256, 10)),
        pure_fn=True,
        tp_param_specs={
            "0/w": (None, "tp"), "0/b": ("tp",),
            "1/w": (None, "tp"), "1/b": ("tp",),
        },
    ),
    f"{_PKG}.resnet:ResNet50Model": ModelSignature(
        input_shape=(ANY, 224, 224, 3), input_dtype="float32",
        output_shape=(ANY, 1000), output_dtype="float32",
        # ~25.6M params stored in the bf16 serving dtype (models/resnet.py)
        hbm_bytes=25_600_000 * 2,
        pure_fn=True,
    ),
    f"{_PKG}.resnet_int8:Int8ResNet50Model": ModelSignature(
        input_shape=(ANY, 224, 224, 3), input_dtype="float32",
        output_shape=(ANY, 1000), output_dtype="float32",
        hbm_bytes=25_600_000 * 1,
        pure_fn=True,
    ),
    # token-in/token-out through the continuous-batching engine, which
    # holds per-request state; generation metrics are time-derived
    f"{_PKG}.llm_demo:DemoLLM": ModelSignature(
        input_shape=(ANY, ANY), input_dtype="int32",
        output_shape=(ANY, ANY), output_dtype="int32",
        hbm_bytes=2 * 64 * (4 * 64 * 64 + 2 * 64 * 128) * 4,
        deterministic=False,
    ),
    # learning transformer: scores rows, passes data through unchanged —
    # the running moments (and its tags) change with every request
    f"{_PKG}.outlier:MahalanobisOutlier": ModelSignature(
        deterministic=False,
    ),
}

#: built-in implementations with a static contract; the router entries
#: exist for their ``deterministic`` flag
BUILTIN_SIGNATURES: dict[str, ModelSignature] = {
    # fixed [[1.0, 2.0, 3.0]] broadcast per row (graph/builtins.py)
    "SIMPLE_MODEL": ModelSignature(
        output_shape=(ANY, 3), output_dtype="float64",
    ),
    # always branch 0: deterministic, but routers are still cache
    # boundaries (control flow re-runs per request)
    "SIMPLE_ROUTER": ModelSignature(routes_on="meta"),
    "RANDOM_ABTEST": ModelSignature(deterministic=False, routes_on="meta"),
    "EPSILON_GREEDY": ModelSignature(deterministic=False, routes_on="meta"),
    # element-wise mean over children, on the children's device
    "AVERAGE_COMBINER": ModelSignature(pure_fn=True),
}


def register_signature(model_class: str, sig: ModelSignature) -> None:
    """Register (or override) the static signature for a ``module:Class``."""
    SIGNATURES[model_class] = sig


def signature_for(model_class: str) -> Optional[ModelSignature]:
    return SIGNATURES.get(model_class)


# ---------------------------------------------------------------------------
# trace providers — how the GL16xx trace-lint verifies a signature
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceTarget:
    """The (fn, params) pair the trace-lint runs on fake tensors.

    ``fn(params, X)`` is the node's serving function *unbound* from any
    instance.  A provider is called inside the trace-lint's
    ``FakeTensorMode``, so the parameters it builds (with the same init
    code the real constructor runs) are fake tensors: shapes and dtypes,
    no storage, no weights."""

    fn: object
    params: object


#: module:Class → zero-arg callable returning a :class:`TraceTarget`.
#: Registering a provider must not import torch; only calling it may.
#: Classes without one (the LLM engine, shapeless numpy components) are
#: not statically traceable and the GL16xx pass skips them.
TRACE_PROVIDERS: dict = {}

_BUILTIN_PROVIDERS_LOADED = False


def register_trace_provider(model_class: str, provider) -> None:
    """Register (or override) the trace provider for a ``module:Class``."""
    TRACE_PROVIDERS[model_class] = provider


def trace_target_for(model_class: str) -> Optional[TraceTarget]:
    """Resolve and call the trace provider for ``model_class``, installing
    the model zoo's providers (``models/traceable.py``) on first use."""
    global _BUILTIN_PROVIDERS_LOADED
    if model_class not in TRACE_PROVIDERS and not _BUILTIN_PROVIDERS_LOADED:
        _BUILTIN_PROVIDERS_LOADED = True
        from seldon_core_tpu_torch.models import traceable
        traceable.install()
    provider = TRACE_PROVIDERS.get(model_class)
    return provider() if provider is not None else None
