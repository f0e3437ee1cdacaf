"""Graph plan compiler: fuse static subgraphs into segments, each replayed
as one CUDA graph per shape bucket (port of ``seldon_core_tpu/graph/plan.py``).

The interpreted walk (``graph/engine.py``) pays an asyncio step, a timer
pair and a meta merge per node per request, and one launch per kernel of
every node.  A predictor whose graph is a static chain or ensemble of
in-process tensor functions can skip all of that: this module partitions
the built engine graph into maximal **fusible segments**, and each
:class:`FusedSegment` serves a request with one call:

- fusible node types: MODEL / TRANSFORMER / OUTPUT_TRANSFORMER / COMBINER
  (a ROUTER's branch choice is data-dependent control flow, always an
  interpreter boundary);
- a node is fusible when its in-process implementation exposes a *pure
  tensor function* for its role: ``predict_fn`` (MODEL),
  ``transform_input_fn`` (TRANSFORMER), ``transform_output_fn``
  (OUTPUT_TRANSFORMER), ``aggregate_fn`` or the built-in
  ``AVERAGE_COMBINER`` (COMBINER).  Remote clients, message-level
  components (``accepts_messages``, the LLM) and learning components (no
  pure function: the outlier detector) stay interpreter boundaries;
- a maximal fully-fusible subtree becomes one segment; a fusible
  MODEL/TRANSFORMER chain above a non-fusible child becomes a *chain
  segment* feeding the interpreted remainder.

**How a segment runs.**  On the card (outside ``programs.eager()``), each
shape bucket (the input's rows, trailing shape and dtype,
:meth:`FusedSegment.bucket_key`) is captured once
as a ``torch.cuda.CUDAGraph`` of the stages' own eager kernels, in the
walk's order, and replayed for every later batch of that shape: the input
is converted on the host exactly as the walk converts it (float64 to
float32, int64 to int32), copied into the bucket's static input buffer
outside the graph, the graph replays on the caller's current stream, and
the output is cloned on that stream before it is handed back, so the next
replay cannot overwrite a batch whose host copy is still pending.  Every
bucket of a segment allocates from one memory pool
(``torch.cuda.graph_pool_handle()``).  The capture steps are
``runtime/programs.py`` :func:`capture`, which the LLM engines' programs
share.  Capture runs on the calling thread
(the one that runs the batcher's forwards) with
``capture_error_mode="thread_local"``, so CUDA work of other threads (an
LLM engine's worker, a host copy) cannot void it, on a stream of the
segment's own after one eager run of the stages there: that run warms
every kernel up and is the walk's answer at this shape, and the first
replay must equal it bit for bit, or the capture raises, naming the
segment and the bucket.  ``torch.compile`` is not used: a replay runs the
walk's kernels in the walk's order, so walk and fused answers are
byte-identical by construction (cuDNN keeps its heuristic choice of
algorithm: ``torch.backends.cudnn.benchmark`` stays off).  Kernel launch
counters (``ops/launches.py``) are recorded at capture and added on every
replay.  On the CPU a segment runs its stages eagerly, one call per
request: the counterpart of one dispatch, counted in ``n_calls``.

Wire compatibility: a segment carries a precomputed **meta script** — the
exact sequence of ``requestPath`` stamps and component tags/metrics merges
the interpreted walk would perform, replayed host-side per request — so
responses (data, ``meta.requestPath``, tags, custom metrics) are
byte-identical between ``walk`` and ``fused`` modes.  Only node-timer
granularity changes: one ``observe_node`` per segment instead of per node.

Segments also plug into the dynamic batcher (``runtime/batcher.py``) as a
single batched callable, so cross-request batching amortizes the whole
segment, not just one model, per replay.

The artifact plane (``artifacts/plane.py``) attaches to the plan: a
bucket first seen on the request path is captured from the store's record
when one matches (probe-checked), else live and published back; the
engine captures every stored bucket at boot, and :meth:`GraphPlan.warmup`
skips buckets already captured.  :meth:`GraphPlan.residency_map` gives
the planned residency tier of every edge from the device plane's tier
model (``runtime/device_plane.py``).

**Cost and the capture ledger.**  XLA's ``cost_analysis()`` has no
counterpart here, so a bucket's cost is counted once, when it is first
run: the capture's eager run on the card (the first eager run of a
bucket on the CPU) goes through ``ops/cost.py`` :class:`CostCount`, whose
FLOPs come from ``FlopCounterMode`` over the aten products and
convolutions, plus each hand-written kernel's own ``pl.CostEstimate``
formula, and whose bytes are each op's inputs and outputs.  The graph
pool's bytes after the capture stand for the reference's peak memory.
``cost_by_bucket`` holds ``flops``, ``bytes_accessed`` and
``peak_hbm_bytes`` per bucket, keyed as the reference keys it
(``((rows, ...), "float32")``), and :meth:`FusedSegment.cost_for_rows`
scales it to a request's rows.  A ``compile_watch``
(``profiling/compilewatch.py``, set by the engine) gets one ledger row per
bucket: ``source="live"`` with the capture's wall time (on the CPU, the
counted first run's), ``"aot-cache"`` for a bucket captured at boot from
the artifact store.

Not ported here: the sharded executor (ROADMAP.md, slice 6).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.ops.cost import CostCount
from seldon_core_tpu_torch.runtime import programs

__all__ = ["FUSIBLE_TYPES", "PURE_FN_ATTR", "extract_stage",
           "boundary_reason", "MetaEvent", "FusedSegment", "PlanNode",
           "GraphPlan", "compile_plan"]

logger = logging.getLogger(__name__)

#: node types a fused segment may contain (ROUTER never fuses: its branch
#: choice is data-dependent control flow)
FUSIBLE_TYPES = ("MODEL", "TRANSFORMER", "OUTPUT_TRANSFORMER", "COMBINER")

#: unit type → the pure-tensor-fn attribute that makes it fusible
PURE_FN_ATTR = {
    "MODEL": "predict_fn",
    "TRANSFORMER": "transform_input_fn",
    "OUTPUT_TRANSFORMER": "transform_output_fn",
    "COMBINER": "aggregate_fn",
}

#: names that are the segment's input names, whatever they are
_IN = object()


# ---------------------------------------------------------------------------
# stage extraction
# ---------------------------------------------------------------------------


@dataclass
class _Stage:
    """One graph node's contribution to a fused segment."""

    name: str
    kind: str                       # resolved unit type
    label: str                      # requestPath value (walk-identical)
    fn: Callable                    # pure: (params, x) -> y  /  (params, ys) -> y
    params: Any                     # may be None
    handle: Any                     # ComponentHandle (meta/tags/names source)
    class_names: Optional[list] = None
    feature_names: Optional[list] = None
    # prediction-cache narrowing (caching/policy.py): node opted out via
    # the `cacheable: false` parameter, or component declared
    # `deterministic = False` — either poisons segment-level caching
    cache_opt_out: bool = False

    def out_names(self, y_shape: tuple, in_names: Any) -> Any:
        """Replicate ComponentHandle name resolution for this stage's
        output; ``in_names`` may be the marker of the segment's input
        names, which then passes through."""
        if self.kind == "TRANSFORMER":
            return (list(self.feature_names)
                    if self.feature_names is not None else in_names)
        if self.kind == "OUTPUT_TRANSFORMER":
            return (list(self.class_names)
                    if self.class_names is not None else in_names)
        # MODEL / COMBINER: _class_names(Y, fallback)
        if self.class_names is not None:
            return list(self.class_names)
        if len(y_shape) >= 2:
            return [f"t:{i}" for i in range(y_shape[-1])]
        return in_names


def _unwrap_handle(impl: Any) -> Any:
    """BatchedModel (walk-mode per-node batching) → underlying handle."""
    return getattr(impl, "handle", impl)


def _positional_arity(fn: Callable) -> int:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 1
    return len([
        p for p in sig.parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ])


def extract_stage(node: Any) -> Optional[_Stage]:
    """The node's pure tensor function, or None (interpreter boundary).

    ``node`` is a ``graph.engine._Node``.  Only in-process
    ``ComponentHandle`` implementations qualify — remote clients and
    message-level passthrough components interpret.  A stage moves its
    input to its component's device as the handle does, then calls the
    component's own function.
    """
    from seldon_core_tpu_torch.graph.builtins import (
        AverageCombiner,
        tensor_mean,
    )
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    kind = node.type
    if kind not in FUSIBLE_TYPES:
        return None
    handle = _unwrap_handle(node.impl)
    if not isinstance(handle, ComponentHandle):
        return None
    user = handle.user
    if getattr(user, "accepts_messages", False):
        return None  # message-level component owns its own semantics
    label = node.unit.implementation or type(user).__name__

    def stage(fn, params):
        return _Stage(
            name=node.unit.name, kind=kind, label=label, fn=fn,
            params=params, handle=handle,
            class_names=(list(user.class_names)
                         if getattr(user, "class_names", None) is not None
                         else None),
            feature_names=(list(user.feature_names)
                           if getattr(user, "feature_names", None) is not None
                           else None),
            cache_opt_out=(
                node.unit.parameters.get("cacheable") is False
                or getattr(user, "deterministic", True) is False
            ),
        )

    if kind == "COMBINER":
        agg = getattr(user, "aggregate_fn", None)
        if callable(agg):
            if _positional_arity(agg) >= 2:
                if not hasattr(user, "params"):
                    return None
                return stage(lambda p, ys, _f=agg: _f(p, ys), user.params)
            return stage(lambda p, ys, _f=agg: _f(ys), None)
        if isinstance(user, AverageCombiner):
            # the walk's combiner runs the same function on tensors
            return stage(lambda p, ys: tensor_mean(ys), None)
        return None

    pure = getattr(user, PURE_FN_ATTR[kind], None)
    if callable(pure):
        to_dev = handle._to_device
        if _positional_arity(pure) >= 2:
            if not hasattr(user, "params"):
                return None
            return stage(lambda p, x, _f=pure: _f(p, to_dev(x)), user.params)
        return stage(lambda p, x, _f=pure: _f(to_dev(x)), None)
    if kind == "MODEL" and getattr(user, "jit_compile", False) and callable(
            getattr(user, "predict", None)):
        # the reference's opt-in for a plain predict() that traces
        return stage(lambda p, x, _u=user: _u.predict(x, []), None)
    return None


def boundary_reason(node: Any) -> str:
    """Human-readable reason a node did not fuse (the plan report)."""
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    if node.type == "ROUTER":
        return "ROUTER: data-dependent branch choice cannot be traced"
    if node.type not in FUSIBLE_TYPES:
        return f"type {node.type} is not fusible"
    handle = _unwrap_handle(node.impl)
    if not isinstance(handle, ComponentHandle):
        return (f"{type(node.impl).__name__} is not an in-process "
                "component (remote client or duck-typed impl)")
    if getattr(handle.user, "accepts_messages", False):
        return "message-level passthrough component (owns its own semantics)"
    attr = PURE_FN_ATTR[node.type]
    return (f"{type(handle.user).__name__} exposes no pure tensor function "
            f"({attr} / built-in equivalent)")


# ---------------------------------------------------------------------------
# segment trees + execution
# ---------------------------------------------------------------------------


@dataclass
class _SegTree:
    stage: _Stage
    children: list["_SegTree"] = field(default_factory=list)


@dataclass
class MetaEvent:
    """One host-side meta action, replayed per request in walk order."""

    op: str          # "stamp" | "merge"
    name: str        # node name
    label: str = ""  # requestPath value (stamp)
    handle: Any = None  # ComponentHandle (merge: tags/metrics source)


class FusedSegment:
    """One fused run of graph nodes, called once per request (or batch).

    ``__call__(X)`` replays the bucket's CUDA graph on the card (capturing
    it the first time the bucket is seen) and runs the stages eagerly on
    the CPU.  The segment optionally owns a
    :class:`~seldon_core_tpu_torch.runtime.batcher.DynamicBatcher`
    (``batcher``) so concurrent requests share one call end-to-end.
    ``n_calls`` counts calls, ``n_replays`` replays after capture,
    ``capture_s`` the seconds each bucket's capture took.
    """

    def __init__(self, tree: _SegTree, root_node: Any):
        self.tree = tree
        self.root_node = root_node  # engine _Node (interpreted fallback)
        self.members: list[_Stage] = []
        self.meta_events: list[MetaEvent] = []
        self._collect(tree)
        self.name = self.members[0].name
        self.label = "+".join(s.name for s in self.members)
        self._params = {s.name: s.params for s in self.members}
        # the stage that first converts the request (a COMBINER or an
        # OUTPUT_TRANSFORMER root hands its input on as it is)
        entry = tree
        while (entry.stage.kind in ("COMBINER", "OUTPUT_TRANSFORMER")
               and entry.children):
            entry = entry.children[0]
        self._entry = entry.stage.handle
        self.batcher = None  # set by compile_plan when batching is on
        self.n_calls = 0     # calls: replays, captures or eager runs
        self.n_replays = 0   # replays of a captured bucket
        self._buckets: dict = {}
        self._pool = None
        self._capture_lock = threading.Lock()
        self.capture_s: dict = {}
        self._names: dict = {}
        # the artifact plane (artifacts/plane.py attach_plan): bucket
        # provenance, captured at boot from the store or live
        self.artifacts = None
        self.hydrated: set = set()
        self.live_compiled: set = set()
        # per bucket (the reference's keys: shape, wire dtype name): its
        # counted cost and provenance; ``compile_watch`` (a CompileWatch,
        # set by the engine) gets one ledger row per bucket
        self.cost_by_bucket: dict = {}
        self.compile_watch = None
        self._counted: dict = {}
        # prediction-cache eligibility: every member is a pure tensor fn by
        # construction, so the segment caches unless a member opted out or
        # declared itself non-deterministic (graph/engine.py consults this)
        self.cacheable = not any(s.cache_opt_out for s in self.members)

    # -- compile-time ----------------------------------------------------
    def _collect(self, t: _SegTree) -> None:
        """Pre-order member list + the walk-order meta script: per node
        [stamp, downward merge, children..., upward merge] — exactly the
        event order ``GraphEngine._walk_traced`` produces."""
        st = t.stage
        self.members.append(st)
        self.meta_events.append(MetaEvent("stamp", st.name, label=st.label))
        downward = st.kind in ("MODEL", "TRANSFORMER") or (
            st.kind == "OUTPUT_TRANSFORMER" and not t.children)
        if downward:
            self.meta_events.append(
                MetaEvent("merge", st.name, handle=st.handle))
        for c in t.children:
            self._collect(c)
        if st.kind == "COMBINER" or (
                st.kind == "OUTPUT_TRANSFORMER" and t.children):
            self.meta_events.append(
                MetaEvent("merge", st.name, handle=st.handle))

    def _run_tree(self, t: _SegTree, x, names):
        """The stages in walk order, eagerly: ``(y, names)``, the names
        as the walk would resolve them from input names ``names``."""
        st = t.stage
        p = self._params[st.name]
        down, down_names = x, names
        if st.kind in ("MODEL", "TRANSFORMER"):
            down = st.fn(p, x)
            down_names = st.out_names(tuple(down.shape), names)
        elif st.kind == "OUTPUT_TRANSFORMER" and not t.children:
            y = st.fn(p, x)
            return y, st.out_names(tuple(y.shape), names)
        if not t.children:
            return down, down_names
        # OUTPUT_TRANSFORMER/COMBINER descend as-is (walk order step 1)
        outs = [self._run_tree(c, down, down_names) for c in t.children]
        if st.kind == "COMBINER":
            y = st.fn(p, [o[0] for o in outs])
            return y, st.out_names(tuple(y.shape), outs[0][1])
        merged, merged_names = outs[0]  # default aggregation: first child
        if st.kind == "OUTPUT_TRANSFORMER":
            y = st.fn(p, merged)
            return y, st.out_names(tuple(y.shape), merged_names)
        return merged, merged_names

    # -- request-time ----------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The device the segment's entry stage runs on."""
        return torch.device(getattr(self._entry, "device", "cpu"))

    def __call__(self, x):
        self.n_calls += 1
        xt = self._entry._to_device(x)  # the walk's host conversion
        if isinstance(xt, torch.Tensor) and programs.graphs_on(xt.device):
            return self._replay(xt)
        key = self.bucket_key(xt)
        if self.bucket_wire(key) in self.cost_by_bucket:
            with torch.inference_mode():
                y, names = self._run_tree(self.tree, xt, _IN)
        else:
            # a bucket's first eager run counts its cost (module docstring)
            t0 = time.perf_counter()
            with torch.inference_mode(), CostCount() as count:
                y, names = self._run_tree(self.tree, xt, _IN)
            wall_ms = (time.perf_counter() - t0) * 1e3
            self.cost_by_bucket[self.bucket_wire(key)] = {
                **count.summary(), "peak_hbm_bytes": float(self.pool_bytes()),
                "compile_ms": round(wall_ms, 3), "source": "live"}
            self.note_ledger(key, wall_ms, "live")
        self._names.setdefault(self._names_key(x), names)
        return y

    def _batched(self, batch):
        """The batcher's callable: ``(rows, aux)``."""
        return self(batch), None

    @staticmethod
    def bucket_key(x) -> tuple:
        """Shape bucket of one converted input: (shape, dtype), rows
        included — one bucket = one captured graph."""
        return (tuple(getattr(x, "shape", ())),
                str(getattr(x, "dtype", "")))

    @staticmethod
    def bucket_for(shape, dtype: str) -> tuple:
        """The bucket key of a shape and a wire dtype name."""
        return (tuple(int(d) for d in shape),
                str(getattr(torch, str(dtype))))

    @staticmethod
    def bucket_wire(bucket: tuple) -> tuple:
        """``(shape, wire dtype name)`` of a bucket key."""
        return bucket[0], bucket[1].replace("torch.", "")

    def _replay(self, xt: torch.Tensor) -> torch.Tensor:
        key = self.bucket_key(xt)
        b = self._buckets.get(key)
        if b is None:
            b, fresh = self._capture(key, xt)
            if fresh:  # the capture's outputs are this input's answer
                return b.outputs.clone()
        b.inputs[0].copy_(xt)
        y = b.replay()
        self.n_replays += 1
        # the next replay overwrites the static output: hand out a copy
        # made on this stream, in order before that replay
        return y.clone()

    def _capture(self, key: tuple, xt: torch.Tensor) -> tuple:
        """``(captured, fresh)`` for bucket ``key`` seen at ``xt``: from the
        artifact store's record when one matches, else a live capture
        (published back); ``fresh`` when its static outputs hold ``xt``'s
        answer."""
        art = self.artifacts
        with self._capture_lock:
            hit = self._buckets.get(key)
            if hit is not None:
                return hit, False
            if art is not None:
                b = art.load_bucket(self, key)
                if b is not None:
                    return b, False
            b = self._capture_bucket(key, xt)
            self.live_compiled.add(key)
            self.cost_by_bucket[self.bucket_wire(key)] = {
                **self.bucket_cost(key), "source": "live",
                "capture_s": self.capture_s[key],
                "compile_ms": round(self.capture_s[key] * 1e3, 3)}
        self.note_ledger(key, self.capture_s[key] * 1e3, "live")
        if art is not None:
            art.note_live_compile(self, key)
            if art.publish_bucket(self, key, b, self.capture_s[key]):
                return b, False  # the probe replayed over the outputs
        return b, True

    def _capture_bucket(self, key: tuple, x: torch.Tensor
                        ) -> programs.Captured:
        """Capture bucket ``key`` on input ``x`` (the caller holds the
        capture lock): :func:`programs.capture`, one eager run on the
        segment's stream, the walk's answer at this shape, which also
        counts the bucket's cost (:meth:`bucket_cost`); the capture; one
        replay that must equal the eager run bit for bit."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = programs.GraphPool(x.device)
        names = []

        def run(x):
            with torch.inference_mode():
                if names:
                    y, n = self._run_tree(self.tree, x, _IN)
                else:
                    with CostCount() as count:
                        y, n = self._run_tree(self.tree, x, _IN)
                    self._counted[key] = count.summary()
            names.append(n)
            return y

        b = programs.capture(run, (x.clone(),), self._pool,
                             f"segment {self.label!r}", f"bucket {key}")
        self._buckets[key] = b
        self._names.setdefault((key[0][1:], key[1].replace("torch.", "")),
                               names[0])
        self.capture_s[key] = time.perf_counter() - t0
        return b

    def drop_bucket(self, key: tuple) -> None:
        """Forget a captured bucket (its next call captures it again)."""
        self._buckets.pop(key, None)
        self.capture_s.pop(key, None)
        self._counted.pop(key, None)

    def bucket_cost(self, key: tuple) -> dict:
        """The counted cost of captured bucket ``key``: ``flops`` and
        ``bytes_accessed`` of its capture's eager run, and the segment's
        graph pool bytes as ``peak_hbm_bytes``."""
        return {**self._counted.get(key, {}),
                "peak_hbm_bytes": float(self.pool_bytes())}

    def note_ledger(self, key: tuple, wall_ms: float, source: str) -> None:
        """One capture-ledger row for bucket ``key`` (``source`` "live" or
        "aot-cache"), labelled as the reference labels a bucket
        (``"1x784:float32"``); never raises."""
        watch = self.compile_watch
        if watch is None:
            return
        try:
            shape, dtype = self.bucket_wire(key)
            cost = self.cost_by_bucket.get((shape, dtype), {})
            watch.note_compile(
                self.label,
                bucket="x".join(str(d) for d in shape) + f":{dtype}",
                wall_ms=wall_ms,
                flops=cost.get("flops", 0.0),
                bytes_accessed=cost.get("bytes_accessed", 0.0),
                peak_hbm_bytes=cost.get("peak_hbm_bytes", 0.0),
                source=source,
            )
        except Exception:
            logger.debug("segment %s: ledger row for bucket %s failed",
                         self.label, key, exc_info=True)

    def cost_for_rows(self, rows: int) -> Optional[dict]:
        """Estimated device cost of ``rows`` request rows through this
        segment: the best-matching counted bucket's cost scaled by the row
        share (exact bucket > smallest covering bucket > largest), so a
        coalesced batch's request shares sum to the executed bucket's
        total and padding is charged to nobody.  None until a bucket with
        a cost has run."""
        rows = max(1, int(rows))
        best = None  # (exactness rank, bucket_rows, cost)
        for (shape, _dtype), cost in self.cost_by_bucket.items():
            if not cost.get("flops") or not shape:
                continue
            bucket_rows = int(shape[0]) if shape[0] else 1
            if bucket_rows == rows:
                rank = 0
            elif bucket_rows > rows:
                rank = 1
            else:
                rank = 2
            cand = (rank, bucket_rows if rank == 1 else -bucket_rows)
            if best is None or cand < best[0]:
                best = (cand, bucket_rows, cost)
        if best is None:
            return None
        _, bucket_rows, cost = best
        share = rows / float(bucket_rows)
        return {
            "flops": cost["flops"] * share,
            "hbm_bytes": cost.get("bytes_accessed", 0.0) * share,
        }

    @staticmethod
    def _names_key(x) -> tuple:
        """(trailing shape, dtype after the walk's host conversion)."""
        from seldon_core_tpu_torch.runtime.component import host_dtype

        return (tuple(getattr(x, "shape", np.shape(x)))[1:], host_dtype(x))

    def out_names(self, x, in_names: Sequence[str]) -> list:
        """Final output names, byte-identical to the interpreted walk.

        Name resolution needs intermediate output *shapes* (the ``t:i``
        synthesized-names path); the segment records, per trailing shape
        and dtype, what its eager run or its capture resolved, and runs one
        row eagerly for a shape it has not seen.
        """
        key = self._names_key(x)
        names = self._names.get(key)
        if names is None:
            row = self._entry._to_device(np.asarray(x)[:1]
                                         if not isinstance(x, torch.Tensor)
                                         else x[:1])
            with torch.inference_mode():
                _, names = self._run_tree(self.tree, row, _IN)
            self._names[key] = names
        return list(in_names) if names is _IN else list(names)

    def pool_bytes(self) -> int:
        """Device bytes the segment's graph pool holds (0 on the CPU)."""
        return 0 if self._pool is None else self._pool.bytes()

    def describe(self) -> dict:
        return {
            "root": self.name,
            "members": [s.name for s in self.members],
            "n_nodes": len(self.members),
        }


# ---------------------------------------------------------------------------
# plan DAG
# ---------------------------------------------------------------------------


@dataclass
class PlanNode:
    """One node of the segment DAG the engine's plan mode walks.

    - ``segment`` set, no ``children``: fully fused subtree (terminal).
    - ``segment`` set, one child: fused MODEL/TRANSFORMER chain feeding an
      interpreted remainder.
    - ``segment`` None: interpreter boundary — ``node`` executes through
      the normal per-node path, ``children`` align 1:1 with
      ``node.children``.
    """

    node: Any                      # engine _Node
    segment: Optional[FusedSegment] = None
    children: list["PlanNode"] = field(default_factory=list)


class GraphPlan:
    """Compiled execution plan of one predictor graph."""

    def __init__(self, root: PlanNode, segments: list[FusedSegment],
                 boundaries: list[tuple[str, str]]):
        self.root = root
        self.segments = segments
        self.boundaries = boundaries  # (node name, reason) not fused

    @property
    def fully_fused(self) -> bool:
        return self.root.segment is not None and not self.root.children

    def describe(self) -> dict:
        return {
            "segments": [s.describe() for s in self.segments],
            "boundaries": [
                {"node": n, "reason": r} for n, r in self.boundaries
            ],
            "fully_fused": self.fully_fused,
        }

    def residency_map(self, annotations: Optional[dict] = None) -> list:
        """The planned residency of every request-flow edge of this plan
        under ``annotations`` (the device-plane posture): one dict per
        edge, ``src``, ``dst``, ``tier``, ``partition``, ``ownership``,
        ``fused``, ``remote``.  An edge inside a segment, or between two
        in-process nodes, keeps the tensor on the card; a remote edge gets
        the tier its transport can negotiate at best; the request's entry
        edge is host bytes.  From the spec and the plan only: nothing
        runs."""
        from seldon_core_tpu_torch.runtime.device_plane import (
            TIER_HBM_HANDLE,
            TIER_HOST_BYTES,
            DevicePlaneConfig,
            device_plane_config_from_annotations,
            negotiated_remote_tier,
        )
        from seldon_core_tpu_torch.runtime.device_registry import (
            OWNERSHIP_ONE_SHOT,
            OWNERSHIP_SHARED,
        )

        try:
            plane = device_plane_config_from_annotations(
                dict(annotations or {}), "plan")
        except ValueError:
            plane = None
        if plane is None:
            plane = DevicePlaneConfig(enabled=False)
        seg_of = {st.name: i for i, seg in enumerate(self.segments)
                  for st in seg.members}
        edges: list = []

        def visit(u, parent) -> None:
            fused = (parent is not None and u.name in seg_of
                     and seg_of.get(parent.name) == seg_of[u.name])
            remote = bool(u.endpoint.service_host) and \
                u.endpoint.type != "LOCAL"
            if fused or (parent is not None and not remote):
                tier, own = TIER_HBM_HANDLE, OWNERSHIP_SHARED
            elif remote:
                tier = negotiated_remote_tier(plane, u.endpoint.type)
                own = (OWNERSHIP_ONE_SHOT if tier != TIER_HOST_BYTES
                       else OWNERSHIP_SHARED)
            else:  # the entry edge: the server hands over parsed bytes
                tier, own = TIER_HOST_BYTES, OWNERSHIP_SHARED
            edges.append({"src": parent.name if parent is not None
                          else "<request>", "dst": u.name, "tier": tier,
                          "partition": "replicated", "ownership": own,
                          "fused": fused, "remote": remote})
            for c in u.children:
                visit(c, u)

        visit(self.root.node.unit, None)
        return edges

    def warmup(self, example_row=None) -> int:
        """Run every batcher bucket of every segment once before traffic
        (on the card: capture each bucket's graph).  ``example_row`` may be
        supplied; otherwise it is derived from the entry node's static
        signature (``models/__init__.py``).  A segment whose warm-up
        buckets are all captured already (at boot, from the artifact
        store) is skipped.  Returns buckets warmed."""
        warmed = 0
        for seg in self.segments:
            row = example_row
            if row is None:
                sig = _entry_signature(seg.root_node)
                if sig is None or sig.input_shape is None or any(
                        d is None for d in sig.input_shape[1:]):
                    continue
                dt = np.dtype(sig.input_dtype or "float32")
                row = np.zeros(tuple(sig.input_shape[1:]), dt)
            row = np.asarray(row)
            if self._warm_buckets_ready(seg, row):
                continue
            if seg.batcher is not None:
                seg.batcher.warmup(row)
                warmed += len(seg.batcher.buckets)
            else:
                y = seg(row[None])
                if isinstance(y, torch.Tensor) and y.is_cuda:
                    torch.cuda.synchronize(y.device)
                warmed += 1
        return warmed


    @staticmethod
    def _warm_buckets_ready(seg: FusedSegment, row) -> bool:
        """Every bucket a warm-up of ``row`` would run is captured."""
        from seldon_core_tpu_torch.runtime.component import host_dtype

        dtype = str(getattr(torch, host_dtype(row)))
        if seg.batcher is not None:
            sizes = {seg.batcher.bucket_for(b) for b in seg.batcher.buckets}
        else:
            sizes = {1}
        return all(((b,) + tuple(row.shape), dtype) in seg._buckets
                   for b in sizes)


def _entry_signature(node: Any):
    """Static input signature of the segment rooted at ``node``.  A
    COMBINER/OUTPUT_TRANSFORMER root descends as-is, so the request shape
    is whatever its first child expects — recurse until a node with a
    registered contract appears."""
    from seldon_core_tpu_torch.models import signature_for

    mc = node.unit.parameters.get("model_class")
    if isinstance(mc, str) and mc:
        return signature_for(mc)
    if node.type in ("COMBINER", "OUTPUT_TRANSFORMER") and node.children:
        return _entry_signature(node.children[0])
    return None


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------


def _subtree_stages(node: Any, out: dict) -> Optional[_SegTree]:
    """Whole subtree fusible → its _SegTree; else None (out collects
    boundary reasons for the report)."""
    stage = extract_stage(node)
    if stage is None:
        out.setdefault(node.unit.name, boundary_reason(node))
        return None
    if node.type == "COMBINER" and not node.children:
        out.setdefault(node.unit.name, "COMBINER without children")
        return None
    kids = []
    ok = True
    for c in node.children:
        sub = _subtree_stages(c, out)
        if sub is None:
            ok = False
        else:
            kids.append(sub)
    if not ok:
        return None
    return _SegTree(stage, kids)


def compile_plan(root_node: Any, batcher_config=None,
                 metrics=None) -> GraphPlan:
    """Partition the built engine graph into maximal fusible segments.
    ``batcher_config`` (a ``BatcherConfig``) attaches a DynamicBatcher to
    every segment so concurrent requests share one call across the WHOLE
    segment."""
    segments: list[FusedSegment] = []
    boundaries: dict[str, str] = {}

    def attach_batcher(seg: FusedSegment) -> None:
        if batcher_config is None:
            return
        import dataclasses

        from seldon_core_tpu_torch.runtime.batcher import DynamicBatcher

        cfg = dataclasses.replace(batcher_config)
        cfg.name = f"plan:{seg.name}"
        seg.batcher = DynamicBatcher(seg._batched, cfg, metrics=metrics)

    def build(node: Any) -> PlanNode:
        reasons: dict[str, str] = {}
        tree = _subtree_stages(node, reasons)
        if tree is not None:
            seg = FusedSegment(tree, node)
            attach_batcher(seg)
            segments.append(seg)
            return PlanNode(node=node, segment=seg)
        # maximal fusible MODEL/TRANSFORMER chain above the boundary
        run: list[Any] = []
        cur = node
        while (cur.type in ("MODEL", "TRANSFORMER")
               and len(cur.children) == 1
               and extract_stage(cur) is not None):
            run.append(cur)
            cur = cur.children[0]
        if run:
            chain: Optional[_SegTree] = None
            for n in reversed(run):
                st = extract_stage(n)
                chain = _SegTree(st, [chain] if chain else [])
            seg = FusedSegment(chain, run[0])
            attach_batcher(seg)
            segments.append(seg)
            return PlanNode(node=run[0], segment=seg,
                            children=[build(cur)])
        boundaries.update(reasons or {node.unit.name:
                                      boundary_reason(node)})
        return PlanNode(node=node,
                        children=[build(c) for c in node.children])

    root = build(root_node)
    # drop boundary entries for nodes that DID end up inside a segment
    # (a failed full-subtree attempt records reasons for its whole frontier)
    fused_names = {s.name for seg in segments for s in seg.members}
    report = [(n, r) for n, r in boundaries.items() if n not in fused_names]
    return GraphPlan(root, segments, report)
