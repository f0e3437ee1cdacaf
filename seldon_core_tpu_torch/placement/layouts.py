"""Per-param tensor-parallel layouts — the ``SpecLayout`` rule table.

A segment whose resident weights exceed one device's HBM cannot be
placed by replication (the dp path copies weights everywhere).  The fix
is model parallelism: shard the big weight matrices over the mesh's
``tp`` axis so each device holds ``1/tp`` of them.  This module owns the
mapping from *parameter names* to *``PartitionSpec`` axis tuples* — the
Megatron split catalogue (SNIPPETS.md [3]):

- **qkv projections** (``wq``/``wk``/``wv``) — column-parallel: the
  head/output dim splits, each device computes full contractions for
  its slice of heads.  No cross-device reduction, so column splits are
  bitwise-safe.
- **attention output** (``wo``) and **ffn down** (``w2``) —
  row-parallel: the contraction dim splits and partial products
  ``psum`` across the tp group.  The reduction reorders float adds, so
  row splits rely on the byte-parity gate to adjudicate per backend.
- **ffn up** (``w1``) — column-parallel.
- **embeddings / unembedding** (``embedding``/``embed``/``lm_head``) —
  vocab/column splits.

Resolution order for one segment member: the signature registry's
declared ``tp_param_specs`` first (exact intent beats inference), then
the rule table against each leaf's trailing path name.  Param pytrees
are walked with ``/``-joined path keys (``"0/w"`` for a list of layer
dicts) — the same convention the GL16xx trace-lint uses, so lint and
runtime agree on which param a spec names.

Port of ``seldon_core_tpu/placement/layouts.py``.  The rule table and its
checks are what the admission lint reads (GL1207); :func:`build_shardings`
names each leaf's placement over the port's mesh
(``parallel/mesh.py`` ``NamedSharding``), and :func:`place_params` applies
it: a covered leaf becomes a ``placement/tp.py`` :class:`TpLeaf` of
per-rank pieces, the rest stays whole on the tp group's first device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

__all__ = [
    "TpRule",
    "SpecLayout",
    "DEFAULT_LAYOUT",
    "iter_param_leaves",
    "match_spec",
    "resolve_layout",
    "tp_param_bytes",
    "check_divisibility",
    "build_shardings",
    "place_params",
]


@dataclass(frozen=True)
class TpRule:
    """One rule: param-name pattern → per-rank axis tuples.

    ``axes_by_rank`` maps a leaf's ndim to the full ``PartitionSpec``
    axis tuple (rank-keyed because e.g. ffn weights appear as 2-D
    singles or 3-D layer stacks).  A leaf whose rank has no entry
    replicates — an unknown layout must never guess."""

    pattern: str
    axes_by_rank: dict

    def axes_for(self, ndim: int) -> Optional[tuple]:
        return self.axes_by_rank.get(ndim)


#: the Megatron split catalogue; matched against the trailing path name
DEFAULT_RULES: tuple = (
    # attention qkv: column-parallel — heads split over tp
    TpRule("wq", {3: (None, "tp", None), 4: (None, None, "tp", None)}),
    TpRule("wk", {3: (None, "tp", None), 4: (None, None, "tp", None)}),
    TpRule("wv", {3: (None, "tp", None), 4: (None, None, "tp", None)}),
    # attention out: row-parallel — contraction dim split, psum after
    TpRule("wo", {3: ("tp", None, None), 4: (None, "tp", None, None)}),
    # ffn up: column-parallel
    TpRule("w1", {2: (None, "tp"), 3: (None, None, "tp")}),
    # ffn down: row-parallel
    TpRule("w2", {2: ("tp", None), 3: (None, "tp", None)}),
    # embeddings / unembedding: vocab-or-feature column splits
    TpRule("embedding", {2: (None, "tp")}),
    TpRule("embed", {2: (None, "tp")}),
    TpRule("lm_head", {2: (None, "tp")}),
)


@dataclass(frozen=True)
class SpecLayout:
    """An ordered rule table; first matching rule wins."""

    rules: tuple = DEFAULT_RULES

    def spec_for(self, pkey: str, ndim: int) -> Optional[tuple]:
        leaf_name = pkey.rsplit("/", 1)[-1]
        for rule in self.rules:
            if rule.pattern == leaf_name or rule.pattern in pkey:
                return rule.axes_for(ndim)
        return None


DEFAULT_LAYOUT = SpecLayout()


def iter_param_leaves(params, prefix: str = "") -> Iterator[tuple]:
    """``(path_key, leaf)`` pairs over a params container, path keys
    ``/``-joined (``"0/w"``) — matches the trace-lint's ``_keystr``."""
    if isinstance(params, dict):
        for k in params:
            yield from iter_param_leaves(params[k], f"{prefix}{k}/")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from iter_param_leaves(v, f"{prefix}{i}/")
    elif params is not None:
        yield prefix[:-1] if prefix else "", params


def match_spec(specs: dict, pkey: str) -> Optional[tuple]:
    """Declared-spec lookup for one leaf path — same match semantics as
    the GL1604 trace-lint (exact, trailing component, substring)."""
    for key, axes in specs.items():
        if pkey == key or pkey.endswith("/" + key) or key in pkey:
            return tuple(axes)
    return None


def _leaf_shape(leaf) -> Optional[tuple]:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else None


def resolve_layout(params, declared: Optional[dict] = None, tp: int = 1,
                   rules: SpecLayout = DEFAULT_LAYOUT) -> dict:
    """The effective layout of one member: ``{path_key: axis tuple}``
    for every leaf that actually shards over ``tp``.

    Declared ``tp_param_specs`` win over the rule table; either source
    is dropped for a leaf when the axis tuple's rank disagrees with the
    leaf's, or when the ``tp`` entry names a dim ``tp`` does not divide
    — an indivisible dim replicates at runtime (and is an admission
    ERROR, GL1207)."""
    layout: dict = {}
    if tp < 2:
        return layout
    for pkey, leaf in iter_param_leaves(params):
        shape = _leaf_shape(leaf)
        if shape is None:
            continue
        axes = match_spec(declared, pkey) if declared else None
        if axes is None:
            axes = rules.spec_for(pkey, len(shape))
        if axes is None or len(axes) != len(shape) or "tp" not in axes:
            continue
        if any(a == "tp" and shape[i] % tp for i, a in enumerate(axes)):
            continue
        layout[pkey] = tuple(axes)
    return layout


def tp_param_bytes(params, layout: dict) -> int:
    """Bytes of ``params`` covered by ``layout`` — the numerator of the
    planner's per-device HBM math (these bytes divide by ``tp``; the
    rest replicates)."""
    total = 0
    for pkey, leaf in iter_param_leaves(params):
        if pkey not in layout:
            continue
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is None:
            shape = _leaf_shape(leaf) or ()
            n = 1
            for d in shape:
                n *= int(d)
            nbytes = n * 4
        total += int(nbytes)
    return total


def check_divisibility(param_dims: dict, tp: int,
                       declared: Optional[dict] = None,
                       rules: SpecLayout = DEFAULT_LAYOUT) -> list:
    """Violations of the effective layout against traced param shapes:
    ``[(path_key, axis index, dim size)]`` where a ``tp`` entry names a
    dim ``tp`` does not divide.  ``param_dims`` is the trace-lint's
    ``{"path/leaf": shape}`` map — this is the GL1207 admission check,
    fed by shapes, not weights."""
    bad: list = []
    for pkey, shape in sorted(param_dims.items()):
        axes = match_spec(declared, pkey) if declared else None
        if axes is None:
            axes = rules.spec_for(pkey, len(shape))
        if axes is None or len(axes) != len(shape):
            continue
        for i, a in enumerate(axes):
            if a == "tp" and shape[i] % tp:
                bad.append((pkey, i, int(shape[i])))
    return bad


def _map_leaves(params, fn, prefix: str = ""):
    """``params`` with every leaf replaced by ``fn(path_key, leaf)``, the
    containers' kinds kept."""
    if isinstance(params, dict):
        return {k: _map_leaves(v, fn, f"{prefix}{k}/")
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        seq = [_map_leaves(v, fn, f"{prefix}{i}/")
               for i, v in enumerate(params)]
        if hasattr(params, "_fields"):  # a NamedTuple (QuantizedLinear)
            return type(params)(*seq)
        return type(params)(seq) if isinstance(params, tuple) else seq
    if params is None:
        return None
    return fn(prefix[:-1] if prefix else "", params)


def build_shardings(mesh, params, layout: dict):
    """A sharding tree matching ``params``: the port's ``NamedSharding``
    with the layout's spec for covered leaves, replicated (the empty spec)
    for the rest."""
    from seldon_core_tpu_torch.parallel.mesh import named_sharding

    repl = named_sharding(mesh)
    return _map_leaves(params, lambda pkey, _leaf: (
        named_sharding(mesh, *layout[pkey]) if pkey in layout else repl))


def _owned(t):
    """``t`` in storage of its own (a piece split along dim 0 is a view of
    the whole leaf's)."""
    return t.clone() if t.untyped_storage().nbytes() > t.nbytes else t


def place_params(mesh, params, layout: dict, dp: int = 0):
    """``params`` placed on the tp group of dp rank ``dp``: every covered
    leaf a :class:`~seldon_core_tpu_torch.placement.tp.TpLeaf` of its
    pieces on the group's devices, every other tensor on the group's first
    device (no copy where it is there already)."""
    import copy

    import torch

    from seldon_core_tpu_torch.parallel.mesh import place
    from seldon_core_tpu_torch.placement.tp import TpLeaf

    shardings = build_shardings(mesh, params, layout)
    flat = dict(iter_param_leaves(shardings))
    first = mesh.axis_devices("tp", dp=dp)[0]

    def put(pkey, leaf):
        if pkey in layout:
            return TpLeaf(place(leaf, flat[pkey], layout=_owned, dp=dp))
        if isinstance(leaf, torch.Tensor):
            return leaf.to(first)
        if isinstance(leaf, torch.nn.Module):
            dev = next(leaf.parameters(), torch.empty(0)).device
            same = dev.type == first.type and (dev.index or 0) == (
                first.index or 0)  # "cuda" is the current card
            return leaf if same else copy.deepcopy(leaf).to(first)
        return leaf

    return _map_leaves(params, put)
