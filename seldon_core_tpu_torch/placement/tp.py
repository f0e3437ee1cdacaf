"""Tensor-parallel weights of a fused segment: a sharded leaf and its op
table (the port's own; the reference leaves the split to GSPMD).

The reference arms a segment's tensor parallelism by handing ``jax.jit``
``NamedSharding``s for the covered weights: XLA then partitions every op
that reads them.  torch has no such partitioner, and a segment's stage
functions are written over whole tensors (``x @ p["w"] + p["b"]``).  So a
covered leaf becomes a :class:`TpLeaf`: a tensor subclass that holds one
piece per rank of the mesh's ``tp`` axis (a
:class:`~seldon_core_tpu_torch.parallel.mesh.Shards`, each piece on its
rank's device) and no storage of its own, with the whole leaf's shape,
dtype and device (rank 0's).  The stage functions run unchanged; the ops
that read a :class:`TpLeaf` go through :meth:`TpLeaf.__torch_function__`:

- a product against a 2-D leaf split on its **output** dim (``x @ W`` with
  ``W`` split on dim 1, ``F.linear(x, W)`` on dim 0, ``torch.addmm``):
  each rank computes its columns from the whole ``x`` on its device, and
  the pieces are concatenated along the last dim on ``x``'s device (the
  all-gather);
- a product against a 2-D leaf split on its **contraction** dim: each
  rank multiplies its slice of ``x``'s last dim by its piece, and the
  partials are summed in float32 in rank order
  (:func:`~seldon_core_tpu_torch.parallel.mesh.psum`), then cast back;
- every other op (a split bias added, a transpose, a reduction) gathers
  the whole leaf first (:meth:`TpLeaf.whole`), which is exact.  An op that
  reaches the dispatcher with a :class:`TpLeaf` (a dispatch mode, say)
  gathers the same way.

A product's pieces are computed one rank after another on one process,
as the rest of the port's single controller does (``parallel/mesh.py``).
Each piece is the whole product's own columns or partial sum, but the
product's kernel may be chosen by shape, so the result can differ from
the unsharded product in the last bits: the plan's parity gate decides
(``graph/plan.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from seldon_core_tpu_torch.parallel.mesh import Shards, psum

__all__ = ["TpLeaf", "rank_bytes"]

#: ``x @ W`` (W of shape (K, N)); ``F.linear`` and ``torch.addmm`` are
#: matched apart
_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.mm, torch.Tensor.mm}


class TpLeaf(torch.Tensor):
    """One weight split over a mesh's ``tp`` axis: ``parts`` (one piece a
    rank, on that rank's device) concatenated along ``split_dim`` is the
    leaf."""

    parts: Shards
    split_dim: int

    @staticmethod
    def __new__(cls, parts: Shards):
        if parts.dim is None:
            raise ValueError("a TpLeaf is split along a dim")
        shape = list(parts[0].shape)
        shape[parts.dim] = sum(int(p.shape[parts.dim]) for p in parts)
        t = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=parts[0].dtype, device=parts[0].device,
            requires_grad=False)
        t.parts = parts
        t.split_dim = parts.dim
        return t

    def __repr__(self) -> str:
        return (f"TpLeaf(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"split_dim={self.split_dim}, ranks={len(self.parts)})")

    def whole(self) -> torch.Tensor:
        """The whole leaf on rank 0's device (the all-gather)."""
        dev = self.parts[0].device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.split_dim)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "__get__":
            # metadata (shape, dtype, device, ndim): the wrapper's own
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        out = _split_product(func, args, kwargs)
        if out is not None:
            return out
        with torch._C.DisableTorchFunctionSubclass():
            return func(*tree_map(_whole, args), **tree_map(_whole, kwargs))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return func(*tree_map(_whole, args),
                    **tree_map(_whole, kwargs or {}))


def _whole(a):
    return a.whole() if isinstance(a, TpLeaf) else a


def rank_bytes(leaf: TpLeaf) -> list:
    """Bytes of storage each rank's piece holds."""
    return [int(p.untyped_storage().nbytes()) for p in leaf.parts]


def _column_pieces(x: torch.Tensor, w: TpLeaf, piece) -> torch.Tensor:
    """``piece(x_r, w_r, r)`` on every rank from the whole ``x``, the
    outputs concatenated along the last dim on ``x``'s device."""
    outs = [piece(x.to(p.device), p, r) for r, p in enumerate(w.parts)]
    return torch.cat([o.to(x.device) for o in outs], dim=-1)


def _row_pieces(x: torch.Tensor, w: TpLeaf, piece) -> torch.Tensor:
    """``piece(x_r, w_r)`` on every rank, ``x_r`` the slice of ``x``'s last
    dim that rank's piece contracts, the partials summed in float32 in
    rank order on ``x``'s device."""
    k = [int(p.shape[w.split_dim]) for p in w.parts]
    xs = torch.split(x, k, dim=-1)
    partials = [piece(xr.to(p.device), p) for xr, p in zip(xs, w.parts)]
    return psum(partials)[0].to(x.device)


def _bias_piece(bias: Optional[torch.Tensor], w: TpLeaf, r: int):
    """Rank ``r``'s columns of a bias over a leaf split on its output
    dim."""
    if bias is None:
        return None
    whole = _whole(bias)
    if whole.dim() == 0 or whole.shape[-1] == 1:
        return whole.to(w.parts[r].device)
    n = [int(p.shape[w.split_dim]) for p in w.parts]
    return torch.split(whole, n, dim=-1)[r].to(w.parts[r].device)


def _split_product(func, args, kwargs):
    """A product against a split 2-D leaf, piece by piece, or None when
    ``func`` is not one (the caller then gathers)."""
    if func in _MATMULS and not kwargs and len(args) == 2:
        x, w = args
        if (isinstance(w, TpLeaf) and not isinstance(x, TpLeaf)
                and w.dim() == 2 and x.dim() >= 1):
            if w.split_dim == 1:  # output columns
                return _column_pieces(x, w, lambda xr, wr, r: xr @ wr)
            return _row_pieces(x, w, lambda xr, wr: xr @ wr)
        return None
    if func is F.linear:
        x, w = args[0], args[1] if len(args) > 1 else kwargs.get("weight")
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        if (isinstance(w, TpLeaf) and not isinstance(x, TpLeaf)
                and w.dim() == 2):
            if w.split_dim == 0:  # (N, K): output rows of the weight
                return _column_pieces(x, w, lambda xr, wr, r: F.linear(
                    xr, wr, _bias_piece(bias, w, r)))
            y = _row_pieces(x, w, lambda xr, wr: F.linear(xr, wr))
            return y if bias is None else y + _whole(bias).to(y.device)
        return None
    if func is torch.addmm and not kwargs and len(args) == 3:
        bias, x, w = args
        if (isinstance(w, TpLeaf) and not isinstance(x, TpLeaf)
                and w.dim() == 2):
            if w.split_dim == 1:
                return _column_pieces(x, w, lambda xr, wr, r: torch.addmm(
                    _bias_piece(bias, w, r), xr, wr))
            return _whole(bias).to(x.device) + _row_pieces(
                x, w, lambda xr, wr: xr @ wr)
        return None
    return None
