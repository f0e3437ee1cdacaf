"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
(port of ``seldon_core_tpu/parallel/pipeline.py``).

The layer stack is split into ``pp`` stages whose parameters carry a
leading stage dim split over the "pp" axis.  One controller runs the
schedule the reference compiles into one SPMD program: at tick ``t`` stage
``s`` takes microbatch ``t - s`` on its devices, and its output moves on
from stage ``s``'s first rank to stage ``s + 1``'s (the reference's
``ppermute``; ``parallel/mesh.py`` ``scatter``, across processes when the
stages lie in different ones, its backward the move back).  The
reference's bubble ticks compute values it masks away; here they compute
nothing.  Every step is an out-of-place torch op or a move with its
transpose, so autograd runs back through the schedule and the same code
trains.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    Ranks,
    Shards,
    gather,
    scatter,
)

__all__ = ["pipeline_apply", "stack_stage_params", "stage_slice"]


def stage_slice(tree: Any, stage: int, n_stages: int, axis: str = "pp"):
    """Stage ``stage``'s part of ``tree``: a leaf split over ``axis`` (a
    :class:`Shards` of stage pieces) gives its piece; any other leaf (a
    tensor, or a :class:`Shards` over another axis) its slice of the
    leading dim, which must divide by ``n_stages``."""
    if isinstance(tree, dict):
        return {k: stage_slice(v, stage, n_stages, axis)
                for k, v in tree.items()}
    if isinstance(tree, Shards):
        if tree.axis == axis:
            return tree[stage]
        return Shards([stage_slice(t, stage, n_stages, axis) for t in tree],
                      tree.dim, tree.axis)
    if isinstance(tree, (list, tuple)):
        return type(tree)(stage_slice(t, stage, n_stages, axis)
                          for t in tree)
    if tree is None:  # a piece another process keeps
        return None
    n = tree.shape[0]
    if n % n_stages:
        raise ValueError(f"leading dim {n} does not split over "
                         f"{axis}={n_stages}")
    per = n // n_stages
    return tree[stage * per:(stage + 1) * per]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x, mesh: Mesh,
                   n_microbatches: int, axis: str = "pp"):
    """Run ``x`` through the ``pp`` stages of ``mesh``'s ``axis``.

    - ``stage_params``: a tree whose leaves have a leading stage dim split
      over ``axis`` (:func:`stage_slice`); stage ``s`` receives its slice.
    - ``stage_fn(local_params, act, s)`` applies stage ``s``'s layers (the
      reference's ``stage_fn(local_params, act)`` with the stage index, so
      the function can place its work on that stage's devices); ``act``
      is on stage ``s``'s first rank, and so is what it returns.
    - ``x``: [batch, ...] on stage 0's first rank; the batch must divide by
      ``n_microbatches``; microbatch ``i`` is rows ``[i * mb, (i + 1) *
      mb)``.

    Returns the last stage's [batch, ...] output on ``x``'s device.  With
    pp = 1 the whole stack is applied at once (the reference's degenerate
    path).  Over a mesh whose ranks span processes every process calls it,
    and ``stage_fn`` too, for every stage and microbatch (with ``act=None``
    where this process holds no stage's first rank, so that it takes part
    in the stage's moves); ``x`` and the result are stage 0's first rank's
    (``None`` in other processes)."""
    pp = mesh.axis_size(axis)
    if pp == 1:
        whole = stage_slice(stage_params, 0, 1, axis)
        return stage_fn(whole, x, 0)
    roots = mesh.axis_devices(axis)  # each stage's first rank
    mb = None
    if x is not None:
        B = x.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not divide in "
                             f"{n_microbatches} microbatches")
        mb = B // n_microbatches
    local = [stage_slice(stage_params, s, pp, axis) for s in range(pp)]
    carry = [None] * pp  # what each stage hands on at the end of a tick
    outs = [None] * n_microbatches
    for t in range(n_microbatches + pp - 1):
        handed = [None] * pp
        for s in range(pp):
            i = t - s
            if not 0 <= i < n_microbatches:
                continue  # a bubble: the reference masks its result away
            if s == 0:
                act = None if x is None else x[i * mb:(i + 1) * mb].to(
                    roots[0])
            else:
                act = scatter(carry[s - 1], roots.ids[s - 1],
                              Ranks.of(mesh, [roots.ids[s]]),
                              lambda a: [(slice(None),)])[0]
            out = stage_fn(local[s], act, s)
            if s == pp - 1:
                outs[i] = out
            else:
                handed[s] = out
        carry = handed
    y = gather(outs, Ranks.of(mesh, [roots.ids[-1]] * n_microbatches),
               roots.ids[0], lambda ps: torch.cat(ps, dim=0),
               lambda c: list(torch.chunk(c, n_microbatches, dim=0)))
    return None if y is None or x is None else y.to(x.device)


def stack_stage_params(per_stage: list) -> Any:
    """Stack a list of per-stage trees into one tree with a leading stage
    dim (the layout :func:`pipeline_apply` expects)."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage])
