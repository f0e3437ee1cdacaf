"""Device meshes and their collectives (port of
``seldon_core_tpu/parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device``s with named axes, ``("dp",
"pp", "tp")`` as :func:`make_mesh` builds it.  ONE process drives every
device of it, as one controller drives a ``jax.sharding.Mesh``: the model
code runs each rank's share of a layer on that rank's device and meets the
other ranks only in the explicit collectives below.  A device may repeat:
``["cpu", "cpu"]`` is a 2-rank mesh on the CPU (the counterpart of the
reference's virtual CPU devices), and ``[cuda:0, cuda:0]`` two ranks on one
card, which run one after the other on its stream.

A tensor split over a mesh axis is a :class:`Shards`: one tensor per rank of
the axis, on that rank's device, the pieces of the global tensor along
``dim`` (or whole copies when ``dim`` is None).  A tensor split over several
axes nests them, "pp" outermost, then "dp", then "tp" (a pipelined expert
weight: its stages, each stage's expert groups, each group's tp pieces).
:func:`pspec` and :func:`named_sharding` name the split as the reference's
``PartitionSpec`` and ``NamedSharding`` do; :func:`place` applies it.  Every
placed piece owns its storage, so each is a leaf an optimizer can update in
place; a leaf the spec replicates stays ONE tensor (on the first device of
its group), and whoever computes with it on another rank copies it there
with ``.to()``, so autograd sums that rank's gradient into the one leaf.

The collectives act on the ranks of one axis, in rank order:

- :func:`psum`: the partials summed in float32 on rank 0's device, in rank
  order, cast, and copied back to every rank's device;
- :func:`psum_scatter`: the same sum split along a dim, rank ``r`` keeping
  piece ``r`` (Megatron's reduce-scatter back to sequence shards);
- :func:`all_gather`: the pieces concatenated on rank 0's device, copied back;
- :func:`ppermute`: a ring shift, rank ``r`` receiving rank ``r - 1``'s;
- :func:`all_to_all`: each rank's tensor split in ``n`` along ``split_dim``,
  rank ``r`` receiving every rank's ``r``-th piece, concatenated along
  ``concat_dim`` (the sequence-to-heads move of ring prefill).

A copy to the device a tensor is already on is no copy (``Tensor.to``).
Several processes (multi-host) would back the same functions with
``torch.distributed``; this module has none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "AXIS_ORDER", "Mesh", "MeshPlan", "MeshPlanError", "NamedSharding",
    "Shards", "all_gather", "all_to_all", "make_mesh", "named_sharding",
    "place", "plan_mesh", "ppermute", "psum", "psum_scatter", "pspec",
    "single_axis_mesh", "unshard",
]

AXIS_ORDER = ("dp", "pp", "tp")


class MeshPlanError(ValueError):
    """A requested mesh factorization cannot be realized on the available
    devices (an axis does not divide the device count, a size below 1, a
    plan and a device list of different sizes, more devices asked for than
    are visible)."""


@dataclass
class MeshPlan:
    """A named factorization of a device count into mesh axes."""

    dp: int = 1
    pp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp}


def plan_mesh(n_devices: int, tp: Optional[int] = None,
              pp: Optional[int] = None, max_tp: int = 8) -> MeshPlan:
    """Factor ``n_devices`` into (dp, pp, tp).

    Defaults: the largest power-of-two tp <= min(max_tp, n), pp = 1, the
    rest dp.  An explicit tp or pp must divide the devices left to it."""
    if n_devices < 1:
        raise MeshPlanError("n_devices must be >= 1")
    if tp is None:
        tp = 1
        while tp * 2 <= min(max_tp, n_devices) and n_devices % (tp * 2) == 0:
            tp *= 2
    if tp < 1:
        raise MeshPlanError(f"tp={tp} must be >= 1")
    if n_devices % tp != 0:
        raise MeshPlanError(
            f"tp={tp} does not divide n_devices={n_devices}")
    rem = n_devices // tp
    if pp is None:
        pp = 1
    if pp < 1:
        raise MeshPlanError(f"pp={pp} must be >= 1")
    if rem % pp != 0:
        raise MeshPlanError(
            f"pp={pp} does not divide n_devices/tp={rem} "
            f"(n_devices={n_devices}, tp={tp})")
    return MeshPlan(dp=rem // pp, pp=pp, tp=tp)


class Mesh:
    """``devices``: an array of ``torch.device`` with one dimension per name
    of ``axis_names``.  ``shape`` maps each axis to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str] = AXIS_ORDER):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise MeshPlanError(f"devices of shape {arr.shape} for axes "
                                f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names, arr.shape)}

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_devices(self, axis: str, **at) -> list:
        """The devices along ``axis``, the other axes at the coordinates
        ``at`` (0 where not given); ``[first device]`` for an axis the mesh
        does not have."""
        idx = []
        for a in self.axis_names:
            idx.append(slice(None) if a == axis else int(at.get(a, 0)))
        if axis not in self.axis_names:
            return [self.devices[tuple(idx)]]
        return list(self.devices[tuple(idx)])

    @property
    def distinct_devices(self) -> list:
        """Each device of the mesh once, in first-seen order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        axes = ",".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.distinct_devices]})"


def _default_devices(n: int, device) -> list:
    """``n`` devices of the kind of ``device``: the first ``n`` CUDA devices
    (MeshPlanError when fewer are visible), or ``n`` repeats of the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise MeshPlanError(
                f"mesh wants {n} device(s) but only {have} CUDA device(s) "
                "visible")
        return [torch.device("cuda", i) for i in range(n)]
    if kind == "cpu":
        return [torch.device("cpu")] * n
    raise MeshPlanError(f"no default devices of kind {kind!r}")


def make_mesh(plan: Optional[MeshPlan] = None,
              devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None, device="cuda",
              **plan_kw) -> Mesh:
    """A :class:`Mesh` with axes ("dp", "pp", "tp").

    ``devices`` (a device may repeat) gives the ranks in (dp, pp, tp)
    order; without it the mesh takes ``n_devices`` (or the plan's count) of
    ``device``'s kind: the first CUDA devices, refusing more than are
    visible, or repeats of the CPU.  With no plan, ``n_devices`` is planned
    by :func:`plan_mesh` (``tp=``, ``pp=``)."""
    if devices is None:
        n = n_devices if n_devices is not None else (
            plan.n_devices if plan is not None else None)
        if n is None:
            raise MeshPlanError("make_mesh needs devices, n_devices or a plan")
        if plan is not None and plan.n_devices > n:
            raise MeshPlanError(
                f"plan wants {plan.n_devices} devices, have {n}")
        devices = _default_devices(n, device)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if plan is None:
        plan = plan_mesh(len(devices), **plan_kw)
    if plan.n_devices != len(devices):
        raise MeshPlanError(
            f"plan wants {plan.n_devices} devices, have {len(devices)}")
    arr = np.empty((len(devices),), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(plan.dp, plan.pp, plan.tp), AXIS_ORDER)


def single_axis_mesh(axis: str = "sp", n_devices: int = 1,
                     device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` of ``device``'s kind (ring attention on
    its own)."""
    devices = _default_devices(n_devices, device)
    arr = np.empty((len(devices),), dtype=object)
    arr[:] = devices
    return Mesh(arr, (axis,))


# ----------------------------------------------------------------------
# placement specs and sharded tensors
# ----------------------------------------------------------------------

def pspec(*axes) -> tuple:
    """A placement spec: per tensor dim, the mesh axis it is split over, or
    None (the reference's ``PartitionSpec``)."""
    return tuple(axes)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a placement spec (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple


def named_sharding(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, pspec(*axes))


class Shards(list):
    """One tensor per rank of mesh axis ``axis``, rank ``r``'s on that
    rank's device: the pieces of a global tensor split evenly along
    ``dim``, or whole copies when ``dim`` is None.  A piece may itself be a
    :class:`Shards` over an inner axis (module docstring)."""

    def __init__(self, parts, dim: Optional[int], axis: str = "tp"):
        super().__init__(parts)
        self.dim = dim
        self.axis = axis

    def map(self, fn, *others) -> "Shards":
        """``fn`` on each rank's tensor (and the same rank of ``others``),
        keeping ``dim`` and ``axis``."""
        return Shards([fn(*xs) for xs in zip(self, *others)], self.dim,
                      self.axis)


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own (a chunk along dim 0 is a view of the
    whole tensor's)."""
    return t.clone() if t.untyped_storage().nbytes() > t.nbytes else t


#: the nesting order of a tensor split over several axes, outermost first
NEST_ORDER = ("pp", "dp", "tp")


def place(x: torch.Tensor, sharding: NamedSharding, layout=None, **at):
    """``x`` placed as ``sharding`` says: for each axis the spec names, in
    :data:`NEST_ORDER`, a :class:`Shards` of the pieces along that axis's
    dim (even splits only), each piece placed over the remaining axes at
    its coordinate; ``x`` on the group's first device when the spec names
    no axis.  ``layout`` (a function of a tensor) is applied to each
    piece, for example ``ops.quant.k_major``; ``at`` gives the coordinates
    of the axes the spec does not name (0 where not given).  Every piece
    owns its storage."""
    spec, mesh = sharding.spec, sharding.mesh
    layout = layout or (lambda t: t)
    for axis in NEST_ORDER:
        if axis not in spec:
            continue
        dim = spec.index(axis)
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise MeshPlanError(f"dim {dim} of size {x.shape[dim]} does not "
                                f"split over {axis}={n}")
        if axis == "tp":
            devs = mesh.axis_devices(axis, **at)
            return Shards([layout(_owned(p.to(d).contiguous()))
                           for p, d in zip(torch.chunk(x, n, dim=dim), devs)],
                          dim)
        rest = NamedSharding(mesh, tuple(None if a == axis else a
                                         for a in spec))
        return Shards([place(p, rest, layout, **{**at, axis: i})
                       for i, p in enumerate(torch.chunk(x, n, dim=dim))],
                      dim, axis)
    return layout(_owned(x.to(mesh.axis_devices("tp", **at)[0])))


def _first(x):
    return _first(x[0]) if isinstance(x, Shards) else x


def unshard(x, device=None) -> torch.Tensor:
    """The global tensor of ``x`` on ``device`` (its first piece's by
    default), nested :class:`Shards` included; a plain tensor is returned as
    it is (moved to ``device`` when given)."""
    if not isinstance(x, Shards):
        return x if device is None else x.to(device)
    device = _first(x).device if device is None else device
    if x.dim is None:
        return unshard(x[0], device)
    return torch.cat([unshard(p, device) for p in x], dim=x.dim)


# ----------------------------------------------------------------------
# collectives over one axis (a Shards' ranks, in order)
# ----------------------------------------------------------------------

def _sum_f32(parts: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """The partials summed in float32 on rank 0's device, in rank order,
    cast to ``dtype`` (the partials' by default)."""
    dev0 = parts[0].device
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.to(dev0).float()
    return total.to(parts[0].dtype if dtype is None else dtype)


def psum(parts: Sequence[torch.Tensor], dtype=None) -> Shards:
    """The sum of every rank's partial, in float32 on rank 0's device, in
    rank order, cast to ``dtype`` (the partials' by default) and copied back
    to each rank's device."""
    total = _sum_f32(parts, dtype)
    return Shards([total.to(p.device) for p in parts], None)


def psum_scatter(parts: Sequence[torch.Tensor], dim: int,
                 dtype=None) -> list:
    """:func:`psum`'s sum (float32 on rank 0's device, in rank order, cast)
    split in ``len(parts)`` even pieces along ``dim``: rank ``r`` receives
    piece ``r`` on its own device."""
    pieces = torch.chunk(_sum_f32(parts, dtype), len(parts), dim=dim)
    if len(pieces) != len(parts):
        raise ValueError(f"psum_scatter: dim {dim} does not split in "
                         f"{len(parts)}")
    return [c.to(p.device) for c, p in zip(pieces, parts)]


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> Shards:
    """Every rank's piece concatenated along ``dim`` on rank 0's device, and
    copied back to each rank's device."""
    dev0 = parts[0].device
    whole = torch.cat([p.to(dev0) for p in parts], dim=dim)
    return Shards([whole.to(p.device) for p in parts], None)


def ppermute(parts: Sequence[torch.Tensor]) -> list:
    """A ring shift by one: rank ``r`` receives rank ``r - 1``'s tensor
    (rank 0 the last rank's), on its own device."""
    n = len(parts)
    return [parts[(r - 1) % n].to(parts[r].device) for r in range(n)]


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> list:
    """Each rank's tensor split in ``n`` even pieces along ``split_dim``;
    rank ``r`` receives piece ``r`` of every rank, concatenated in rank
    order along ``concat_dim``, on its own device."""
    n = len(parts)
    pieces = [torch.chunk(p, n, dim=split_dim) for p in parts]
    if any(len(ps) != n for ps in pieces):
        raise ValueError(f"all_to_all: dim {split_dim} does not split in {n}")
    return [torch.cat([pieces[s][r].to(parts[r].device) for s in range(n)],
                      dim=concat_dim) for r in range(n)]
