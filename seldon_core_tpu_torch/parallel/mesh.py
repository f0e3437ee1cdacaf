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

**A mesh over several processes** (multi-host, ``runtime/multihost.py``):
:func:`process_mesh` builds the global mesh of a ``torch.distributed``
process group, its ranks in process order as ``jax.devices()`` orders them
(process ``p`` of ``k`` local ranks owns ranks ``p*k .. p*k+k-1``).  A rank
that another process owns has no device here: ``None`` in ``devices``
(:attr:`Mesh.spans_processes`).  Every per-rank list (a :class:`Shards`
included) then holds ``None`` at those ranks, and :func:`rank_map` runs a
rank's work only where this process holds the rank.  The collectives keep
their arithmetic: each first gathers every rank's tensor in its own dtype
(:func:`_exchange`, exact bytes staged through host memory over the group,
gloo), then every process computes what the single controller computes
(a sum in float32 in rank order) on its first local device, for its own
ranks.  So an answer does not depend on how the ranks fall over
processes.  The scope is the reference's multi-host proof: a tp axis across
processes, dp = pp = 1 across them; :func:`check_one_process` refuses the
rest by name.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "AXIS_ORDER", "Mesh", "MeshPlan", "MeshPlanError", "NamedSharding",
    "Shards", "all_gather", "all_to_all", "check_one_process",
    "first_device", "make_mesh", "named_sharding", "place", "plan_mesh",
    "ppermute", "process_mesh", "psum", "psum_scatter", "pspec", "rank_map",
    "reset_transport_stats", "single_axis_mesh", "transport_stats",
    "unshard",
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
            # None: a rank another process owns (process_mesh)
            arr[idx] = None if src[idx] is None else torch.device(src[idx])
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
        """Each device of this process's ranks once, in first-seen order."""
        out = []
        for d in self.devices.flat:
            if d is not None and d not in out:
                out.append(d)
        return out

    @property
    def n_processes(self) -> int:
        """How many processes hold the mesh's ranks (as many each)."""
        local = int(sum(d is not None for d in self.devices.flat))
        return self.devices.size // local if local else 1

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own some of the ranks
        (:func:`process_mesh`)."""
        return any(d is None for d in self.devices.flat)

    def __repr__(self) -> str:
        axes = ",".join(f"{a}={n}" for a, n in self.shape.items())
        local = [str(d) for d in self.distinct_devices]
        if self.spans_processes:
            n = int(sum(d is not None for d in self.devices.flat))
            return (f"Mesh({axes}; {n} of {self.devices.size} ranks in this "
                    f"process on {local})")
        return f"Mesh({axes}; {local})"


def check_one_process(where, what: str) -> None:
    """Refuse ``what`` over ranks that span processes (``where``: a mesh,
    or a list of devices or of device lists): only the tensor-parallel
    serving path runs across processes (the reference's multi-host
    proof)."""
    if where is None:
        return
    devs = where.devices if isinstance(where, Mesh) else np.asarray(
        where, dtype=object)
    if any(d is None for d in devs.flat):
        raise MeshPlanError(
            f"{what} does not run over ranks that span processes "
            f"({where!r}): across processes only tensor-parallel serving "
            "runs (prefill, decode, the engines)")


def first_device(devs: Sequence) -> torch.device:
    """The first device of ``devs`` that this process holds."""
    for d in devs:
        if d is not None:
            return d
    raise MeshPlanError("this process holds none of the ranks")


def rank_map(fn, devs: Sequence, *per_rank: Sequence) -> list:
    """``fn(r, devs[r], *(x[r] for x in per_rank))`` for each rank ``r``
    this process holds, in rank order; ``None`` at every other process's
    ranks.  The per-rank loops of the model code run through it, so a
    process computes only its own ranks."""
    return [None if d is None else fn(r, d, *(x[r] for x in per_rank))
            for r, d in enumerate(devs)]


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
    devices = [None if d is None else torch.device(d) for d in devices]
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


def process_mesh(local_devices: Sequence) -> Mesh:
    """The global mesh of the ``torch.distributed`` process group (joined
    first: ``runtime/multihost.py``), every rank on "tp" (dp = pp = 1
    across processes): every process gives its own ``local_devices`` (a
    device may repeat), all processes as many, and the ranks go in process
    order, process ``p`` owning ranks ``p*k .. p*k+k-1``.  The other
    processes' ranks are ``None`` here."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise MeshPlanError("process_mesh needs a joined process group "
                            "(runtime/multihost.py "
                            "maybe_initialize_distributed)")
    local = [torch.device(d) for d in local_devices]
    world, me = dist.get_world_size(), dist.get_rank()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64))
    if any(int(c) != len(local) for c in counts):
        raise MeshPlanError(
            f"processes hold different numbers of ranks "
            f"{[int(c) for c in counts]}: every process gives as many")
    k = len(local)
    devices = [None] * (me * k) + local + [None] * ((world - me - 1) * k)
    return make_mesh(MeshPlan(tp=len(devices)), devices=devices)


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
        keeping ``dim`` and ``axis``; ``None`` stays at another process's
        ranks."""
        return Shards([None if xs[0] is None else fn(*xs)
                       for xs in zip(self, *others)], self.dim, self.axis)

    @property
    def first(self):
        """The first piece this process holds (rank 0's in one process)."""
        for t in self:
            if t is not None:
                return t
        raise MeshPlanError("this process holds none of the ranks")


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
            return Shards([None if d is None
                           else layout(_owned(p.to(d).contiguous()))
                           for p, d in zip(torch.chunk(x, n, dim=dim), devs)],
                          dim)
        rest = NamedSharding(mesh, tuple(None if a == axis else a
                                         for a in spec))
        return Shards([place(p, rest, layout, **{**at, axis: i})
                       for i, p in enumerate(torch.chunk(x, n, dim=dim))],
                      dim, axis)
    return layout(_owned(x.to(first_device(mesh.axis_devices("tp", **at)))))


def _first(x):
    return _first(x.first) if isinstance(x, Shards) else x


def unshard(x, device=None) -> torch.Tensor:
    """The global tensor of ``x`` on ``device`` (its first piece's by
    default), nested :class:`Shards` included; a plain tensor is returned as
    it is (moved to ``device`` when given).  Pieces other processes hold
    are gathered from them (a collective: every process calls it)."""
    if not isinstance(x, Shards):
        return x if device is None else x.to(device)
    device = _first(x).device if device is None else device
    if x.dim is None:
        return unshard(x.first, device)
    parts = [None if p is None else unshard(p, device) for p in x]
    return torch.cat([p.to(device) for p in _exchange(parts)], dim=x.dim)


# ----------------------------------------------------------------------
# the transport between processes
# ----------------------------------------------------------------------

_STATS = {"calls": 0, "bytes": 0, "host_s": 0.0, "device_ms": 0.0}
_PENDING: list = []  # (start, end) CUDA events not yet added up


def _fold_events(wait: bool = False) -> None:
    """Add the elapsed time of finished event pairs to ``device_ms``."""
    keep = []
    for a, b in _PENDING:
        if wait:
            b.synchronize()
        if b.query():
            _STATS["device_ms"] += a.elapsed_time(b)
        else:
            keep.append((a, b))
    _PENDING[:] = keep


def transport_stats() -> dict:
    """What :func:`_exchange` moved between processes since the last reset:
    ``calls``, ``bytes`` sent by this process, ``host_s`` (host clock around
    each exchange; its copy out first waits for the device's earlier work)
    and ``device_ms`` (CUDA events on the stream around each exchange on
    the card, from the copy out to the copy back: the stream waits for the
    exchange in between)."""
    _fold_events(wait=True)
    return dict(_STATS)


def reset_transport_stats() -> None:
    _fold_events(wait=True)
    _STATS.update(calls=0, bytes=0, host_s=0.0, device_ms=0.0)
    _PENDING.clear()


def _exchange(parts: Sequence) -> list:
    """Every rank's tensor of ``parts`` (this process's ranks given, ``None``
    at the others'), in rank order: the local ones as they are, each other
    one received from its process, on the first local tensor's device.
    All ranks' tensors share a shape and dtype.  The bytes go as they are
    through host memory over the default process group (``all_gather`` of
    every process's stacked ranks; gloo), so nothing is rounded on the way.
    A list with no ``None`` is returned as it is (one process)."""
    if all(p is not None for p in parts):
        return list(parts)
    import torch.distributed as dist

    mine = [(r, p) for r, p in enumerate(parts) if p is not None]
    world, me, k = dist.get_world_size(), dist.get_rank(), len(mine)
    if len(parts) != world * k or [r for r, _ in mine] != list(
            range(me * k, me * k + k)):
        raise MeshPlanError(
            f"process {me} of {world} holds ranks {[r for r, _ in mine]} "
            f"of {len(parts)}: a collective spans every process, k ranks "
            "each, in process order")
    first = mine[0][1]
    shape, dtype, dev = first.shape, first.dtype, first.device
    out = list(parts)
    cuda = dev.type == "cuda"
    if cuda:
        _fold_events()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    send = torch.stack([p.to("cpu") for _, p in mine]).reshape(-1).view(
        torch.uint8)
    bufs = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(bufs, send)
    for q in range(world):
        if q == me:
            continue
        got = bufs[q].view(dtype).reshape(k, *shape).to(dev)
        for j in range(k):
            out[q * k + j] = got[j]
    if cuda:
        end.record()
        _PENDING.append((start, end))
    _STATS["host_s"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += send.numel()
    return out


# ----------------------------------------------------------------------
# collectives over one axis (a Shards' ranks, in order)
# ----------------------------------------------------------------------

def _sum_f32(parts: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """The partials summed in float32 on rank 0's device (the first local
    device where other processes hold ranks), in rank order, cast to
    ``dtype`` (the partials' by default)."""
    full = _exchange(parts)
    dev0 = full[0].device
    total = full[0].float()
    for p in full[1:]:
        total = total + p.to(dev0).float()
    return total.to(full[0].dtype if dtype is None else dtype)


def psum(parts: Sequence[torch.Tensor], dtype=None) -> Shards:
    """The sum of every rank's partial, in float32 on rank 0's device, in
    rank order, cast to ``dtype`` (the partials' by default) and copied back
    to each rank's device (``None`` at other processes' ranks: each process
    sums the gathered partials itself, in the same order)."""
    total = _sum_f32(parts, dtype)
    return Shards([None if p is None else total.to(p.device)
                   for p in parts], None)


def psum_scatter(parts: Sequence[torch.Tensor], dim: int,
                 dtype=None) -> list:
    """:func:`psum`'s sum (float32 on rank 0's device, in rank order, cast)
    split in ``len(parts)`` even pieces along ``dim``: rank ``r`` receives
    piece ``r`` on its own device."""
    pieces = torch.chunk(_sum_f32(parts, dtype), len(parts), dim=dim)
    if len(pieces) != len(parts):
        raise ValueError(f"psum_scatter: dim {dim} does not split in "
                         f"{len(parts)}")
    return [None if p is None else c.to(p.device)
            for c, p in zip(pieces, parts)]


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> Shards:
    """Every rank's piece concatenated along ``dim`` on rank 0's device (the
    first local one across processes), and copied back to each rank's
    device."""
    full = _exchange(parts)
    dev0 = full[0].device
    whole = torch.cat([p.to(dev0) for p in full], dim=dim)
    return Shards([None if p is None else whole.to(p.device)
                   for p in parts], None)


def ppermute(parts: Sequence[torch.Tensor]) -> list:
    """A ring shift by one: rank ``r`` receives rank ``r - 1``'s tensor
    (rank 0 the last rank's), on its own device."""
    n = len(parts)
    full = _exchange(parts)
    return [None if parts[r] is None else full[(r - 1) % n].to(parts[r].device)
            for r in range(n)]


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> list:
    """Each rank's tensor split in ``n`` even pieces along ``split_dim``;
    rank ``r`` receives piece ``r`` of every rank, concatenated in rank
    order along ``concat_dim``, on its own device."""
    n = len(parts)
    pieces = [torch.chunk(p, n, dim=split_dim) for p in _exchange(parts)]
    if any(len(ps) != n for ps in pieces):
        raise ValueError(f"all_to_all: dim {split_dim} does not split in {n}")
    return [None if parts[r] is None else
            torch.cat([pieces[s][r].to(parts[r].device) for s in range(n)],
                      dim=concat_dim) for r in range(n)]
