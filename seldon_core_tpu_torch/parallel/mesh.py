"""Device meshes and their collectives (port of
``seldon_core_tpu/parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device``s with named axes, ``("dp",
"pp", "tp")`` as :func:`make_mesh` builds it.  ONE process drives every
device of it, as one controller drives a ``jax.sharding.Mesh``: the model
code runs each rank's share of a layer on that rank's device and meets the
other ranks only in the explicit collectives below.  A device may repeat:
``["cpu", "cpu"]`` is a 2-rank mesh on the CPU (the counterpart of the
reference's virtual CPU devices), and ``[cuda:0, cuda:0]`` two ranks on one
card, which run one after the other on its stream.  A rank is its index in
the flattened array (rank order is (dp, pp, tp) order); :class:`Ranks` is a
list of some ranks' devices that also names the ranks.

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

:func:`scatter` and :func:`gather` move a tensor that one rank holds (the
single controller's "first device") to other ranks' pieces, and back;
:func:`share` gives one rank's tensor to every process.  Under autograd
each of these is a ``torch.autograd.Function`` whose backward is the
transposed move, with the forward's rule: float32, summed in rank order
(a psum's transpose is a psum of the cotangents, an all-gather's the sum
and scatter, a ppermute's the reverse shift, an all-to-all's the inverse
all-to-all, a scatter's the gather and sum of the pieces' cotangents).
A copy to the device a tensor is already on is no copy (``Tensor.to``).

**A mesh over several processes** (multi-host, ``runtime/multihost.py``):
:func:`process_mesh` builds the global mesh of a ``torch.distributed``
process group, its ranks in process order as ``jax.devices()`` orders them
(process ``p`` of ``k`` local ranks owns ranks ``p*k .. p*k+k-1``),
reshaped to a :class:`MeshPlan`'s (dp, pp, tp), so any axis may cross the
boundary.  A rank that another process owns has no device here: ``None``
in ``devices`` (:attr:`Mesh.spans_processes`).  Every per-rank list (a
:class:`Shards` included) then holds ``None`` at those ranks, and
:func:`rank_map` runs a rank's work only where this process holds the
rank.  A placed piece that several ranks use (one the spec replicates over
an axis) lives in every process that holds one of them.  The collectives
keep their arithmetic: each first gathers every rank's tensor in its own
dtype (:func:`_exchange`, exact bytes staged through host memory over gloo,
one process group per set of processes that a mesh line or plane spans,
all made with the mesh), then every process computes what the single
controller computes (a sum in float32 in rank order) on its first local
device, for its own ranks; :func:`scatter` and :func:`gather` send the
pieces point to point.  So an answer does not depend on how the ranks fall
over processes.  Under autograd the moves between processes run their
backward in the reverse of their forward order in every process
(:func:`exchange_tape`: a token threads each move), and :func:`rank_views`
gives each rank its own view of a leaf several ranks use, so the leaf's
gradient is the sum of the ranks' in rank order, in one process and over
the processes that keep a copy, and every copy takes the same update.
:func:`check_one_process` refuses, by name, what stays in one process.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "AXIS_ORDER", "Mesh", "MeshPlan", "MeshPlanError", "NamedSharding",
    "RankViews", "Ranks", "Shards", "all_gather", "all_to_all",
    "check_one_process", "exchange_tape", "first_device", "gather",
    "leaf_items", "make_mesh", "named_sharding", "place", "plan_mesh",
    "ppermute", "process_mesh", "psum", "psum_scatter", "pspec", "rank_map",
    "rank_views", "replicas_agree", "reset_transport_stats", "scatter",
    "share", "single_axis_mesh", "transport_stats", "unshard",
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


class Ranks(list):
    """The devices of some ranks of ``mesh``, in order (``None`` at another
    process's ranks), that also name the ranks (``ids``): what a collective
    needs to know which processes take part."""

    def __init__(self, devs, ids, mesh: "Mesh"):
        super().__init__(devs)
        self.ids = tuple(int(i) for i in ids)
        self.mesh = mesh

    @classmethod
    def of(cls, mesh: "Mesh", ids) -> "Ranks":
        return cls([mesh.device_of(i) for i in ids], ids, mesh)


class Mesh:
    """``devices``: an array of ``torch.device`` with one dimension per name
    of ``axis_names``.  ``shape`` maps each axis to its size, in order.
    ``owners`` gives each rank's process (all 0 in one process; for a mesh
    given ``None`` entries without it, ``k`` ranks a process in order, ``k``
    the ranks given here) and ``me`` this process."""

    def __init__(self, devices, axis_names: Sequence[str] = AXIS_ORDER,
                 owners: Optional[Sequence[int]] = None,
                 me: Optional[int] = None):
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
        local = [i for i, d in enumerate(arr.flat) if d is not None]
        if owners is None:
            k = max(len(local), 1)
            spans = len(local) < arr.size
            owners = [i // k if spans else 0 for i in range(arr.size)]
            me = local[0] // k if spans and local else 0
        self.owners = tuple(int(o) for o in owners)
        self.me = int(me or 0)
        # gloo groups by the processes they join (process_mesh)
        self.process_groups: dict = {}

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def _index(self, axis: str, at: dict) -> tuple:
        return tuple(slice(None) if a == axis else int(at.get(a, 0))
                     for a in self.axis_names)

    def axis_devices(self, axis: str, **at) -> Ranks:
        """The devices along ``axis`` (a :class:`Ranks`), the other axes at
        the coordinates ``at`` (0 where not given); ``[first device]`` for
        an axis the mesh does not have."""
        idx = self._index(axis, at)
        ids = np.arange(self.devices.size).reshape(self.devices.shape)[idx]
        if axis not in self.axis_names:
            return Ranks([self.devices[idx]], [int(ids)], self)
        return Ranks(list(self.devices[idx]), list(ids), self)

    def device_of(self, rank: int):
        """Rank ``rank``'s device, ``None`` where another process owns it."""
        return self.devices.flat[rank]

    def owner(self, rank: int) -> int:
        return self.owners[rank]

    def matching(self, **at) -> list:
        """The ranks whose coordinates equal ``at`` on the axes it names
        (any on the others), in rank order."""
        grid = np.arange(self.devices.size).reshape(self.devices.shape)
        idx = tuple(int(at[a]) if a in at else slice(None)
                    for a in self.axis_names)
        return [int(r) for r in np.ravel(grid[idx])]

    def holder_device(self, **at):
        """Where this process keeps a piece the ranks :meth:`matching`
        ``at`` use: the device of its first such rank (all the free axes at
        0 in one process, where the single controller keeps it), ``None``
        when it holds none of them."""
        for r in self.matching(**at):
            if self.device_of(r) is not None:
                return self.device_of(r)
        return None

    def holders(self, **at) -> tuple:
        """The processes that keep a piece the ranks matching ``at`` use."""
        return tuple(sorted({self.owner(r) for r in self.matching(**at)}))

    def process_group(self, procs: tuple):
        """The gloo group of the processes ``procs`` (``None``: the whole
        process group); every group a line or plane of the mesh spans is
        made with the mesh (:func:`process_mesh`)."""
        if len(procs) == len(set(self.owners)):
            return None
        try:
            return self.process_groups[tuple(procs)]
        except KeyError:
            raise MeshPlanError(
                f"no process group for processes {procs} of {self!r}: "
                "a collective's ranks must lie on one line or plane of the "
                "mesh") from None

    @property
    def first_local_device(self):
        return first_device(list(self.devices.flat))

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
        return len(set(self.owners))

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
    or a list of devices or of device lists): the placement plane's
    sharded segments stay in one process (the model's serving and training
    paths run across processes)."""
    if where is None:
        return
    devs = where.devices if isinstance(where, Mesh) else np.asarray(
        where, dtype=object)
    if any(d is None for d in devs.flat):
        raise MeshPlanError(
            f"{what} does not run over ranks that span processes "
            f"({where!r}): across processes the model's serving and "
            "training paths run (prefill, decode, the engines, forward, "
            "lm_loss, make_train_step)")


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


def process_mesh(local_devices: Sequence,
                 plan: Optional[MeshPlan] = None) -> Mesh:
    """The global mesh of the ``torch.distributed`` process group (joined
    first: ``runtime/multihost.py``): every process gives its own
    ``local_devices`` (a device may repeat), all processes as many, and the
    ranks go in process order, process ``p`` owning ranks ``p*k ..
    p*k+k-1``, reshaped to ``plan``'s (dp, pp, tp) as ``jax.devices()``
    would be (by default every rank on "tp").  The other processes' ranks
    are ``None`` here.  Every process makes, in the same order, one gloo
    group for each set of two or more (not all) processes that a line or a
    plane of the mesh spans; the collectives over that line or plane, and
    the gradient sums of a piece its ranks share, run in it."""
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
    n = world * k
    plan = MeshPlan(tp=n) if plan is None else plan
    if plan.n_devices != n:
        raise MeshPlanError(f"plan {plan} wants {plan.n_devices} ranks, the "
                            f"processes hold {n} ({world} x {k})")
    devices = [None] * (me * k) + local + [None] * ((world - me - 1) * k)
    arr = np.empty((n,), dtype=object)
    arr[:] = devices
    mesh = Mesh(arr.reshape(plan.dp, plan.pp, plan.tp), AXIS_ORDER,
                owners=[r // k for r in range(n)], me=me)
    for procs in _spanned_process_sets(mesh):
        mesh.process_groups[procs] = dist.new_group(list(procs),
                                                    backend="gloo")
    return mesh


def _spanned_process_sets(mesh: Mesh) -> list:
    """The sets of two or more, but not all, processes that a line (one
    axis) or a plane (two axes) of ``mesh`` spans, sorted."""
    grid = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    nd, world = grid.ndim, len(set(mesh.owners))
    sets = set()
    for free in [(a,) for a in range(nd)] + [
            (a, b) for a in range(nd) for b in range(a + 1, nd)]:
        rest = [a for a in range(nd) if a not in free]
        moved = np.transpose(grid, rest + list(free))
        width = int(np.prod([grid.shape[a] for a in free]))
        for line in moved.reshape(-1, width):
            procs = tuple(sorted({mesh.owner(int(r)) for r in line}))
            if 1 < len(procs) < world:
                sets.add(procs)
    return sorted(sets)


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
    its coordinate; a piece the spec leaves whole over the other axes goes
    to :meth:`Mesh.holder_device` of its coordinates (one process: the
    first rank with the other axes at 0; across processes: every process
    that holds a rank using it keeps a copy, ``None`` elsewhere).
    ``layout`` (a function of a tensor) is applied to each piece, for
    example ``ops.quant.k_major``; ``at`` gives the coordinates of the axes
    placed so far.  Every piece owns its storage."""
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
            devs = [mesh.holder_device(**at, tp=t) for t in range(n)]
            return Shards([None if d is None
                           else layout(_owned(p.to(d).contiguous()))
                           for p, d in zip(torch.chunk(x, n, dim=dim), devs)],
                          dim)
        rest = NamedSharding(mesh, tuple(None if a == axis else a
                                         for a in spec))
        return Shards([place(p, rest, layout, **{**at, axis: i})
                       for i, p in enumerate(torch.chunk(x, n, dim=dim))],
                      dim, axis)
    d = mesh.holder_device(**at)
    return None if d is None else layout(_owned(x.to(d)))


def _first(x):
    return _first(x.first) if isinstance(x, Shards) else x


def unshard(x, device=None) -> torch.Tensor:
    """The global tensor of ``x`` on ``device`` (its first piece's by
    default), nested :class:`Shards` included; a plain tensor is returned as
    it is (moved to ``device`` when given).  Pieces other processes hold
    are gathered from them (a collective: every process calls it; the
    pieces must lie one a rank over the whole process group in process
    order, as a tensor-parallel serving mesh's do)."""
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
    """What moved between processes since the last reset (the
    collectives' exchanges and the point-to-point moves): ``calls``,
    ``bytes`` sent by this process, ``host_s`` (host clock around each; its
    copy out first waits for the device's earlier work) and ``device_ms``
    (CUDA events on the stream around each on the card, from the copy out
    to the copy back: the stream waits for the transfer in between)."""
    _fold_events(wait=True)
    return dict(_STATS)


def reset_transport_stats() -> None:
    _fold_events(wait=True)
    _STATS.update(calls=0, bytes=0, host_s=0.0, device_ms=0.0)
    _PENDING.clear()


@contextlib.contextmanager
def _timed(dev, nbytes_fn):
    """Account one transfer in :data:`_STATS` (``nbytes_fn()`` after it)."""
    cuda = dev is not None and torch.device(dev).type == "cuda"
    if cuda:
        _fold_events()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    yield
    if cuda:
        end.record()
        _PENDING.append((start, end))
    _STATS["host_s"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += nbytes_fn()


def _layout(parts: Sequence, ranks: Optional[Ranks]) -> tuple:
    """``(owner process of each position, this process, mesh or None)`` of
    a collective's parts: ``ranks`` names them; without it they are the
    whole process group's ranks in process order, ``k`` a process."""
    if ranks is not None:
        mesh = ranks.mesh
        return [mesh.owner(i) for i in ranks.ids], mesh.me, mesh
    import torch.distributed as dist

    mine = [r for r, p in enumerate(parts) if p is not None]
    world, me, k = dist.get_world_size(), dist.get_rank(), len(mine)
    if len(parts) != world * k or mine != list(range(me * k, me * k + k)):
        raise MeshPlanError(
            f"process {me} of {world} holds ranks {mine} of {len(parts)}: "
            "without its ranks named a collective spans every process, k "
            "ranks each, in process order")
    return [r // k for r in range(len(parts))], me, None


def _exchange(parts: Sequence, ranks: Optional[Ranks] = None) -> list:
    """Every rank's tensor of ``parts`` (this process's ranks given, ``None``
    at the others'), in rank order: the local ones as they are, each other
    one received from its process, on the first local tensor's device.
    All ranks' tensors share a shape and dtype, and every process taking
    part holds as many of them.  The bytes go as they are through host
    memory (``all_gather`` of every process's stacked ranks over the gloo
    group of the processes that own ``ranks``), so nothing is rounded on
    the way.  A list with no ``None`` is returned as it is (one process),
    and so is one with nothing here (this process takes no part)."""
    if all(p is not None for p in parts) or all(p is None for p in parts):
        return list(parts)
    import torch.distributed as dist

    owners, me, mesh = _layout(parts, ranks)
    procs = sorted(set(owners))
    mine = [j for j, o in enumerate(owners) if o == me]
    first = parts[mine[0]]
    shape, dtype, dev = first.shape, first.dtype, first.device
    group = None if mesh is None else mesh.process_group(tuple(procs))
    out = list(parts)
    send = None

    def nbytes():
        return 0 if send is None else send.numel()

    with _timed(dev, nbytes):
        send = torch.stack([parts[j].to("cpu") for j in mine]).reshape(
            -1).view(torch.uint8)
        bufs = [torch.empty_like(send) for _ in procs]
        dist.all_gather(bufs, send, group=group)
        for q, buf in zip(procs, bufs):
            if q == me:
                continue
            pos = [j for j, o in enumerate(owners) if o == q]
            got = buf.view(dtype).reshape(len(pos), *shape).to(dev)
            for i, j in enumerate(pos):
                out[j] = got[i]
    return out


#: the dtypes a point-to-point move can carry, by code
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


def _send(tensors: Sequence, to: int, works: list) -> int:
    """Post ``tensors`` (any shapes and dtypes) to process ``to``: a size
    pair, a header of dtype codes and shapes, then their bytes.  Appends
    the pending sends (and the buffers they read) to ``works``; returns the
    bytes sent."""
    import torch.distributed as dist

    cpu = [t.detach().to("cpu").contiguous() for t in tensors]
    head = [len(cpu)]
    for t in cpu:
        head += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    head = torch.tensor(head, dtype=torch.int64)
    body = (torch.cat([t.reshape(-1).view(torch.uint8) for t in cpu])
            if cpu else torch.zeros(0, dtype=torch.uint8))
    size = torch.tensor([head.numel(), body.numel()], dtype=torch.int64)
    msgs = [size, head] + ([body] if body.numel() else [])
    works.extend((dist.isend(m, to), m) for m in msgs)
    return body.numel()


def _recv(frm: int, device) -> list:
    """The tensors process ``frm`` posted with :func:`_send`, on
    ``device``."""
    import torch.distributed as dist

    size = torch.empty(2, dtype=torch.int64)
    dist.recv(size, frm)
    head = torch.empty(int(size[0]), dtype=torch.int64)
    dist.recv(head, frm)
    body = torch.empty(int(size[1]), dtype=torch.uint8)
    if body.numel():
        dist.recv(body, frm)
    head = head.tolist()
    out, i, off = [], 1, 0
    for _ in range(head[0]):
        dtype, nd = _DTYPES[head[i]], head[i + 1]
        shape = head[i + 2:i + 2 + nd]
        i += 2 + nd
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        out.append(body[off:off + n].clone().view(dtype).reshape(shape).to(
            device))
        off += n
    return out


def _post(sends: dict, recv_from: Sequence, device) -> dict:
    """Point-to-point moves: ``sends`` maps a process to the tensors it
    gets from this one; returns, for each process of ``recv_from`` (in
    that order), the tensors it posted here, on ``device``.  Sends are
    posted first and waited on last, so no order of the two deadlocks."""
    works, got = [], {}
    nbytes = [0]
    with _timed(device, lambda: nbytes[0]):
        for q in sorted(sends):
            nbytes[0] += _send(sends[q], q, works)
        for q in recv_from:
            got[q] = _recv(q, device)
        for w, _ in works:
            w.wait()
    return got


# ----------------------------------------------------------------------
# moves under autograd: each a Function whose backward is its transpose
# ----------------------------------------------------------------------

class _Tape:
    """The token of a differentiable forward over a mesh that spans
    processes: every move takes it and hands on a new one, so the moves'
    backwards run in the reverse of their forward order in every process
    (and a process whose loss does not reach a move still runs its
    backward, by the token)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.token = torch.zeros((), device=mesh.first_local_device,
                                 requires_grad=True)

    def close(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` tied to the token (plus an exact zero): a backward from
        ``t`` runs every move's backward."""
        return t + self.token.to(t.device) * 0.0


_TAPE: Optional[_Tape] = None


@contextlib.contextmanager
def exchange_tape(mesh: Optional[Mesh]):
    """Thread a token through every move between ranks inside the block,
    when ``mesh`` spans processes and autograd records (else yields
    ``None``).  Close the block's output with ``tape.close(out)`` before a
    backward from it."""
    global _TAPE
    if (mesh is None or not mesh.spans_processes
            or not torch.is_grad_enabled() or _TAPE is not None):
        yield None
        return
    _TAPE = _Tape(mesh)
    try:
        yield _TAPE
    finally:
        _TAPE = None


class _Op:
    """A move between ranks: ``fwd`` maps this process's inputs to its
    outputs (lists of tensors), ``bwd`` the outputs' cotangents to the
    inputs' gradients; either may exchange with other processes."""

    views_ok = False
    materialize = True  # the backward gets zeros for unused outputs

    def fwd(self, xs: list) -> list:
        raise NotImplementedError

    def bwd(self, gs: list) -> list:
        raise NotImplementedError


def _fresh(outs: list, xs: Sequence) -> list:
    """Outputs that are not an input, nor another output, as a Function
    must return them."""
    seen = [id(x) for x in xs]
    res = []
    for o in outs:
        if id(o) in seen:
            o = o.clone()
        seen.append(id(o))
        res.append(o)
    return res


class _OpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, token, *xs):
        ctx.set_materialize_grads(op.materialize)
        ctx.op = op
        ctx.tokened = token is not None
        ctx.token_device = None if token is None else token.device
        outs = op.fwd(list(xs))
        outs = outs if op.views_ok else _fresh(outs, xs)
        return (token.clone(), *outs) if ctx.tokened else tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        tok = None
        if ctx.tokened:
            tok, gs = torch.zeros((), device=ctx.token_device), gs[1:]
        return (None, tok, *ctx.op.bwd(list(gs)))


def _run(op: _Op, xs: list) -> list:
    """``op`` on this process's inputs: plain when autograd does not
    record it, else through :class:`_OpFn` (with the tape's token when one
    is open)."""
    tape = _TAPE
    if not torch.is_grad_enabled() or (
            tape is None and not any(x.requires_grad for x in xs)):
        return op.fwd(xs)
    if tape is None:
        out = _OpFn.apply(op, None, *xs)
        return list(out) if isinstance(out, tuple) else [out]
    out = list(_OpFn.apply(op, tape.token, *xs))
    tape.token = out.pop(0)
    return out


def _sum_f32(full: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """Every rank's tensor summed in float32 on rank 0's device, in rank
    order, cast to ``dtype`` (the tensors' by default)."""
    dev0 = full[0].device
    total = full[0].float()
    for p in full[1:]:
        total = total + p.to(dev0).float()
    return total.to(full[0].dtype if dtype is None else dtype)


class _Coll(_Op):
    """A collective over the ranks of ``parts`` (``ranks`` names them):
    every rank takes part with a tensor of one shape and dtype."""

    def __init__(self, kind: str, parts: Sequence, ranks, **kw):
        self.kind, self.ranks, self.kw = kind, ranks, kw
        self.n = len(parts)
        self.local = [j for j, p in enumerate(parts) if p is not None]
        self.devs = [parts[j].device for j in self.local]
        self.dtype = parts[self.local[0]].dtype

    def _full(self, xs: list) -> list:
        full = [None] * self.n
        for j, x in zip(self.local, xs):
            full[j] = x
        return _exchange(full, self.ranks)

    def fwd(self, xs):
        full, n, kw = self._full(xs), self.n, self.kw
        if self.kind == "psum":
            total = _sum_f32(full, kw["dtype"])
            return [total.to(d) for d in self.devs]
        if self.kind == "psum_scatter":
            pieces = torch.chunk(_sum_f32(full, kw["dtype"]), n, dim=kw["dim"])
            if len(pieces) != n:
                raise ValueError(f"psum_scatter: dim {kw['dim']} does not "
                                 f"split in {n}")
            return [pieces[j].to(d) for j, d in zip(self.local, self.devs)]
        if self.kind == "all_gather":
            dev0 = full[0].device
            whole = torch.cat([p.to(dev0) for p in full], dim=kw["dim"])
            return [whole.to(d) for d in self.devs]
        if self.kind == "ppermute":
            return [full[(j - 1) % n].to(d)
                    for j, d in zip(self.local, self.devs)]
        pieces = [torch.chunk(p, n, dim=kw["split_dim"]) for p in full]
        if any(len(ps) != n for ps in pieces):
            raise ValueError(f"all_to_all: dim {kw['split_dim']} does not "
                             f"split in {n}")
        return [torch.cat([pieces[s][j].to(d) for s in range(n)],
                          dim=kw["concat_dim"])
                for j, d in zip(self.local, self.devs)]

    def bwd(self, gs):
        full, n, kw = self._full(gs), self.n, self.kw
        if self.kind == "psum":
            g = _sum_f32(full, self.dtype)
            return [g.to(d) for d in self.devs]
        if self.kind == "psum_scatter":
            dev0 = full[0].device
            g = torch.cat([c.to(dev0) for c in full], dim=kw["dim"]).to(
                self.dtype)
            return [g.to(d) for d in self.devs]
        if self.kind == "all_gather":
            return [_sum_f32([torch.chunk(c, n, dim=kw["dim"])[j]
                              for c in full], self.dtype).to(d)
                    for j, d in zip(self.local, self.devs)]
        if self.kind == "ppermute":
            return [full[(j + 1) % n].to(d)
                    for j, d in zip(self.local, self.devs)]
        pieces = [torch.chunk(c, n, dim=kw["concat_dim"]) for c in full]
        return [torch.cat([pieces[r][j].to(d) for r in range(n)],
                          dim=kw["split_dim"])
                for j, d in zip(self.local, self.devs)]


def _collective(kind: str, parts: Sequence, ranks, **kw) -> list:
    """Run a :class:`_Coll`; its outputs back at their ranks (``None`` at
    other processes' ranks, and everywhere when this process holds none of
    them)."""
    if all(p is None for p in parts):
        return list(parts)
    op = _Coll(kind, parts, ranks, **kw)
    out = [None] * len(parts)
    for j, y in zip(op.local, _run(op, [parts[j] for j in op.local])):
        out[j] = y
    return out


# ----------------------------------------------------------------------
# collectives over one axis (a Shards' ranks, in order)
# ----------------------------------------------------------------------

def psum(parts: Sequence[torch.Tensor], dtype=None,
         ranks: Optional[Ranks] = None) -> Shards:
    """The sum of every rank's partial, in float32 on rank 0's device, in
    rank order, cast to ``dtype`` (the partials' by default) and copied back
    to each rank's device (``None`` at other processes' ranks: each process
    sums the gathered partials itself, in the same order).  ``ranks``
    names the parts' ranks (a :class:`Ranks`, as ``Mesh.axis_devices``
    gives it); without it they are the whole process group's."""
    return Shards(_collective("psum", parts, ranks, dtype=dtype), None)


def psum_scatter(parts: Sequence[torch.Tensor], dim: int, dtype=None,
                 ranks: Optional[Ranks] = None) -> list:
    """:func:`psum`'s sum (float32 on rank 0's device, in rank order, cast)
    split in ``len(parts)`` even pieces along ``dim``: rank ``r`` receives
    piece ``r`` on its own device."""
    return _collective("psum_scatter", parts, ranks, dim=dim, dtype=dtype)


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               ranks: Optional[Ranks] = None) -> Shards:
    """Every rank's piece concatenated along ``dim`` on rank 0's device (the
    first local one across processes), and copied back to each rank's
    device."""
    return Shards(_collective("all_gather", parts, ranks, dim=dim), None)


def ppermute(parts: Sequence[torch.Tensor],
             ranks: Optional[Ranks] = None) -> list:
    """A ring shift by one: rank ``r`` receives rank ``r - 1``'s tensor
    (rank 0 the last rank's), on its own device."""
    return _collective("ppermute", parts, ranks)


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int, ranks: Optional[Ranks] = None) -> list:
    """Each rank's tensor split in ``n`` even pieces along ``split_dim``;
    rank ``r`` receives piece ``r`` of every rank, concatenated in rank
    order along ``concat_dim``, on its own device."""
    return _collective("all_to_all", parts, ranks, split_dim=split_dim,
                       concat_dim=concat_dim)


# ----------------------------------------------------------------------
# moves to and from one rank
# ----------------------------------------------------------------------

class _Scatter(_Op):
    """Rank ``src``'s tensor to pieces at the ranks ``dst``: piece ``j`` is
    ``x[index(x)[j]]`` (a slice, or the whole tensor: a copy).  The
    transpose adds every piece's cotangent into a float32 zero tensor at
    ``src``, in the order of ``dst``, and casts it."""

    def __init__(self, mesh: Mesh, src: int, dst: Sequence[int], index):
        self.mesh, self.src, self.dst, self.index = mesh, src, list(dst), index
        self.at_src = mesh.owner(src) == mesh.me
        self.local = [j for j, d in enumerate(self.dst)
                      if mesh.owner(d) == mesh.me]

    def fwd(self, xs):
        m = self.mesh
        if self.at_src:
            x = xs[0]
            self.idx = self.index(x)
            self.meta = (x.shape, x.dtype, x.device)
            sends = {}
            for j, d in enumerate(self.dst):
                if m.owner(d) != m.me:
                    sends.setdefault(m.owner(d), []).append(x[self.idx[j]])
            if sends:
                _post(sends, [], x.device)
            return [x[self.idx[j]].to(m.device_of(self.dst[j]))
                    for j in self.local]
        got = _post({}, [m.owner(self.src)], m.first_local_device)
        return [g.to(m.device_of(self.dst[j]))
                for j, g in zip(self.local, got[m.owner(self.src)])]

    def bwd(self, gs):
        m = self.mesh
        if not self.at_src:
            _post({m.owner(self.src): gs}, [], gs[0].device)
            return []
        shape, dtype, dev = self.meta
        full = [None] * len(self.dst)
        for j, g in zip(self.local, gs):
            full[j] = g
        others = sorted({m.owner(d) for d in self.dst} - {m.me})
        got = _post({}, others, dev)
        for q in others:
            for j, g in zip([j for j, d in enumerate(self.dst)
                             if m.owner(d) == q], got[q]):
                full[j] = g
        acc = torch.zeros(shape, dtype=torch.float32, device=dev)
        for j, g in enumerate(full):
            acc[self.idx[j]] += g.to(dev).float()
        return [acc.to(dtype)]


class _Gather(_Op):
    """The pieces at the ranks ``src`` to ``combine(pieces)`` at rank
    ``dst`` (every piece moved to its device first); the transpose hands
    each piece its part of the cotangent, ``split(cotangent)[j]``."""

    def __init__(self, mesh: Mesh, src: Sequence[int], dst: int, combine,
                 split):
        self.mesh, self.src, self.dst = mesh, list(src), dst
        self.combine, self.split = combine, split
        self.at_dst = mesh.owner(dst) == mesh.me
        self.local = [j for j, s in enumerate(self.src)
                      if mesh.owner(s) == mesh.me]

    def fwd(self, xs):
        m = self.mesh
        self.meta = [(x.dtype, x.device) for x in xs]
        if not self.at_dst:
            _post({m.owner(self.dst): xs}, [], xs[0].device)
            return []
        dev = m.device_of(self.dst)
        full = [None] * len(self.src)
        for j, x in zip(self.local, xs):
            full[j] = x
        others = sorted({m.owner(s) for s in self.src} - {m.me})
        got = _post({}, others, dev)
        for q in others:
            for j, x in zip([j for j, s in enumerate(self.src)
                             if m.owner(s) == q], got[q]):
                full[j] = x
        return [self.combine([p.to(dev) for p in full])]

    def bwd(self, gs):
        m = self.mesh
        if self.at_dst:
            cots = self.split(gs[0])
            sends = {}
            for j, s in enumerate(self.src):
                if m.owner(s) != m.me:
                    sends.setdefault(m.owner(s), []).append(cots[j])
            if sends:
                _post(sends, [], gs[0].device)
            mine = [cots[j] for j in self.local]
        elif self.local:
            q = m.owner(self.dst)
            mine = _post({}, [q], m.first_local_device)[q]
        else:
            return []
        return [c.to(dev, dt) for c, (dt, dev) in zip(mine, self.meta)]


class _Share(_Op):
    """Rank ``src``'s tensor to every process of the mesh (on its first
    local device).  Each process's copy answers for itself: the transpose
    hands ``src`` its own copy's cotangent (a loss every process computes
    from the copy backpropagates once, from ``src``)."""

    def __init__(self, mesh: Mesh, src: int):
        self.mesh, self.src = mesh, src
        self.at_src = mesh.owner(src) == mesh.me

    def fwd(self, xs):
        m = self.mesh
        others = sorted(set(m.owners) - {m.owner(self.src)})
        if self.at_src:
            _post({q: xs for q in others}, [], xs[0].device)
            return [xs[0]]
        q = m.owner(self.src)
        return _post({}, [q], m.first_local_device)[q]

    def bwd(self, gs):
        return [gs[0]] if self.at_src else []


def _participates(mesh: Mesh, ranks: Sequence[int]) -> bool:
    return any(mesh.owner(r) == mesh.me for r in ranks)


def scatter(x: Optional[torch.Tensor], src: Optional[int],
            dst: Ranks, index: Callable) -> list:
    """Pieces of ``x`` at the ranks ``dst``: rank ``dst.ids[j]`` receives
    ``x[index(x)[j]]`` (an index tuple per rank: a slice of ``x``, or all of
    it for a copy) on its device, ``None`` at other processes' ranks.

    ``src`` is the rank that holds ``x`` (other processes pass ``None``
    for ``x``): its process sends every other process its ranks' pieces.
    Under autograd the gradient of ``x`` is the pieces' cotangents added at
    ``src`` in float32, in the order of ``dst``.  ``src=None``: every
    process holds ``x`` (the same values) and takes its own ranks' pieces,
    plain torch (no gradient crosses processes)."""
    mesh = dst.mesh
    out = [None] * len(dst)
    if src is None or not mesh.spans_processes and not (
            torch.is_grad_enabled() and x.requires_grad):
        if not any(d is not None for d in dst):
            return out
        idx = index(x)
        return [None if d is None else x[idx[j]].to(d)
                for j, d in enumerate(dst)]
    if not _participates(mesh, [src, *dst.ids]):
        return out
    op = _Scatter(mesh, src, dst.ids, index)
    for j, y in zip(op.local, _run(op, [x] if op.at_src else [])):
        out[j] = y
    return out


def gather(parts: Sequence, src: Ranks, dst: Optional[int],
           combine: Callable, split: Callable):
    """``combine(pieces)`` of the pieces at the ranks ``src`` (``parts``:
    this process's, ``None`` at the others'), at rank ``dst`` (``None`` in
    every other process).  ``split`` is ``combine``'s inverse (the
    cotangent's part for each piece), for the backward.  ``dst=None``:
    every process gets the result, plain torch (the piece of a rank goes
    from that rank's process; no gradient crosses processes)."""
    mesh = src.mesh
    if dst is None:
        return _gather_everywhere(parts, src, combine)
    if not mesh.spans_processes and not (torch.is_grad_enabled() and any(
            p.requires_grad for p in parts)):
        dev = mesh.device_of(dst)
        return combine([p.to(dev) for p in parts])
    if not _participates(mesh, [dst, *src.ids]):
        return None
    op = _Gather(mesh, src.ids, dst, combine, split)
    out = _run(op, [parts[j] for j in op.local])
    return out[0] if op.at_dst else None


def _gather_everywhere(parts: Sequence, src: Ranks, combine: Callable):
    mesh = src.mesh
    dev = mesh.first_local_device
    if not mesh.spans_processes:
        return combine([p.to(dev) for p in parts])
    full = list(parts)
    mine = [parts[j] for j, s in enumerate(src.ids)
            if mesh.owner(s) == mesh.me]
    others = sorted(set(mesh.owners) - {mesh.me})
    senders = sorted({mesh.owner(s) for s in src.ids} - {mesh.me})
    got = _post({q: mine for q in others} if mine else {}, senders, dev)
    for q in senders:
        for j, x in zip([j for j, s in enumerate(src.ids)
                         if mesh.owner(s) == q], got[q]):
            full[j] = x
    return combine([p.to(dev) for p in full])


def share(x: Optional[torch.Tensor], src: int, mesh: Mesh):
    """Rank ``src``'s ``x`` in every process (its first local device; the
    tensor itself at ``src``).  Under autograd only ``src``'s copy carries
    a gradient back: a value every process derives the same loss from
    backpropagates once."""
    if not mesh.spans_processes:
        return x
    return _run(_Share(mesh, src), [x] if mesh.owner(src) == mesh.me
                else [])[0]


# ----------------------------------------------------------------------
# leaves that several processes keep
# ----------------------------------------------------------------------

def _tree_map(node, fn, coords: tuple = ()):
    """``fn(leaf, coords)`` for every leaf of a placed tree (``None`` at a
    piece this process does not keep), in a fixed order; ``coords`` are the
    mesh coordinates the :class:`Shards` around it name."""
    if isinstance(node, dict):
        return {k: _tree_map(v, fn, coords) for k, v in node.items()}
    if isinstance(node, Shards):
        return Shards([_tree_map(c, fn, coords + ((node.axis, i),))
                       for i, c in enumerate(node)], node.dim, node.axis)
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(c, fn, coords) for c in node)
    return fn(node, dict(coords))


def leaf_items(tree, prefix: str = "") -> list:
    """``(key, tensor)`` for every leaf of a placed tree this process keeps,
    in a fixed order; the key is the leaf's path and the coordinates of its
    piece (``blocks/wq@pp1@tp0``), the same in every process and in one
    process (to compare pieces across them)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, Shards):
            for i, c in enumerate(node):
                walk(c, f"{path}@{node.axis}{i}")
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, f"{path}#{i}")
        elif node is not None:
            out.append((path, node))

    walk(tree, prefix)
    return out


def _shared_leaves(tree, mesh: Mesh) -> list:
    """``(processes, [leaves])`` for each set of two or more processes
    that keep copies of some placed leaves (the processes owning a rank at
    the leaf's coordinates), sorted, with this process's leaves of the set
    in tree order."""
    sets: dict = {}

    def visit(leaf, coords):
        if isinstance(leaf, torch.Tensor) or leaf is None:
            procs = mesh.holders(**coords)
            if len(procs) > 1 and mesh.me in procs:
                if leaf is None:
                    raise MeshPlanError(f"a piece at {coords} is missing "
                                        "here: place it over this mesh")
                sets.setdefault(procs, []).append(leaf)
        return leaf

    _tree_map(tree, visit)
    return sorted(sets.items())


class RankViews:
    """A placed leaf that several ranks use, seen through one view per rank
    of this process that may use it (:func:`rank_views`): rank ``r``'s
    uses read ``at(r)``, so its gradient reaches the leaf apart from every
    other rank's."""

    def __init__(self, views: dict):
        self.views = views

    def at(self, rank: int) -> torch.Tensor:
        return self.views[rank]

    def map(self, fn) -> "RankViews":
        return RankViews({r: fn(t) for r, t in self.views.items()})


class _LeafViews(_Op):
    """Per-rank views of the leaves one set of processes keeps (``ranks``:
    each leaf's ranks, those matching its coordinates); the transpose sums
    every rank's gradient of a leaf in float32, in rank order (across the
    set's processes by one exchange), and casts it."""

    views_ok = True
    materialize = False

    def __init__(self, mesh: Mesh, procs: tuple, ranks: list):
        self.mesh, self.procs, self.ranks = mesh, procs, ranks

    def _mine(self, i: int, q: int) -> list:
        return [r for r in self.ranks[i] if self.mesh.owner(r) == q]

    def fwd(self, xs):
        self.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return [x.view_as(x) for i, x in enumerate(xs)
                for _ in self._mine(i, self.mesh.me)]

    def bwd(self, gs):
        m = self.mesh
        cots: dict = {}  # (leaf, rank) -> cotangent or None
        it = iter(gs)
        for i in range(len(self.meta)):
            for r in self._mine(i, m.me):
                cots[(i, r)] = next(it)
        if len(self.procs) > 1:
            def size(q):
                return sum(len(self._mine(i, q)) * int(np.prod(shape))
                           for i, (shape, _, _) in enumerate(self.meta))

            width = max(size(q) for q in self.procs)
            dev = self.meta[0][2]
            flat = torch.zeros(width, dtype=torch.float32, device=dev)
            off = 0
            for i, (shape, _, _) in enumerate(self.meta):
                n = int(np.prod(shape))
                for r in self._mine(i, m.me):
                    g = cots[(i, r)]
                    if g is not None:
                        flat[off:off + n] = g.reshape(-1).float()
                    off += n
            firsts = [m.owners.index(q) for q in self.procs]
            parts = [flat if q == m.me else None for q in self.procs]
            full = _exchange(parts, Ranks([None] * len(firsts), firsts, m))
            for q, buf in zip(self.procs, full):
                if q == m.me:
                    continue
                off = 0
                for i, (shape, _, _) in enumerate(self.meta):
                    n = int(np.prod(shape))
                    for r in self._mine(i, q):
                        cots[(i, r)] = buf[off:off + n].reshape(shape)
                        off += n
        out = []
        for i, (shape, dtype, dev) in enumerate(self.meta):
            total = torch.zeros(shape, dtype=torch.float32, device=dev)
            for r in self.ranks[i]:
                g = cots.get((i, r))
                if g is not None:
                    total = total + g.to(dev).float()
            out.append(total.to(dtype))
        return out


def rank_views(tree, mesh: Optional[Mesh]):
    """``tree`` with each leaf that several ranks may use (every rank at its
    coordinates, :meth:`Mesh.matching`) replaced, under autograd, by its
    :class:`RankViews` for this process's ranks: in the backward each
    leaf's gradient is the sum of every rank's, in float32, in rank order
    (across the processes that keep the leaf, by one exchange per set of
    them), the same sum in one process and in several, so every copy of
    the leaf takes the same update.  Without autograd, ``tree`` as it
    is."""
    if mesh is None or not torch.is_grad_enabled():
        return tree
    sets: dict = {}

    def visit(leaf, coords):
        if isinstance(leaf, torch.Tensor):
            ranks = mesh.matching(**coords)
            if len(ranks) > 1:
                sets.setdefault(mesh.holders(**coords), []).append(
                    (leaf, ranks))
        return leaf

    _tree_map(tree, visit)
    views = {}
    for procs, items in sorted(sets.items()):
        op = _LeafViews(mesh, procs, [r for _, r in items])
        out = iter(_run(op, [leaf for leaf, _ in items]))
        for i, (leaf, _) in enumerate(items):
            views[id(leaf)] = RankViews({r: next(out)
                                         for r in op._mine(i, mesh.me)})
    return _tree_map(tree, lambda t, c: views.get(id(t), t))


def replicas_agree(tree, mesh: Mesh) -> dict:
    """Whether every leaf that several processes keep is bitwise the same
    in each of them: ``{"leaves", "sets", "equal"}`` (this process's shared
    leaves, the sets of processes, all equal).  A collective over those
    sets."""
    n, equal, sets = 0, True, _shared_leaves(tree, mesh)
    for procs, leaves in sets:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(
            torch.uint8).cpu() for t in leaves])
        ids = mesh.matching()
        parts = [None] * len(procs)
        parts[procs.index(mesh.me)] = flat
        ranks = Ranks([None] * len(procs),
                      [ids[mesh.owners.index(q)] for q in procs], mesh)
        full = _exchange(parts, ranks)
        equal = equal and all(torch.equal(f, flat) for f in full)
        n += len(leaves)
    return {"leaves": n, "sets": len(sets), "equal": bool(equal)}
