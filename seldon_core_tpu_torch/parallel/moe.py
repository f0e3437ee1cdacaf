"""Mixture of experts (port of ``seldon_core_tpu/parallel/moe.py``).

Capacity-based top-k routing in the reference's dense-dispatch form: the
dispatch and combine are einsums over one-hot ``disp``/``comb`` tensors of
shape ``[T, E, C]`` (plain XLA products in the reference, plain torch
here).  Routing is discrete and copied exactly:

- top-k over the float32 softmax of the router logits, the chosen
  probabilities renormalised (ties go to the lower expert index, as
  ``lax.top_k``);
- k-major priority: every token's first choice is placed before any
  token's second, in token order, through one cumsum;
- capacity ``max(int(cf * T * k / E), k)`` over all T tokens of the call;
- an assignment past its expert's capacity is dropped (its row of the
  dispatch is zero);
- the load-balancing aux loss ``(mean prob * top-1 share).sum() * E^2 / k``.

Under a mesh (:func:`moe_forward` with ``mesh=``) the experts are split over
"dp" and each expert's ``d_ff`` over "tp" (:func:`moe_param_specs`), as the
reference's sharding annotations ask: routing, dispatch and combine run
over every token of the call on one rank (the first), each expert group's
buffers go to its ranks (:func:`~.mesh.scatter`), each rank computes its
``d_ff`` share, the row-parallel partials meet in :func:`~.mesh.psum`
(float32, rank order), and each group's output goes back to the routing
rank (:func:`~.mesh.gather`).  Routing never splits per dp group: the
reference's GSPMD routes the global batch.  Over a mesh whose ranks span
processes the expert groups may lie in other processes; the moves cross
them, both ways under autograd.  With ``root=None`` every process holds
the tokens and routes them all (serving), and every process gets the
output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    RankViews,
    Ranks,
    Shards,
    gather,
    pspec,
    psum,
    rank_map,
    scatter,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_param_specs", "moe_capacity",
           "moe_route", "moe_forward", "moe_forward_dense_reference"]


@dataclass
class MoEConfig:
    n_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.5
    d_model: int = 128
    d_ff: int = 512
    # mesh axis the expert dimension is split over
    expert_axis: Optional[str] = "dp"


def init_moe_params(gen: torch.Generator, cfg: MoEConfig,
                    dtype=torch.float32, device=None) -> dict:
    """Router ``(D, E)``, ``w_in`` ``(E, D, F)``, ``w_out`` ``(E, F, D)``
    drawn from ``gen`` (a ``torch.Generator`` on ``device``) at the
    reference's scales; the draws cannot equal ``jax.random``'s."""
    device = gen.device if device is None else device
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype) * scale

    return {"router": normal((D, E), D ** -0.5),
            "w_in": normal((E, D, Fd), D ** -0.5),
            "w_out": normal((E, Fd, D), Fd ** -0.5)}


def moe_param_specs(cfg: MoEConfig) -> dict:
    """Placement specs: the expert dim over the expert axis, ``d_ff`` over
    "tp"; the router whole."""
    e = cfg.expert_axis
    return {"router": pspec(None, None),
            "w_in": pspec(e, None, "tp"),
            "w_out": pspec(e, "tp", None)}


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap, cfg.top_k)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, largest first; equal values in index
    order (a stable sort), as ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> dict:
    """The routing of ``x`` ``[T, D]``: ``probs`` [T, E] (float32),
    ``gate_vals``/``gate_idx`` [T, K], ``onehot`` [T, K, E] (int32),
    ``slot`` [T, K] (the assignment's place in its expert's buffer, k-major
    priority), ``kept`` [T, K] and ``capacity``."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    logits = x @ router.to(x.device, x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx, E).to(torch.int32)          # [T, K, E]
    flat = onehot.transpose(0, 1).reshape(K * T, E)          # k-major
    pos_flat = torch.cumsum(flat, dim=0) * flat - 1
    pos = pos_flat.reshape(K, T, E).transpose(0, 1)          # [T, K, E]
    slot = pos.amax(-1)
    kept = (slot >= 0) & (slot < C)
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "onehot": onehot, "slot": slot, "kept": kept, "capacity": C}


def _expert_ffn(xe, w_in, w_out):
    h = F.gelu(torch.einsum("ecd,edf->ecf", xe, w_in), approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out)


def _experts_on_mesh(xe, w_in, w_out, groups: list, dtype, n_experts: int,
                     root: Optional[int]):
    """The expert buffers ``xe`` [E, C, D] through experts split over the
    expert groups (``w_in``/``w_out``: one piece per group, each a
    :class:`Shards` over its group's tp ranks ``groups[g]``, a
    :class:`~.mesh.Ranks`): each group's buffers copied from rank ``root``
    (which holds ``xe``; ``None``: every process holds it) to its ranks,
    each rank its ``d_ff`` share, the partials summed in float32 in rank
    order, each group's sum back at ``root`` (``None``: in every
    process)."""
    if not (isinstance(w_in, Shards) and len(w_in) == len(groups)):
        raise ValueError("MoE weights on a mesh must be placed first "
                         "(moe_param_specs over the mesh's dp and tp)")
    mesh = groups[0].mesh
    n_e = n_experts // len(groups)
    ranks = Ranks.of(mesh, [i for g in groups for i in g.ids])
    bufs = scatter(xe, root, ranks, lambda xe: [
        (slice(g * n_e, (g + 1) * n_e),)
        for g, devs in enumerate(groups) for _ in devs])
    firsts, at = [], 0
    for g, devs in enumerate(groups):
        mine = bufs[at:at + len(devs)]
        at += len(devs)
        if not any(d is not None for d in devs):
            firsts.append(None)
            continue
        wi, wo = w_in[g], w_out[g]
        partials = rank_map(lambda r, dev, b: _expert_ffn(
            b.to(dev), wi[r].to(dev, dtype), wo[r].to(dev, dtype)),
            devs, mine)
        firsts.append(psum(partials, dtype, ranks=devs)[0])
    return gather(firsts, Ranks.of(mesh, [g.ids[0] for g in groups]), root,
                  lambda ps: torch.cat(ps, dim=0),
                  lambda y: list(torch.chunk(y, len(groups), dim=0)))


def moe_groups(mesh: Mesh, cfg: MoEConfig) -> list:
    """The tp devices of each expert group of ``mesh`` (its first pipeline
    stage's)."""
    axis = cfg.expert_axis
    n = mesh.axis_size(axis) if axis else 1
    return [mesh.axis_devices("tp", **({axis: g} if axis else {}))
            for g in range(n)]


_FIRST = object()  # moe_forward's default root: the groups' first rank


def moe_forward(params: dict, x: Optional[torch.Tensor], cfg: MoEConfig,
                mesh: Optional[Mesh] = None, groups: Optional[list] = None,
                root=_FIRST, dtype=None):
    """``x`` [T, D] (flattened tokens).  Returns ``(y [T, D] in x's dtype,
    aux float32 scalar)``.  Without a mesh the weights are tensors; with
    one they are placed by :func:`moe_param_specs` and the experts run on
    their ranks (``groups``, each expert group's tp devices, names them
    directly: a pipeline stage's, say; ``mesh`` gives :func:`moe_groups`
    of its first stage).

    ``root`` is the rank that holds ``x``, routes it and gets the output
    (by default the first rank of the groups in one process, and ``None``
    over a mesh that spans processes): every process calls the function,
    those other than ``root``'s with ``x=None`` and ``dtype`` (the tokens'
    dtype) and get ``(None, None)``.  ``root=None``: every process holds
    the same ``x``, routes it and gets the output (no gradient crosses
    processes)."""
    if mesh is None and groups is None:
        return _moe_tokens(params, x, cfg, None, None)
    if groups is None:
        groups = moe_groups(mesh, cfg)
    if root is _FIRST:
        root = None if groups[0].mesh.spans_processes else groups[0].ids[0]
    if x is None:  # another process routes: take part in the moves
        _experts_on_mesh(None, params["w_in"], params["w_out"], groups,
                         dtype, cfg.n_experts, root)
        return None, None
    return _moe_tokens(params, x, cfg, groups, root)


def _moe_tokens(params: dict, x: torch.Tensor, cfg: MoEConfig, groups,
                root):
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    router = params["router"]
    if isinstance(router, RankViews):  # the routing rank's view
        router = router.at(root)
    r = moe_route(x, router, cfg)
    C = r["capacity"]
    kept = r["kept"]
    # one-hot of the kept slots; a dropped one is an all-zero row (the
    # reference's one_hot of -1)
    slot_oh = F.one_hot(r["slot"].clamp(0, C - 1), C).to(dt) * kept[
        ..., None].to(dt)                                   # [T, K, C]
    onehot = r["onehot"].to(dt)
    disp = torch.einsum("tke,tkc->tec", onehot, slot_oh)
    comb = torch.einsum("tk,tke,tkc->tec", r["gate_vals"].to(dt), onehot,
                        slot_oh)
    xe = torch.einsum("tec,td->ecd", disp, x)                # [E, C, D]
    if groups is None:
        ye = _expert_ffn(xe, params["w_in"].to(x.device, dt),
                         params["w_out"].to(x.device, dt))
    else:
        ye = _experts_on_mesh(xe, params["w_in"], params["w_out"], groups,
                              dt, E, root).to(x.device)
    y = torch.einsum("tec,ecd->td", comb, ye)
    me = r["probs"].mean(0)
    ce = r["onehot"][:, 0, :].float().mean(0)  # top-1 assignment share
    aux = (me * ce).sum() * (E ** 2) / K
    return y.to(dt), aux


def moe_forward_dense_reference(params: dict, x: torch.Tensor,
                                cfg: MoEConfig) -> torch.Tensor:
    """Slow per-token version with no capacity drop (tests with a large
    capacity factor, where nothing is dropped)."""
    logits = x @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        he = F.gelu(x @ params["w_in"][e], approximate="tanh") @ \
            params["w_out"][e]
        w = torch.where(gate_idx == e, gate_vals, 0.0).sum(-1)
        y = y + w[:, None] * he.float()
    return y.to(x.dtype)
