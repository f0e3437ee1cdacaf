"""Ring attention and dense attention (port of
``seldon_core_tpu/parallel/ring_attention.py``).

Ring attention is exact attention over a sequence split across the ranks
of a mesh axis: each rank keeps its queries' shard and the K/V blocks
rotate around the ring (:func:`~.mesh.ppermute`) while every rank
accumulates its queries' attention with an online softmax.  One process
drives every rank (``parallel/mesh.py``), so a ring step runs each rank's
update in turn, then rotates; over a mesh that spans processes each process
updates its own ranks (``None`` at the others') and the rotation crosses
processes, both ways under autograd (the transpose of a shift is the
shift back).  Accumulation is in float32 whatever the input dtype; masked
keys contribute exactly zero.  Plain torch, as the reference's is plain
XLA, so autograd gives the ring's gradient.

:func:`dense_attention` is the plain version of the flash kernel and the
non-flash prefill path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    Ranks,
    Shards,
    gather,
    ppermute,
)

__all__ = ["dense_attention", "ring_attention", "ring_attention_sharded",
           "NEG_INF"]

NEG_INF = -1e30


def _block_scores(q, k, q_off: int, k_off: int, causal: bool, scale: float):
    """Scaled scores ``(B, H, Lq, Lk)`` of a query block at global offset
    ``q_off`` against a key block at ``k_off``, and the causal mask (None
    when not causal)."""
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    if not causal:
        return s, None
    q_pos = q_off + torch.arange(q.shape[1], device=q.device)
    k_pos = k_off + torch.arange(k.shape[1], device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    return torch.where(mask, s, NEG_INF), mask


def _rep(kv, n_rep: int):
    """GQA: K/V to the full query-head count in float32, per step."""
    kv = kv.float()
    return kv if n_rep == 1 else kv.repeat_interleave(n_rep, dim=2)


def _online_update(o, l, m, s, mask, vf):
    """One online-softmax step over scores ``s`` (B, H, Lq, Lk)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        # rows with no valid key yet keep m at NEG_INF, where exp(0) = 1
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None].transpose(1, 2) + torch.einsum(
        "bhlm,bmhd->blhd", p, vf)
    return o, l, m_new


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor], causal: bool = True,
                   scale: Optional[float] = None,
                   kv_chunk: Optional[int] = None, n_rep: int = 1,
                   ranks: Optional[Ranks] = None) -> Shards:
    """Attention over a sequence split in order over ``len(q)`` ranks:
    ``q[r]``, ``k[r]``, ``v[r]`` are rank ``r``'s shard ``(B, L_local, H,
    D)`` on its device.  Returns the output shards (a :class:`Shards` on
    dim 1) in ``q``'s dtype.

    ``kv_chunk`` bounds the score tile: each ring step then takes the K/V
    block it holds in chunks of that many keys, with the same online
    softmax, so a step holds at most ``(B, H, Lq, kv_chunk)`` scores.  It
    must divide the local length; the result does not depend on it.

    ``n_rep`` (GQA): ``k``/``v`` carry ``H / n_rep`` heads; they rotate at
    that size and are broadcast to the full head count per step or
    chunk.  ``ranks`` names the shards' ranks (``parallel/mesh.py``
    ``ppermute``)."""
    n = len(q)
    if all(x is None for x in q):  # none of the ring's ranks is here
        return Shards([None] * n, 1)
    q0, k0 = (next(x for x in xs if x is not None) for xs in (q, k))
    B, Lq, H, D = q0.shape
    Lk = k0.shape[1]
    if n_rep > 1 and k0.shape[2] * n_rep != H:
        raise ValueError(
            f"n_rep {n_rep} * kv heads {k0.shape[2]} != q heads {H}")
    if scale is None:
        scale = D ** -0.5
    if kv_chunk is not None and (kv_chunk <= 0 or Lk % kv_chunk):
        raise ValueError(
            f"kv_chunk {kv_chunk} must be positive and divide the local "
            f"length {Lk}")
    qf = [None if x is None else x.float() for x in q]
    state = [None if x is None else
             (torch.zeros((B, Lq, H, D), device=x.device),
              torch.zeros((B, H, Lq), device=x.device),
              torch.full((B, H, Lq), NEG_INF, device=x.device)) for x in q]
    kc, vc = list(k), list(v)
    for t in range(n):
        for r in range(n):
            if q[r] is None:  # another process's rank
                continue
            src = (r - t) % n  # the rank whose block rank r holds now
            o, l, m = state[r]
            step = Lk if kv_chunk is None or kv_chunk >= Lk else kv_chunk
            for off in range(0, Lk, step):
                # slice first, then upcast: a whole-block float32 copy would
                # defeat the chunk's memory bound
                kf = _rep(kc[r][:, off:off + step], n_rep)
                vf = _rep(vc[r][:, off:off + step], n_rep)
                s, mask = _block_scores(qf[r], kf, r * Lq, src * Lk + off,
                                        causal, scale)
                o, l, m = _online_update(o, l, m, s, mask, vf)
            state[r] = (o, l, m)
        # rotate the blocks one rank on (the last rotation restores owners)
        kc, vc = ppermute(kc, ranks=ranks), ppermute(vc, ranks=ranks)
    out = []
    for x, st in zip(q, state):
        if x is None:
            out.append(None)
            continue
        o, l, _ = st
        l = torch.clamp(l, min=1e-30)
        out.append((o / l[..., None].transpose(1, 2)).to(x.dtype))
    return Shards(out, 1)


def ring_attention_sharded(q, k, v, mesh: Mesh, axis: str = "tp",
                           causal: bool = True,
                           batch_axis: Optional[str] = "dp",
                           kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Ring attention of global ``(B, L, H, D)`` q/k/v: L split over
    ``axis`` (and B over ``batch_axis`` when the mesh has it, each batch
    group running its own ring on its devices).  Returns the global output
    on ``q``'s device.  Over a mesh whose ranks span processes every
    process gives the same q/k/v and gets the whole output (each rank's
    shard from its process); no gradient crosses processes there."""
    groups = (mesh.axis_size(batch_axis)
              if batch_axis and batch_axis in mesh.axis_names else 1)
    outs = []
    for g, rows in enumerate(torch.chunk(torch.arange(q.shape[0]), groups)):
        at = {batch_axis: g} if groups > 1 else {}
        devs = mesh.axis_devices(axis, **at)
        n = len(devs)

        def split(x):
            return [None if d is None else p.to(d) for p, d in zip(
                torch.chunk(x[rows], n, dim=1), devs)]

        o = ring_attention(split(q), split(k), split(v), causal=causal,
                           kv_chunk=kv_chunk, ranks=devs)
        outs.append(gather(list(o), devs, None,
                           lambda ps: torch.cat(ps, dim=1), None).to(q.device))
    return torch.cat(outs, dim=0)


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on ``(batch, seq, heads, d_head)`` with scores, softmax and
    P.V in float32 and the output in ``q.dtype``."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    s = s * scale
    if causal:
        L, M = s.shape[-2], s.shape[-1]
        mask = torch.tril(torch.ones((L, M), dtype=torch.bool,
                                     device=s.device))
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(q.dtype)
