"""Dense attention (port of ``dense_attention`` in
``seldon_core_tpu/parallel/ring_attention.py``).

It is the plain version of the flash kernel and the non-flash prefill path.
Ring attention itself (sequence parallelism over a mesh) belongs to the
multi-device slice.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dense_attention", "NEG_INF"]

NEG_INF = -1e30


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
