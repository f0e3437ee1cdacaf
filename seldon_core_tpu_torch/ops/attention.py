"""Flash attention forward (port of ``seldon_core_tpu/ops/attention.py``).

:func:`flash_attention` dispatches on the device of ``q``: a CUDA tensor
launches kernel K3 (``csrc/flash_attention.cu``, :func:`flash_attention_cuda`)
or raises; a CPU tensor takes the plain version :func:`flash_attention_ref`.

Layout is the flagship transformer's ``(batch, seq, heads, d_head)``.  K/V
may carry fewer heads than q (grouped-query attention, ``H % Hkv == 0``):
the kernel reads KV head ``h // (H // Hkv)`` in place and the plain version
expands K/V with ``repeat_interleave`` (``jnp.repeat``) first; both give the
reference's numbers, which expands before its kernel.

The kernel covers every sequence length (masked edges), so nothing here
calls the reference's block fitting (:func:`_fit_block`); it is kept, with
the reference's name and rule, so a reader finds its counterpart.  Forward
only: the dense-recompute backward comes
with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.parallel.ring_attention import dense_attention

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_cuda",
           "flash_variant", "MMA_HEAD_DIMS", "NEG_INF"]

NEG_INF = -1e30


def _expand(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    g = n_heads // kv.shape[2]
    return kv if g == 1 else kv.repeat_interleave(g, dim=2)


def flash_attention_ref(q, k, v, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3: dense attention on GQA-expanded K/V (scores,
    softmax and P.V in float32, output in ``q.dtype``)."""
    H = q.shape[2]
    return dense_attention(q, _expand(k, H), _expand(v, H), causal=causal,
                           scale=scale)


#: head dims K3's tensor-core variant is instantiated for
MMA_HEAD_DIMS = (64, 128)
_VARIANT_CODES = {"simt": 0, "mma": 1}  # csrc/flash_attention.cu


def flash_variant(dtype: torch.dtype, D: int) -> str:
    """K3's variant for inputs of ``dtype`` and head dim ``D``: ``"mma"``
    (tensor cores) for bfloat16 at D in :data:`MMA_HEAD_DIMS`, else
    ``"simt"`` (float32 FMA, every D of ``_build.HEAD_DIMS``)."""
    if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS:
        return "mma"
    return "simt"


def flash_attention_cuda(q, k, v, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch K3 on contiguous q (B, L, H, D) and k/v (B, L, Hkv, D) of one
    dtype (float32 or bfloat16), D in {8, ..., 256} a power of two."""
    what = "flash_attention"
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q, k and v must be on the card")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{what}: want q (B, L, H, D), k/v (B, L, Hkv, D)")
    B, L, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != D:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{what}: {H} query heads over {Hkv} KV heads")
    _build.check_head_dim(D, what)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    code = _build.dtype_code(q.dtype, what)
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    if B * L == 0:
        return out
    err = _build.load().sck_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, L, H, Hkv, D, int(bool(causal)), float(scale), code,
        _VARIANT_CODES[flash_variant(q.dtype, D)], _build.stream_of(q),
    )
    _build.check(err, what)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on ``(batch, seq, heads, d_head)`` tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)


def _fit_block(L: int, want: int) -> Optional[int]:
    """Largest multiple of 8 that divides L and is <= want (None if none):
    the reference's rule for its Pallas blocks."""
    b = min(want, L) // 8 * 8
    while b >= 8:
        if L % b == 0:
            return b
        b -= 8
    return None
