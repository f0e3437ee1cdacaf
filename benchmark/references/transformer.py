"""Plain float32 reference of the served transformer, in plain torch, from
the benchmark's own weights (``families/transformer_int8.py``); it imports
nothing of the port.

The model: token embedding; per layer a pre-norm RMSNorm, query, key and
value projections (grouped-query: each key/value head serves ``heads /
kv_heads`` query heads), rotary embedding on queries and keys (the
rotate-half form, frequencies ``theta^(-i / (d_head / 2))``), causal
softmax attention at scale ``d_head^-1/2``, the output projection added to
the residual, a second pre-norm RMSNorm, ``W2 gelu_tanh(W1 x)`` added to
the residual; a final RMSNorm and the head.  Each weight is its int8
values times its per-output-channel scale, in float32; activations and
every product are float32, with TF32 off.

``control=True`` is the control of the comparison: the same model with
each int8 weight re-quantized per output channel to int4 (absmax / 7),
the precision just below the one the configuration states.

Work is done layer by layer over all the sequences, one layer's weights
dequantized at a time, so that a 7B model fits beside the activations.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dequant", "logits"]


def dequant(values: torch.Tensor, scales: torch.Tensor,
            control: bool = False) -> torch.Tensor:
    """(out, in) float32 weight from (out, in) int8 ``values`` and (out,)
    ``scales``; ``control``: re-quantized to int4 per output channel."""
    w = values.float() * scales.float()[:, None]
    if control:
        s = w.abs().amax(dim=1, keepdim=True) / 7.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        w = torch.clamp(torch.round(w / s), -7, 7) * s
    return w


def _rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x (L, heads, d_head) at positions 0..L-1."""
    L, _, Dh = x.shape
    half = Dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, q_block: int = 1024):
    """Causal grouped attention, q (L, H, Dh), k/v (L, Hkv, Dh); queries
    in blocks so that the scores stay small."""
    L, H, Dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)  # (Hkv, Dh, L)
    vt = v.permute(1, 0, 2)  # (Hkv, L, Dh)
    for a in range(0, L, q_block):
        b = min(a + q_block, L)
        qb = q[a:b].reshape(b - a, Hkv, g, Dh).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kt[:, None]) * (1.0 / math.sqrt(Dh))
        mask = torch.arange(L, device=q.device)[None, :] > torch.arange(
            a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vt[:, None])  # (Hkv, g, b-a, Dh)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, Dh)
    return out


@torch.no_grad()
def logits(w: dict, d, seqs: list, starts: list, control: bool = False):
    """Float32 logits of each sequence (a list of ids) at positions
    ``start .. len - 1``: a list of (len - start, vocab) tensors on the
    weights' device."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = w["embed"].device
        xs = [w["embed"][torch.as_tensor(s, device=dev)].float()
              for s in seqs]
        H, Hkv, Dh = d.heads, d.kv_heads, d.d_head
        for i in range(d.layers):
            W = {n: dequant(w[n][i], w[n + "_s"][i], control)
                 for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
            for j, x in enumerate(xs):
                L = x.shape[0]
                h = _rmsnorm(x, w["ln1"][i].float(), d.norm_eps)
                q = _rope((h @ W["wq"].t()).view(L, H, Dh), d.rope_theta)
                k = _rope((h @ W["wk"].t()).view(L, Hkv, Dh), d.rope_theta)
                v = (h @ W["wv"].t()).view(L, Hkv, Dh)
                a = _attention(q, k, v).reshape(L, H * Dh)
                x = x + a @ W["wo"].t()
                h = _rmsnorm(x, w["ln2"][i].float(), d.norm_eps)
                x = x + F.gelu(h @ W["w1"].t(), approximate="tanh") \
                    @ W["w2"].t()
                xs[j] = x
            del W
        head = dequant(w["head"], w["head_s"], control)
        out = []
        for x, a in zip(xs, starts):
            h = _rmsnorm(x[a:], w["ln_f"].float(), d.norm_eps)
            out.append(h @ head.t())
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
