"""Flagship transformer LM on one device (port of
``seldon_core_tpu/models/transformer.py``).

Same parameter layout as the reference, so converted params
(:mod:`seldon_core_tpu_torch.convert`) run unchanged:

- ``embed`` (V, D), ``ln_f`` (D,), ``lm_head`` (D, V);
- ``blocks``: stacked float leaves with a leading layer dim (``wq`` (L, D,
  H, Dh), ``wk``/``wv`` (L, D, Hkv, Dh), ``wo`` (L, H, Dh, D), ``w1`` (L, D,
  F), ``w2`` (L, F, D), ``ln1``/``ln2`` (L, D));
- int8-quantized leaves are ``{"values": [...], "scales": [...]}`` with one
  tensor per layer (Python lists where the reference keeps unstacked tuples,
  ``models/transformer.py:215-220``): q/k/v flattened ``(D, heads*Dh)``,
  ``wo`` ``(H*Dh, D)``, ``w1`` (D, F), ``w2`` (F, D), ``lm_head`` (D, V).
  Each ``values`` tensor has that (K, N) shape but is stored K-major (the
  ``.t()`` view of a contiguous (N, K) buffer, ``ops.quant.k_major``), as
  every int8 weight this module makes is (through ``quantize_int8``).

Numerics copied from the reference: rmsnorm in float32 (eps 1e-6, then the
scale, then the cast); rotary embedding on concatenated (not interleaved)
halves with angles in float32; tanh-approximated GELU (``jax.nn.gelu``'s
default); masked scores -1e30; attention scores and softmax in float32.

This slice covers one device: no mesh, MoE, ring attention or pipeline
(those come with the multi-device slice), and no training step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.ops.attention import flash_attention
from seldon_core_tpu_torch.ops.quant import (
    QuantizedLinear,
    int8_matmul,
    quantize_int8,
)
from seldon_core_tpu_torch.parallel.ring_attention import dense_attention

__all__ = [
    "TransformerConfig", "init_params", "init_params_int8",
    "quantize_ffn_params", "quantize_attn_params", "rmsnorm", "rope",
    "attention_block", "ffn_block", "prefill",
]

# float32 products on the card must stay float32, as the reference's do
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16  # activation dtype
    # grouped-query attention: K/V heads (None = n_heads, plain MHA)
    n_kv_heads: Optional[int] = None
    # flash-attention kernel (K3) on the prefill path instead of dense
    use_flash: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        h = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % h:
            raise ValueError(
                f"n_heads {self.n_heads} must be a multiple of n_kv_heads {h}"
            )
        return h


# ----------------------------------------------------------------------
# init + int8 weight preparation
# ----------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device=None) -> dict:
    """Float32 master params, blocks stacked with a leading layer dim, drawn
    from ``gen`` (a ``torch.Generator`` on ``device``).  The draws cannot
    equal ``jax.random``'s; tests that compare with the reference convert
    its params instead."""
    device = gen.device if device is None else device
    D, H, Dh, Fd, L = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                       cfg.n_layers)
    Hk = cfg.kv_heads
    s = D ** -0.5
    blocks = {
        "ln1": torch.ones((L, D), device=device),
        "ln2": torch.ones((L, D), device=device),
        "wq": _normal(gen, (L, D, H, Dh), s, device),
        "wk": _normal(gen, (L, D, Hk, Dh), s, device),
        "wv": _normal(gen, (L, D, Hk, Dh), s, device),
        "wo": _normal(gen, (L, H, Dh, D), s, device),
        "w1": _normal(gen, (L, D, Fd), s, device),
        "w2": _normal(gen, (L, Fd, D), Fd ** -0.5, device),
    }
    return {
        "embed": _normal(gen, (cfg.vocab_size, D), s, device),
        "blocks": blocks,
        "ln_f": torch.ones((D,), device=device),
        "lm_head": _normal(gen, (D, cfg.vocab_size), s, device),
    }


def _q8(w) -> dict:
    q = quantize_int8(w)
    return {"values": q.values, "scales": q.scales}


def init_params_int8(gen: torch.Generator, cfg: TransformerConfig,
                     device=None) -> dict:
    """int8 "full" params made layer by layer on ``device``: each layer's
    float32 weights exist only while that layer is quantized, so the float32
    master copy of a large model (21 GB at 7B) never exists whole.  Same
    layout as ``quantize_attn_params(quantize_ffn_params(init_params(...)))``
    with the embedding stored in ``cfg.dtype`` (the reference's 7B weight init,
    ``bench.py`` ``_init_7b_int8``, does the same)."""
    device = gen.device if device is None else device
    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    Hk = cfg.kv_heads
    s = D ** -0.5
    shapes = {
        "wq": ((D, H * Dh), s), "wk": ((D, Hk * Dh), s),
        "wv": ((D, Hk * Dh), s), "wo": ((H * Dh, D), s),
        "w1": ((D, Fd), s), "w2": ((Fd, D), Fd ** -0.5),
    }
    blocks = {name: {"values": [], "scales": []} for name in shapes}
    for _ in range(cfg.n_layers):
        for name, (shape, scale) in shapes.items():
            q = _q8(_normal(gen, shape, scale, device))
            blocks[name]["values"].append(q["values"])
            blocks[name]["scales"].append(q["scales"])
    blocks["ln1"] = torch.ones((cfg.n_layers, D), device=device)
    blocks["ln2"] = torch.ones((cfg.n_layers, D), device=device)
    embed = _normal(gen, (cfg.vocab_size, D), s, device).to(cfg.dtype)
    return {
        "embed": embed,
        "blocks": blocks,
        "ln_f": torch.ones((D,), device=device),
        "lm_head": _q8(_normal(gen, (D, cfg.vocab_size), s, device)),
    }


def quantize_ffn_params(params: dict) -> dict:
    """Each block's w1/w2 and the lm_head to per-channel int8, unstacked
    per layer."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in ("w1", "w2"):
        w = blocks[name]
        qs = [quantize_int8(w[i]) for i in range(w.shape[0])]
        blocks[name] = {"values": [q.values for q in qs],
                        "scales": [q.scales for q in qs]}
    out["blocks"] = blocks
    out["lm_head"] = _q8(params["lm_head"])
    return out


def quantize_attn_params(params: dict) -> dict:
    """Per-channel int8 wq/wk/wv (flattened ``(D, heads*Dh)``) and wo
    (``(H*Dh, D)``), unstacked per layer."""
    blocks = dict(params["blocks"])
    n_layers = blocks["wq"].shape[0]

    def quant(w, flat_in):
        qs = [quantize_int8(w[i].reshape(flat_in, -1))
              for i in range(n_layers)]
        return {"values": [q.values for q in qs],
                "scales": [q.scales for q in qs]}

    D = blocks["wq"].shape[1]
    for name in ("wq", "wk", "wv"):
        blocks[name] = quant(blocks[name], D)
    H, Dh = blocks["wo"].shape[1], blocks["wo"].shape[2]
    blocks["wo"] = quant(blocks["wo"], H * Dh)
    return {**params, "blocks": blocks}


def _is_q8(w) -> bool:
    return isinstance(w, dict) and "values" in w and "scales" in w


def _layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``: stacked leaves sliced on the layer dim, int8 per-layer
    lists indexed."""
    return {
        k: ({"values": v["values"][i], "scales": v["scales"][i]}
            if _is_q8(v) else v[i])
        for k, v in blocks.items()
    }


def _q8_matmul(x2, w, out_dtype):
    return int8_matmul(x2, QuantizedLinear(w["values"], w["scales"]),
                       out_dtype=out_dtype)


def _attn_proj(h, w, heads: int, d_head: int, dtype):
    """QKV projection ``(B, L, D) x (D, heads, d_head)``; int8 weights are
    stored flattened ``(D, heads*d_head)``."""
    if _is_q8(w):
        B, L, D = h.shape
        y = _q8_matmul(h.reshape(B * L, D), w, dtype)
        return y.reshape(B, L, heads, d_head)
    return torch.einsum("bld,dhk->blhk", h, w.to(dtype))


def _attn_out(attn, wo, dtype):
    """Output projection ``(B, L, H, Dh) x (H, Dh, D)`` (int8 layout
    ``(H*Dh, D)``)."""
    if _is_q8(wo):
        B, L, H, Dh = attn.shape
        y = _q8_matmul(attn.reshape(B * L, H * Dh).to(dtype), wo, dtype)
        return y.reshape(B, L, -1)
    return torch.einsum("blhk,hkd->bld", attn.to(dtype), wo.to(dtype))


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: [B, L, H, Dh]; positions: [B, L]."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # [B, L, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _expand_kv(kv, cfg: TransformerConfig):
    """GQA: repeat each K/V head over its group of query heads
    (``jnp.repeat`` on the head axis); identity for plain MHA."""
    g = cfg.n_heads // cfg.kv_heads
    return kv if g == 1 else kv.repeat_interleave(g, dim=2)


def attention_block(p, x, positions, cfg: TransformerConfig,
                    return_kv: bool = False):
    """Causal self-attention.  ``return_kv`` also returns the post-rope K/V
    (at ``kv_heads``) for the KV cache.  With ``cfg.use_flash`` the flash
    kernel reads the un-expanded K/V itself; the dense path expands first."""
    h = rmsnorm(x, p["ln1"])
    q = _attn_proj(h, p["wq"], cfg.n_heads, cfg.d_head, x.dtype)
    k = _attn_proj(h, p["wk"], cfg.kv_heads, cfg.d_head, x.dtype)
    v = _attn_proj(h, p["wv"], cfg.kv_heads, cfg.d_head, x.dtype)
    q, k = rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                   cfg.rope_theta)
    if cfg.use_flash:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = dense_attention(q, _expand_kv(k, cfg), _expand_kv(v, cfg),
                               causal=True)
    out = x + _attn_out(attn, p["wo"], x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def ffn_block(p, x, cfg: TransformerConfig):
    """Dense FFN with tanh GELU; int8 weights take the int8 kernel.  (The
    reference also returns a MoE aux loss; this slice has no MoE.)"""
    h = rmsnorm(x, p["ln2"])
    if _is_q8(p["w1"]):
        B, L, D = h.shape
        h1 = _q8_matmul(h.reshape(B * L, D), p["w1"], x.dtype)
        h1 = F.gelu(h1, approximate="tanh")
        out = _q8_matmul(h1, p["w2"], x.dtype).reshape(B, L, D)
        return x + out
    h1 = torch.einsum("bld,df->blf", h, p["w1"].to(x.dtype))
    h1 = F.gelu(h1, approximate="tanh")
    return x + torch.einsum("blf,fd->bld", h1, p["w2"].to(x.dtype))


def _embed(params: dict, ids, cfg: TransformerConfig):
    # the reference casts the table then indexes; indexing first gives the
    # same values without casting the whole table
    return params["embed"][ids].to(cfg.dtype)


def _vocab_proj(x, lm_head, cfg: TransformerConfig):
    if _is_q8(lm_head):
        B, L, D = x.shape
        return _q8_matmul(x.reshape(B * L, D), lm_head, cfg.dtype).reshape(
            B, L, -1)
    return torch.einsum("bld,dv->blv", x, lm_head.to(cfg.dtype))


def prefill(params, input_ids, cfg: TransformerConfig, max_len: int,
            logit_pos=None):
    """One forward over the whole prompt that also returns its KV cache.

    Returns ``(logits, cache)`` with ``cache = {"k", "v": (layers, B,
    max_len, Hkv, Dh), "pos": (B,)}``.  ``logit_pos`` projects only that
    position through the vocab matrix (``[B, V]`` logits): an int for every
    row, or a (B,) tensor of per-row positions; ``None`` projects all
    positions (``[B, L, V]``).  Right-padding is exact under causal
    attention, so callers pass ``logit_pos = true_len - 1``.
    """
    B, L = input_ids.shape
    x = _embed(params, input_ids, cfg)
    positions = torch.arange(L, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        x, (k, v) = attention_block(p, x, positions, cfg, return_kv=True)
        x = ffn_block(p, x, cfg)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["ln_f"])
    if logit_pos is not None:
        lp = torch.as_tensor(logit_pos)
        if lp.dim() == 0:
            x = x[:, int(lp)][:, None]
        else:
            x = x[torch.arange(B, device=x.device), lp.to(x.device)][:, None]
        logits = _vocab_proj(x, params["lm_head"], cfg)[:, 0].float()
    else:
        logits = _vocab_proj(x, params["lm_head"], cfg).float()
    pad = max_len - L
    cache = {
        # (layers, B, max_len, Hkv, Dh): prompt K/V up front, zeros after
        "k": F.pad(torch.stack(ks), (0, 0, 0, 0, 0, pad)),
        "v": F.pad(torch.stack(vs), (0, 0, 0, 0, 0, pad)),
        "pos": torch.full((B,), L, dtype=torch.int32, device=x.device),
    }
    return logits, cache
