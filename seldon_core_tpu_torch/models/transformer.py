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
:func:`decode_step` decodes against a slab cache (:func:`init_cache`),
one token or a K-token chunk per row, writing the new K/V rows in place;
:func:`generate` and :func:`speculative_generate` are the reference's
one-request loops over it.
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
    "attention_block", "ffn_block", "prefill", "has_quantized_params",
    "init_cache", "decode_step", "generate", "speculative_generate",
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


def has_quantized_params(params: dict) -> bool:
    """Whether a param tree carries int8 leaves (in its blocks or the
    lm_head): the checkpoint export refusal and the verbatim load path."""
    return (any(_is_q8(v) for v in params.get("blocks", {}).values())
            or _is_q8(params.get("lm_head")))


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


def _chunk_attention(q, kg, vg, positions):
    """Grouped causal attention of K queries per row against a (B, T, Hkv,
    Dh) K/V cache, the reference's contractions and mask, straight against
    the compact cache (no expanded copy): query j of row b sits at
    ``positions[b, j]`` and sees keys t <= it.  Scores, softmax and P.V in
    float32.  All-masked rows (inactive slots) give uniform attention;
    nobody reads them."""
    S, K, H, Dh = q.shape
    T, Hkv = kg.shape[1], kg.shape[2]
    g = H // Hkv
    qg = q.reshape(S, K, Hkv, g, Dh)
    s = torch.einsum("blhgk,bmhk->bhglm", qg.float(), kg.float()) * (
        Dh ** -0.5)
    valid = (
        torch.arange(T, device=q.device)[None, None, :]
        <= positions[:, :, None]
    )[:, None, None, :, :]  # (S,1,1,K,T)
    s = torch.where(valid, s, -1e30)
    a = torch.softmax(s, dim=-1)
    attn = torch.einsum("bhglm,bmhk->blhgk", a, vg.float())
    return attn.reshape(S, K, H, Dh)


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


# ----------------------------------------------------------------------
# decode against a slab KV cache
# ----------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int,
               max_len: Optional[int] = None, device=None) -> dict:
    """Slab KV cache ``{"k", "v": (layers, B, T, kv_heads, d_head), "pos":
    (B,) int32}``; GQA keeps it at ``kv_heads``."""
    max_len = max_len or cfg.max_seq
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(params, cache, token_ids, cfg: TransformerConfig):
    """Incremental decode against a slab cache.  ``token_ids`` (B,) gives
    logits (B, V); (B, K) runs a K-token chunk in one pass and gives (B, K,
    V).  Query j of row b sits at ``pos[b] + j`` and sees the cache rows
    up to it (a position mask over the whole cache, as the reference).

    Unlike the reference, the new K/V rows are written INTO ``cache`` at
    ``pos .. pos + K - 1`` (in place); the returned cache is the same
    tensors with ``pos + K``.  Rows past ``pos`` are masked and later
    overwritten, so rewinding is setting ``pos`` lower.  The caller keeps
    ``pos + K <= T``."""
    single = token_ids.dim() == 1
    if single:
        token_ids = token_ids[:, None]
    B, K = token_ids.shape
    T = cache["k"].shape[2]
    if K > T:
        raise ValueError(f"chunk of {K} tokens exceeds cache length {T}")
    pos = cache["pos"].to(token_ids.device).long()
    x = _embed(params, token_ids, cfg)  # (B, K, D)
    positions = pos[:, None] + torch.arange(K, device=x.device)[None, :]
    rows = torch.arange(B, device=x.device)[:, None]
    Hkv, Dh = cfg.kv_heads, cfg.d_head
    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        h = rmsnorm(x, p["ln1"])
        q = _attn_proj(h, p["wq"], cfg.n_heads, Dh, x.dtype)
        k = _attn_proj(h, p["wk"], Hkv, Dh, x.dtype)
        v = _attn_proj(h, p["wv"], Hkv, Dh, x.dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]  # (B, T, Hkv, Dh) views
        kc[rows, positions] = k.to(kc.dtype)
        vc[rows, positions] = v.to(vc.dtype)
        attn = _chunk_attention(q, kc, vc, positions)
        x = x + _attn_out(attn, p["wo"], x.dtype)
        x = ffn_block(p, x, cfg)
    x = rmsnorm(x, params["ln_f"])
    logits = _vocab_proj(x, params["lm_head"], cfg).float()
    out = {"k": cache["k"], "v": cache["v"],
           "pos": (pos + K).to(torch.int32)}
    return (logits[:, 0, :] if single else logits), out


# ----------------------------------------------------------------------
# one-request generation loops
# ----------------------------------------------------------------------

def generate(params, prompt_ids, n_new: int, cfg: TransformerConfig,
             temperature: float = 0.0, generator=None):
    """Prefill, then one :func:`decode_step` per token: greedy argmax, or
    with ``temperature`` > 0 a draw from ``softmax(logits / temperature)``
    with ``generator`` (a ``torch.Generator`` on the logits' device; the
    reference's ``jax.random`` draws cannot be replayed).  ``prompt_ids``
    (B, L0); returns (B, L0 + n_new)."""
    B, L0 = prompt_ids.shape
    with torch.no_grad():
        logits, cache = prefill(params, prompt_ids, cfg, max_len=L0 + n_new,
                                logit_pos=L0 - 1)
        out = [prompt_ids]
        for t in range(n_new):
            if temperature > 0.0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok[:, None].to(prompt_ids.dtype))
            if t < n_new - 1:
                logits, cache = decode_step(params, cache, tok, cfg)
        return torch.cat(out, dim=1)


def speculative_generate(params, draft_params, prompt_ids, n_new: int,
                         cfg: TransformerConfig, draft_cfg: TransformerConfig,
                         k_draft: int = 4):
    """Greedy speculative decoding of one request: the draft proposes
    ``k_draft`` tokens, the target scores them in ONE K-token
    :func:`decode_step`, and the longest agreeing prefix is kept plus the
    target's own next token.  The output is exactly the target's greedy
    decode.  Both caches rewind by setting ``pos`` back.

    The draft makes k steps a round, as the reference's loop does, so
    ``rounds`` and ``accept_rate`` equal the reference's: after a full
    acceptance the draft attends over d_{k-1}'s row, which it never wrote,
    and its acceptance decays.  The serving engines' draft makes k + 1
    steps and writes that row.

    Returns ``(ids (1, L0 + n_new), stats)``, stats ``{"rounds",
    "accept_rate"}`` (accepted drafts per round over ``k_draft``)."""
    B, L0 = prompt_ids.shape
    if B != 1:
        raise ValueError("speculative_generate is per-request (B=1); batch "
                         "via the serving engine")
    if n_new <= 0:
        return prompt_ids, {"rounds": 0, "accept_rate": 0.0}
    max_len = L0 + n_new + k_draft + 1
    dev = prompt_ids.device
    with torch.no_grad():
        t_logits, t_cache = prefill(params, prompt_ids, cfg, max_len=max_len,
                                    logit_pos=L0 - 1)
        _, d_cache = prefill(draft_params, prompt_ids, draft_cfg,
                             max_len=max_len, logit_pos=L0 - 1)
        out = [int(torch.argmax(t_logits[0]))]
        rounds = accepted = 0
        while len(out) < n_new:
            tok = torch.tensor([out[-1]], device=dev)
            d_tokens = []
            for _ in range(k_draft):
                dl, d_cache = decode_step(draft_params, d_cache, tok,
                                          draft_cfg)
                tok = torch.argmax(dl, dim=-1)
                d_tokens.append(int(tok[0]))
            vtokens = torch.tensor([[out[-1]] + d_tokens], device=dev)
            vlogits, t_cache = decode_step(params, t_cache, vtokens, cfg)
            tgt = torch.argmax(vlogits[0], dim=-1).tolist()
            n_acc = 0
            while n_acc < k_draft and d_tokens[n_acc] == tgt[n_acc]:
                n_acc += 1
            out.extend(d_tokens[:n_acc] + [tgt[n_acc]])
            rounds += 1
            accepted += n_acc
            # everything before the newest token is processed; the rows
            # past it are masked
            new_pos = torch.full_like(t_cache["pos"], L0 + len(out) - 1)
            t_cache = {**t_cache, "pos": new_pos}
            d_cache = {**d_cache, "pos": new_pos.clone()}
    ids = torch.cat([prompt_ids, torch.tensor([out[:n_new]], device=dev,
                                              dtype=prompt_ids.dtype)], dim=1)
    return ids, {"rounds": rounds,
                 "accept_rate": accepted / (rounds * k_draft)}
