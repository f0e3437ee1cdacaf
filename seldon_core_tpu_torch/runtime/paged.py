"""Paged KV cache: fixed-size pages + per-slot page tables (port of
``seldon_core_tpu/runtime/paged.py``).

Layout (per layer): ``k_pages/v_pages: (kv_heads, n_pages, page_size,
d_head)``; the cache holds all layers, ``(layers, kv_heads, n_pages,
page_size, d_head)``.  A slot's position ``t`` lives in page
``tables[s, t // page_size]`` at row ``t % page_size``.

Page 0 is the TRASH page: released slots' table rows point at it, so the
whole-batch decode tick (which steps inactive slots too) writes into a row
nobody attends over, never into a page recycled to another request.

Unlike the reference (pure functions over immutable arrays), the cache is
updated IN PLACE: :func:`paged_decode_step` and :func:`insert_rows` write
the new K/V rows into the pool tensors and return the same dict, which
saves a copy of the pool per tick.

Decode attention (:func:`paged_attention`) dispatches on the device: a CUDA
tensor launches kernel K2 (``csrc/paged_attention.cu``) or raises, a CPU
tensor takes :func:`paged_attention_ref`.  K2 splits each slot's pages over
several blocks (flash-decoding); :func:`paged_split_plan` says how, from
static shapes only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    _attn_out,
    _chunk_attention,
    _attn_proj,
    _embed,
    _layer_params,
    _vocab_proj,
    ffn_block,
    rmsnorm,
    rope,
)
from seldon_core_tpu_torch.ops import _build, launches

__all__ = [
    "PagedConfig",
    "init_paged_cache",
    "paged_attention",
    "paged_attention_ref",
    "paged_attention_cuda",
    "paged_decode_step",
    "paged_chunk_step",
    "insert_rows",
    "SplitPlan",
    "paged_split_plan",
    "kernel_split_plan",
    "arrival_counters",
]

# csrc/paged_attention.cu: query heads per block, bytes and tokens of a chunk
_KERNEL_HEADS = 8
_CHUNK_BYTES = 16384
_MAX_CHUNK = 128
#: blocks per SM that the split plan aims for, and the most chunks a block
#: streams (fitted to ``time_paged_attention --sweep`` on an H100: PERF.md)
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MAX_CHUNKS = 4


class SplitPlan(NamedTuple):
    """How K2 covers a table of ``pp`` pages: ``n_split`` blocks per (slot,
    KV head, head group), block z taking pages ``[z * pages, (z + 1) *
    pages)``; the last partition may be short."""

    n_split: int
    pages: int

    def partitions(self, pp: int) -> list:
        """The ``(first, end)`` page range of each block."""
        return [(z * self.pages, min(pp, (z + 1) * self.pages))
                for z in range(self.n_split)]


def paged_split_plan(pp: int, pairs: int, sms: int,
                     max_pages: int) -> SplitPlan:
    """Split plan of K2 over ``pairs`` (slot, KV head, head group) blocks'
    worth of work on a card with ``sms`` SMs.  Static shapes only (never
    the lengths, which would cost a device sync): the table's ``pp`` pages
    go to as many blocks per pair as make about ``SPLIT_BLOCKS_PER_SM``
    blocks per SM, each with at least one page and at most ``max_pages``.
    Blocks past a slot's length return at once on the card."""
    want = max(1, -(-(SPLIT_BLOCKS_PER_SM * sms) // max(1, pairs)))
    pages = min(max(1, max_pages), -(-pp // min(want, pp)))
    return SplitPlan(-(-pp // pages), pages)


def kernel_split_plan(S: int, H: int, Hkv: int, D: int, page_size: int,
                      pp: int, itemsize: int, sms: int) -> SplitPlan:
    """The plan :func:`paged_attention_cuda` launches with: the pairs count
    head groups of up to 8 query heads, and a partition holds at most
    ``SPLIT_MAX_CHUNKS`` chunks of the kernel (a chunk: 16 KB of K rows, at
    most 128 tokens), so that the slots' blocks stay of a size."""
    groups = -(-(H // Hkv) // _KERNEL_HEADS)
    chunk = min(_MAX_CHUNK, _CHUNK_BYTES // (D * itemsize))
    return paged_split_plan(pp, S * Hkv * groups, sms,
                            max(1, SPLIT_MAX_CHUNKS * chunk // page_size))


@dataclass(frozen=True)
class PagedConfig:
    """``n_pages`` INCLUDES the reserved trash page 0; usable capacity is
    ``(n_pages - 1) * page_size`` token rows."""

    n_pages: int
    page_size: int = 16

    @property
    def usable_tokens(self) -> int:
        return (self.n_pages - 1) * self.page_size

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


def init_paged_cache(cfg: TransformerConfig, paged: PagedConfig,
                     device=None) -> dict:
    shape = (cfg.n_layers, cfg.kv_heads, paged.n_pages, paged.page_size,
             cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _gather_pages(pages, page_indices):
    """Gather each slot's pages into the slab layout (S, T, Hkv, Dh);
    gathered index t IS the slot's global position t."""
    Hkv, _P, ps, Dh = pages.shape
    S, pp = page_indices.shape
    g = pages[:, page_indices.long()]  # (Hkv, S, pp, ps, Dh)
    return g.reshape(Hkv, S, pp * ps, Dh).movedim(0, 2)


def paged_attention_ref(q, k_pages, v_pages, lengths, page_indices):
    """Plain version of K2, the K=1 case of :func:`_chunk_attention` over
    gathered pages.

    - ``q``: (S, n_heads, Dh) one query per slot
    - ``k_pages/v_pages``: (kv_heads, n_pages, page_size, Dh)
    - ``lengths``: (S,) valid tokens per slot (0 = inactive)
    - ``page_indices``: (S, pages_per_slot)
    Returns (S, n_heads, Dh) float32.
    """
    kg = _gather_pages(k_pages, page_indices)
    vg = _gather_pages(v_pages, page_indices)
    return _chunk_attention(q[:, None], kg, vg,
                            (lengths.long() - 1)[:, None])[:, 0]


def _pairs(S: int, H: int, Hkv: int) -> int:
    """K2's (slot, KV head, head group) pairs: one arrival counter each."""
    return S * Hkv * -(-(H // Hkv) // _KERNEL_HEADS)


def arrival_counters(S: int, H: int, Hkv: int, device) -> torch.Tensor:
    """K2's merge counters for ``S`` slots of ``H`` query heads over ``Hkv``
    KV heads, at zero; each launch leaves them at zero.  Launches that
    share them must run in one stream order: an engine makes its own
    before it captures a graph (a graph holds their address), so that its
    ticks (on its one worker) never share them with another engine's (on
    another thread and stream)."""
    return torch.zeros((_pairs(S, H, Hkv),), dtype=torch.int32,
                       device=device)


def paged_attention_cuda(q, k_pages, v_pages, lengths, page_indices,
                         plan: Optional[SplitPlan] = None,
                         arrivals: Optional[torch.Tensor] = None):
    """Launch K2.  ``q`` (S, H, Dh) and the pages share a dtype (float32 or
    bfloat16); lengths and tables are int32; all contiguous on one card,
    the pages 16-byte aligned.  Returns (S, H, Dh) float32 (the reference's
    output dtype).  ``plan`` replaces :func:`kernel_split_plan`'s
    (measurement only).  ``arrivals`` (:func:`arrival_counters`) are the
    merge counters a split plan needs.  Reads no device value on the
    host."""
    what = "paged_attention"
    ts = (q, k_pages, v_pages, lengths, page_indices)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{what}: want q (S, H, Dh) and pages (Hkv, P, ps, "
                         "Dh)")
    S, H, D = q.shape
    Hkv, n_pages, ps, D2 = k_pages.shape
    if D2 != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs pages "
                         f"{tuple(k_pages.shape)}")
    _build.check_head_dim(D, what)
    if page_indices.dim() != 2 or page_indices.shape[0] != S or \
            page_indices.shape[1] == 0 or lengths.shape != (S,):
        raise ValueError(f"{what}: lengths (S,) and tables (S, pp >= 1) "
                         "expected")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError(f"{what}: lengths and tables must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{what}: q and page dtypes differ")
    code = _build.dtype_code(q.dtype, what)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what}: every operand must be on the card")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    for name, t in zip(("q", "k_pages", "v_pages", "lengths", "tables"), ts):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{what}: pages must start 16-byte aligned")
    dev = q.device
    out = torch.empty((S, H, D), dtype=torch.float32, device=dev)
    if S == 0:
        return out
    pp = page_indices.shape[1]
    if plan is None:
        plan = kernel_split_plan(S, H, Hkv, D, ps, pp, q.element_size(),
                                 _build.sm_count(dev))
    part = None
    if plan.n_split > 1:  # partial outputs, then their (max, sum)
        pairs = _pairs(S, H, Hkv)
        if (arrivals is None or arrivals.dtype != torch.int32
                or arrivals.device != dev or arrivals.numel() < pairs):
            raise ValueError(f"{what}: a plan of {plan.n_split} splits needs "
                             f"arrivals (arrival_counters): int32 on {dev}, "
                             f">= {pairs} counters")
        part = torch.empty((pairs * plan.n_split * _KERNEL_HEADS * (D + 2),),
                           dtype=torch.float32, device=dev)
    else:
        arrivals = None
    err = _build.load().sck_paged_attention(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(lengths), _build.ptr(page_indices), _build.ptr(out),
        None if part is None else _build.ptr(part),
        None if arrivals is None else _build.ptr(arrivals), S, H, Hkv,
        n_pages, ps, D, pp, plan.n_split, plan.pages, float(D ** -0.5), code,
        _build.stream_of(q),
    )
    _build.check(err, what)
    launches.note(paged_attention_cuda)
    return out


launches.register("paged_attention", paged_attention_cuda)


def paged_attention(q, k_pages, v_pages, lengths, page_indices,
                    arrivals: Optional[torch.Tensor] = None):
    if q.is_cuda:
        return paged_attention_cuda(q.contiguous(), k_pages, v_pages,
                                    lengths, page_indices, arrivals=arrivals)
    return paged_attention_ref(q, k_pages, v_pages, lengths, page_indices)


def paged_decode_step(params, cache, tables, pos, tok,
                      cfg: TransformerConfig, paged: PagedConfig,
                      arrivals: Optional[torch.Tensor] = None):
    """One decode token per slot against the paged cache.

    - ``tables``: (S, pages_per_slot) int32 page ids (trash page 0 for
      released slots)
    - ``pos``: (S,) int32 host-owned positions (tokens already processed)
    - ``tok``: (S,) current token per slot
    - ``arrivals``: K2's merge counters (:func:`arrival_counters`; on the
      card when K2 splits)

    Writes each slot's new K/V row into its current page (in place) and
    returns ``(logits (S, V) float32, cache)``.
    """
    ps = paged.page_size
    Hkv, Dh = cfg.kv_heads, cfg.d_head
    x = _embed(params, tok, cfg)[:, None, :]  # (S, 1, D)
    positions = pos[:, None]  # (S, 1)
    page_of = torch.gather(tables, 1, (pos // ps)[:, None].long())[:, 0]
    row = (page_of * ps + pos % ps).long()  # (S,) flat row in (P*ps)
    lengths = (pos + 1).to(torch.int32)  # the current token is written first

    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        h = rmsnorm(x, p["ln1"])
        q = _attn_proj(h, p["wq"], cfg.n_heads, Dh, x.dtype)
        k = _attn_proj(h, p["wk"], Hkv, Dh, x.dtype)
        v = _attn_proj(h, p["wv"], Hkv, Dh, x.dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        # this token's K/V row into each slot's current page (in place;
        # inactive slots collide on the trash page, any winner)
        kp, vp = cache["k"][i], cache["v"][i]
        kp.view(Hkv, -1, Dh)[:, row, :] = k[:, 0].transpose(0, 1)
        vp.view(Hkv, -1, Dh)[:, row, :] = v[:, 0].transpose(0, 1)
        attn = paged_attention(q[:, 0], kp, vp, lengths, tables, arrivals)
        x = x + _attn_out(attn[:, None].to(x.dtype), p["wo"], x.dtype)
        x = ffn_block(p, x, cfg)

    xf = rmsnorm(x, params["ln_f"])
    logits = _vocab_proj(xf, params["lm_head"], cfg).float()
    return logits[:, 0, :], cache


def paged_chunk_step(params, cache, tables, pos, toks,
                     cfg: TransformerConfig, paged: PagedConfig):
    """A K-token chunk per slot against the paged cache: the multi-query
    step of speculative verification (each slot's k+1 tokens in one pass).
    Plain torch, as the reference's is plain XLA: the slot rows ``pos ..
    pos + K - 1`` are written into the slots' pages (in place), then the
    slab chunk math (:func:`_chunk_attention`) runs over a page-gathered
    (S, T, Hkv, Dh) view.  Rejection rewinds by lowering the host-owned
    ``pos``: the stale rows are masked and later overwritten.

    - ``toks``: (S, K); query j of slot s sits at ``pos[s] + j``
    Returns ``(logits (S, K, V) float32, cache)``.
    """
    S, K = toks.shape
    ps = paged.page_size
    Hkv, Dh = cfg.kv_heads, cfg.d_head
    x = _embed(params, toks, cfg)  # (S, K, D)
    positions = (pos.long()[:, None]
                 + torch.arange(K, device=x.device)[None, :])  # (S, K)
    page_of = torch.gather(tables.long(), 1, positions // ps)
    rows = (page_of * ps + positions % ps).reshape(-1)  # (S*K,)

    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        h = rmsnorm(x, p["ln1"])
        q = _attn_proj(h, p["wq"], cfg.n_heads, Dh, x.dtype)
        k = _attn_proj(h, p["wk"], Hkv, Dh, x.dtype)
        v = _attn_proj(h, p["wv"], Hkv, Dh, x.dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        # all S*K new rows into the pool (inactive slots' trash-page rows
        # may collide: nobody attends over them, any winner)
        kp, vp = cache["k"][i], cache["v"][i]
        kp.view(Hkv, -1, Dh)[:, rows, :] = k.reshape(S * K, Hkv, Dh).transpose(
            0, 1).to(kp.dtype)
        vp.view(Hkv, -1, Dh)[:, rows, :] = v.reshape(S * K, Hkv, Dh).transpose(
            0, 1).to(vp.dtype)
        attn = _chunk_attention(q, _gather_pages(kp, tables),
                                _gather_pages(vp, tables), positions)
        x = x + _attn_out(attn, p["wo"], x.dtype)
        x = ffn_block(p, x, cfg)

    xf = rmsnorm(x, params["ln_f"])
    logits = _vocab_proj(xf, params["lm_head"], cfg).float()
    return logits, cache


def insert_rows(cache, small, rows, true_len: int, start: int = 0):
    """Scatter a 1-row prefill cache's K/V rows ``start..true_len`` into the
    paged cache (in place) at flat rows ``rows`` ((true_len - start,),
    page*ps+offset).  ``small`` k/v: (layers, 1, bucket, Hkv, Dh)."""
    L, Hkv, n_pages, ps, Dh = cache["k"].shape
    rows = torch.as_tensor(rows, device=cache["k"].device).long()
    for name in ("k", "v"):
        flat = cache[name].view(L, Hkv, n_pages * ps, Dh)
        # (layers, 1, bucket, Hkv, Dh) -> (layers, Hkv, true_len - start, Dh)
        new = small[name][:, 0, start:true_len].transpose(1, 2)
        flat[:, :, rows, :] = new.to(flat.dtype)
    return cache
