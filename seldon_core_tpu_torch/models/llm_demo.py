"""Deployable demo LLM (port of ``seldon_core_tpu/models/llm_demo.py``):
the paged continuous-batching engine behind the graph's ``model_class``
boot path, sized by plain JSON parameters (see ``examples/llm.json``)."""

from __future__ import annotations

import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    quantize_attn_params,
    quantize_ffn_params,
)
from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
from seldon_core_tpu_torch.runtime.paged import PagedConfig

__all__ = ["DemoLLM"]


class DemoLLM(LLMComponent):
    """Seeded transformer served with continuous batching over a paged KV
    cache.

    Parameters are the reference's (``models/llm_demo.py:42-67``) plus
    ``device`` (``cuda`` unless ``cpu`` is asked for).  Weights come from a
    ``torch.Generator`` on the device seeded with ``seed``; they cannot
    equal the reference's ``jax.random`` draws for the same seed, so the
    port and the reference serve different ids for one seed (the tests
    convert the reference's params to compare like with like).

    Not in this slice: ``model_uri`` checkpoints (slice 3), ``tp > 1``
    (slice 6), the slab engine ``paged_pages=0`` (slice 3), and the other
    slice-3 engine features (chunked / ring / batched prefill, automatic
    prefix caching).  ``auto_prefix_tokens=-1``, the reference's "on by
    default", maps to off here; the reference promises byte-identical ids
    either way.
    """

    def __init__(
        self,
        d_model: int = 64,
        n_layers: int = 2,
        n_heads: int = 4,
        n_kv_heads: int = 0,
        d_ff: int = 128,
        vocab_size: int = 256,
        max_seq: int = 128,
        max_slots: int = 4,
        n_new: int = 16,
        int8: str = "none",
        chunk_prefill: int = 0,
        seed: int = 0,
        dtype: str = "float32",
        tp: int = 1,
        paged_pages: int = 0,
        page_size: int = 16,
        auto_prefix_tokens: int = -1,
        ring_prefill: int = 0,
        batch_prefill_ms: float = 0.0,
        model_uri: str = "",
        priority: int = 0,
        admit_timeout_ms: float = 0.0,
        max_priority: int = -1,
        device: str = "cuda",
    ):
        if model_uri:
            raise NotImplementedError(
                "model_uri checkpoints come with slice 3 of the port")
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) comes with slice 6 of the "
                "port")
        if paged_pages <= 0:
            raise NotImplementedError(
                "the slab engine (paged_pages=0) comes with slice 3 of the "
                "port; set paged_pages")
        if int8 not in ("none", "ffn", "full"):
            raise ValueError(f"int8 must be none, ffn or full, not {int8!r}")
        dev = resolve_device(device)
        cfg = TransformerConfig(
            vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
            n_heads=n_heads, n_kv_heads=n_kv_heads or None, d_ff=d_ff,
            max_seq=max_seq, dtype=getattr(torch, dtype),
        )
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        params = init_params(gen, cfg, device=dev)
        if int8 in ("ffn", "full"):
            params = quantize_ffn_params(params)
        if int8 == "full":
            params = quantize_attn_params(params)
        engine = PagedLLMEngine(
            params, cfg, PagedConfig(n_pages=paged_pages, page_size=page_size),
            max_slots=max_slots, chunk_prefill=chunk_prefill,
            auto_prefix_tokens=max(auto_prefix_tokens, 0),
            ring_prefill=ring_prefill, batch_prefill_ms=batch_prefill_ms,
        )
        super().__init__(
            engine, n_new=n_new, priority=priority,
            admit_timeout_ms=admit_timeout_ms or None,
            max_priority=None if max_priority < 0 else max_priority,
        )
        self.name = "llm"

    def tags(self):
        return {"model": "demo-llm", "engine": "continuous-batching"}
