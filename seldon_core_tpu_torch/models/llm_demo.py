"""Deployable demo LLM (port of ``seldon_core_tpu/models/llm_demo.py``):
the continuous-batching engine behind the graph's ``model_class`` boot
path, sized by plain JSON parameters (see ``examples/llm.json``) or booted
from a checkpoint (``model_uri``, see ``examples/llm-checkpoint.json``)."""

from __future__ import annotations

import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    quantize_attn_params,
    quantize_ffn_params,
    shard_params,
)
from seldon_core_tpu_torch.parallel.mesh import make_mesh
from seldon_core_tpu_torch.runtime.checkpoint import (
    load_transformer,
    resolve_model_uri,
)
from seldon_core_tpu_torch.runtime.llm import (
    LLMComponent,
    LLMEngine,
    PagedLLMEngine,
)
from seldon_core_tpu_torch.runtime.paged import PagedConfig

__all__ = ["DemoLLM"]


class DemoLLM(LLMComponent):
    """Transformer served with continuous batching: the slab engine, or the
    paged one when ``paged_pages`` > 0.

    Parameters are the reference's (``models/llm_demo.py:42-67``), with its
    defaults, plus ``device`` (``cuda`` unless ``cpu`` is asked for).
    ``model_uri`` loads a checkpoint (:mod:`..runtime.checkpoint`); the
    shape parameters then come from the artifact, and ``int8`` quantizes at
    load.  Otherwise weights come from a ``torch.Generator`` on the device
    seeded with ``seed``: they cannot equal the reference's ``jax.random``
    draws, so the port and the reference serve different ids for one seed
    (the tests convert the reference's params to compare like with like).
    ``auto_prefix_tokens`` < 0 means ``4 * max_seq`` (automatic prefix
    caching on, as in the reference).  ``tp > 1`` serves tensor-parallel
    over a mesh of ``tp`` ranks (``parallel.mesh.make_mesh``): the first
    ``tp`` cards (refused when fewer are visible), or ``tp`` ranks on the
    CPU with ``device="cpu"``; ``int8="full"`` stays single-device.
    ``ring_prefill`` prefills long buckets sequence-parallel at tp > 1 and
    dense at tp = 1.
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
        if int8 not in ("none", "ffn", "full"):
            raise ValueError(f"int8 must be none, ffn or full, not {int8!r}")
        dev = resolve_device(device)
        mesh = None
        if tp > 1:
            mesh = make_mesh(n_devices=tp, tp=tp, pp=1, device=dev)
            if int8 == "full":
                raise ValueError(
                    "int8='full' (attention projections) is single-chip; "
                    "use int8='ffn' with tp>1")
        if model_uri:
            params, cfg = load_transformer(resolve_model_uri(model_uri),
                                           mesh=mesh, int8=int8, device=dev)
        else:
            cfg = TransformerConfig(
                vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
                n_heads=n_heads, n_kv_heads=n_kv_heads or None, d_ff=d_ff,
                max_seq=max_seq, dtype=getattr(torch, dtype),
            )
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            params = init_params(gen, cfg, device=dev)
            if mesh is not None:
                params = shard_params(params, mesh, cfg)
            if int8 in ("ffn", "full"):
                params = quantize_ffn_params(params, mesh=mesh)
            if int8 == "full":
                params = quantize_attn_params(params)
        if auto_prefix_tokens < 0:
            # on by default, sized by the served model's sequence length
            auto_prefix_tokens = 4 * cfg.max_seq
        common = dict(mesh=mesh, max_slots=max_slots,
                      chunk_prefill=chunk_prefill,
                      auto_prefix_tokens=auto_prefix_tokens,
                      ring_prefill=ring_prefill,
                      batch_prefill_ms=batch_prefill_ms)
        if paged_pages > 0:
            engine = PagedLLMEngine(
                params, cfg,
                PagedConfig(n_pages=paged_pages, page_size=page_size),
                **common)
        else:
            engine = LLMEngine(params, cfg, **common)
        super().__init__(
            engine, n_new=n_new, priority=priority,
            admit_timeout_ms=admit_timeout_ms or None,
            max_priority=None if max_priority < 0 else max_priority,
        )
        self.name = "llm"

    def tags(self):
        return {"model": "demo-llm", "engine": "continuous-batching"}

    def save_checkpoint(self, path: str) -> str:
        """Export the served weights as a ``model_uri`` checkpoint (refused
        for int8 engines: see ``LLMEngine.save_checkpoint``)."""
        return self.engine.save_checkpoint(path)
