"""A decoder-only transformer served with int8 weights ("full": every
projection and the head on kernel K1) by the port's paged engine.

The configuration's file gives the model in its published keys
(``hidden_size``, ``num_attention_heads``, ...) and the engine in
``engine``.  The benchmark makes the weights itself, from the seed, on the
card, in the form they are served in: per-output-channel int8 values, each
layer's stored (out, in) so that its ``.t()`` is the K-major (in, out)
layout K1 reads, float32 scales, a bf16 embedding and float32 norm
scales.  The port is handed these tensors; the reference
(``references/transformer.py``) reads the same ones.  No float32 copy of a
layer's weights is made in set-up.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Dims", "dims", "make_weights", "program_params",
           "build_system", "counters", "projections"]

#: uniform int8 values in [-127, 127] have this standard deviation
_INT8_STD = (((255 ** 2) - 1) / 12) ** 0.5


@dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float


def dims(config: dict) -> Dims:
    D, H = config["hidden_size"], config["num_attention_heads"]
    return Dims(layers=config["num_hidden_layers"], d_model=D, heads=H,
                kv_heads=config["num_key_value_heads"], d_head=D // H,
                d_ff=config["intermediate_size"],
                vocab=config["vocab_size"],
                rope_theta=float(config["rope_theta"]),
                norm_eps=float(config["norm_epsilon"]))


def projections(d: Dims) -> dict:
    """Each layer's int8 products: name -> (out, in)."""
    return {"wq": (d.heads * d.d_head, d.d_model),
            "wk": (d.kv_heads * d.d_head, d.d_model),
            "wv": (d.kv_heads * d.d_head, d.d_model),
            "wo": (d.d_model, d.heads * d.d_head),
            "w1": (d.d_ff, d.d_model),
            "w2": (d.d_model, d.d_ff)}


def _seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def make_weights(config: dict, seed: int, device) -> dict:
    """The model's weights from ``seed``: one draw per kind of weight for
    every layer at once.  ``<name>`` (layers, out, in) int8 and
    ``<name>_s`` (layers, out) float32 per projection, ``head`` (vocab,
    d_model) int8 and ``head_s``, ``embed`` (vocab, d_model) bf16, ``ln1``,
    ``ln2`` (layers, d_model) and ``ln_f`` float32."""
    d = dims(config)
    g = torch.Generator(device=device).manual_seed(_seed(seed))
    w: dict = {}

    def int8(shape, fan_in):
        values = torch.randint(-127, 128, shape, dtype=torch.int8,
                               generator=g, device=device)
        # per-channel scales around fan_in^-1/2 / std: unit-variance rows
        scales = (torch.rand(shape[:-1], generator=g, device=device) + 0.5
                  ) * (fan_in ** -0.5 / _INT8_STD)
        return values, scales

    for name, (n_out, n_in) in projections(d).items():
        w[name], w[name + "_s"] = int8((d.layers, n_out, n_in), n_in)
    w["head"], w["head_s"] = int8((d.vocab, d.d_model), d.d_model)
    w["embed"] = torch.randn((d.vocab, d.d_model), generator=g,
                             device=device, dtype=torch.bfloat16)
    w["embed"].mul_(d.d_model ** -0.5)
    norms = torch.rand((2 * d.layers + 1, d.d_model), generator=g,
                       device=device) * 0.5 + 0.75
    w["ln1"], w["ln2"] = norms[:d.layers], norms[d.layers:2 * d.layers]
    w["ln_f"] = norms[-1]
    return w


def program_params(w: dict) -> dict:
    """The port's int8 param tree over the benchmark's tensors (views, no
    copies): per-layer lists of K-major (in, out) values and their
    scales."""
    layers = w["wq"].shape[0]
    blocks = {name: {"values": [w[name][i].t() for i in range(layers)],
                     "scales": [w[name + "_s"][i] for i in range(layers)]}
              for name in ("wq", "wk", "wv", "wo", "w1", "w2")}
    blocks["ln1"], blocks["ln2"] = w["ln1"], w["ln2"]
    return {"embed": w["embed"], "blocks": blocks, "ln_f": w["ln_f"],
            "lm_head": {"values": w["head"].t(), "scales": w["head_s"]}}


def build_system(config: dict, w: dict, device):
    """``(LLMComponent, PagedLLMEngine)`` of the port over ``w``, as
    ``config["engine"]`` sets it."""
    from seldon_core_tpu_torch.models.transformer import TransformerConfig
    from seldon_core_tpu_torch.runtime.llm import (
        LLMComponent,
        PagedLLMEngine,
    )
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    d, e = dims(config), config["engine"]
    cfg = TransformerConfig(
        vocab_size=d.vocab, d_model=d.d_model, n_layers=d.layers,
        n_heads=d.heads, n_kv_heads=d.kv_heads, d_ff=d.d_ff,
        max_seq=e["max_len"], rope_theta=d.rope_theta,
        dtype=getattr(torch, config["activation_dtype"]),
        use_flash=bool(e["flash_prefill"]))
    auto = e["auto_prefix_tokens"]
    engine = PagedLLMEngine(
        program_params(w), cfg,
        PagedConfig(n_pages=e["pages"], page_size=e["page_size"]),
        max_slots=e["max_slots"], max_len=e["max_len"],
        auto_prefix_tokens=4 * e["max_len"] if auto < 0 else auto,
        chunk_prefill=e["chunk_prefill"],
        batch_prefill_ms=e["batch_prefill_ms"])
    return LLMComponent(engine, n_new=1), engine


def counters(engine) -> dict:
    """The engine's program counters: per program its captures, replays,
    eager runs and the shape keys it holds captured."""
    st = engine.program_stats()["programs"]
    return {name: {"captures": p["captures"], "replays": p["replays"],
                   "eager_runs": p["eager_runs"],
                   "keys": sorted(p["capture_s"])}
            for name, p in st.items()}
