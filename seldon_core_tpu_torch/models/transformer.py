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

Tensor parallelism (``mesh=``, a :class:`~..parallel.mesh.Mesh` with a
"tp" axis) is the reference's Megatron pattern, run by one controller:
:func:`shard_params` splits wq/wk/wv by heads, wo and w2 by rows, w1 and the
lm_head by columns (:func:`param_specs`), each rank's piece a
:class:`~..parallel.mesh.Shards` entry on its device.  The residual stream,
the norms and the embedding live on rank 0's device; every rank runs its
heads' attention (the flash kernel K3 under ``use_flash``) and its share of
the FFN (the int8 kernel K1 on its w1 columns and w2 rows), and the
row-parallel partials meet in :func:`~..parallel.mesh.psum` (float32, rank
order).  The lm_head's vocabulary shards meet in an all-gather.  The KV
caches split their head axis the same way.  ``cfg.attention == "ring"``
prefills sequence-parallel instead: q/k/v move from heads to sequence
shards (an all-to-all), ring attention runs over "tp", and the output moves
back.  A dp axis splits the batch over groups of ranks that share devices.
Over a mesh whose ranks span processes (``parallel/mesh.py``
``process_mesh``) each process runs only its own ranks' share
(``rank_map``) and the collectives cross processes.  Serving (prefill,
decode, the engines) keeps the residual stream in every process that holds
a rank of its dp group, on its first local device; a dp group another
process holds is computed there and its rows shared after each sublayer.
:func:`decode_step` decodes against a slab cache (:func:`init_cache`), one
token or a K-token chunk per row, writing the new K/V rows in place;
:func:`generate` and :func:`speculative_generate` are the reference's
one-request loops over it.

Mixture of experts (``cfg.n_experts > 0``): each block's FFN is
``blocks["moe"]`` (``router`` (L, D, E), ``w_in`` (L, E, D, F), ``w_out``
(L, E, F, D); ``parallel/moe.py``), routed over every token of the call;
:func:`ffn_block` returns the block's output and its aux loss, as the
reference's does, on every path (serving included).

Training: :func:`forward` (logits in float32 and the summed MoE aux),
:func:`lm_loss` and :func:`make_train_step` (AdamW, params updated in
place).  Under a mesh :func:`forward` runs the reference's layout with one
controller: the batch over "dp" groups, heads and ``d_ff`` over "tp" (ring
attention over "tp" under ``attention="ring"``), experts over "dp", and with
``cfg.seq_shard`` the residual stream and the norms as sequence shards over
"tp" between blocks (an all-gather before the column-parallel products,
the row-parallel partials summed in float32 and split back).  ``pp > 1``
runs the layer stack's stages through the GPipe schedule
(``parallel/pipeline.py``).  A leaf replicated over ranks is one tensor,
copied to each rank inside the forward, so autograd sums its gradient over
the ranks: that sum is the data-parallel all-reduce.  The flash kernel is
differentiable (``ops/attention.py`` ``FlashAttention``).

The training forward keeps every value where the single controller keeps
it, on one rank: the embedding, each stage's input and output, the MoE's
routing over the global batch, the logits and the loss on the stage's (or
the mesh's) first rank, the sequence shards and the heads on their ranks.
Every move between ranks is a ``parallel/mesh.py`` move (``scatter``,
``gather``, the collectives), so over a mesh whose dp, pp and tp axes
cross processes each process computes its own ranks' values, the moves
cross processes both ways under autograd, and a leaf that several ranks
use reaches each through its own view (``rank_views``), its gradient the
sum of theirs in rank order, whichever processes keep copies.  The
loss is computed on the first rank and handed to every process
(``share``), so each process reports the same loss and its backward runs
the whole step's backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from seldon_core_tpu_torch.ops.attention import flash_attention
from seldon_core_tpu_torch.ops.quant import (
    QuantizedLinear,
    int8_matmul,
    k_major,
    quantize_int8,
)
from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    MeshPlanError,
    Ranks,
    Shards,
    all_gather,
    all_to_all,
    exchange_tape,
    first_device,
    gather,
    named_sharding,
    place,
    pspec,
    psum,
    psum_scatter,
    RankViews,
    rank_map,
    rank_views,
    scatter,
    share,
    unshard,
)
from seldon_core_tpu_torch.parallel.moe import (
    MoEConfig,
    moe_forward,
    moe_param_specs,
)
from seldon_core_tpu_torch.parallel.pipeline import pipeline_apply
from seldon_core_tpu_torch.parallel.ring_attention import (
    dense_attention,
    ring_attention,
)

__all__ = [
    "TransformerConfig", "init_params", "init_params_int8", "param_specs",
    "shard_params", "cast_params", "quantize_ffn_params",
    "quantize_attn_params",
    "rmsnorm", "rope", "attention_block", "ffn_block", "block_fn",
    "forward", "lm_loss", "make_train_step", "param_leaves", "prefill",
    "has_quantized_params", "init_cache", "decode_step", "generate",
    "speculative_generate",
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
    n_experts: int = 0          # 0: dense FFN; > 0: MoE in every layer
    top_k: int = 2
    capacity_factor: float = 2.0
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16  # activation dtype
    # grouped-query attention: K/V heads (None = n_heads, plain MHA)
    n_kv_heads: Optional[int] = None
    # flash-attention kernel (K3) on the prefill path instead of dense
    use_flash: bool = False
    # "dense" (heads over tp) or "ring" (the sequence over tp: ring
    # attention, parallel/ring_attention.py); ring needs a mesh with tp > 1
    attention: str = "dense"
    # ring attention's score tile bound: keys per inner step (None: the
    # whole block a rank holds)
    ring_kv_chunk: Optional[int] = None
    # Megatron sequence parallelism under a mesh: the residual stream and
    # the norms as sequence shards over "tp" between blocks
    seq_shard: bool = True
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False

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

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         d_model=self.d_model, d_ff=self.d_ff,
                         expert_axis="dp")


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
    }
    if cfg.n_experts > 0:
        E = cfg.n_experts
        blocks["moe"] = {
            "router": _normal(gen, (L, D, E), s, device),
            "w_in": _normal(gen, (L, E, D, Fd), s, device),
            "w_out": _normal(gen, (L, E, Fd, D), Fd ** -0.5, device),
        }
    else:
        blocks["w1"] = _normal(gen, (L, D, Fd), s, device)
        blocks["w2"] = _normal(gen, (L, Fd, D), Fd ** -0.5, device)
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
                     device=None, int8: str = "full") -> dict:
    """int8 params made layer by layer on ``device``: each layer's float32
    weights exist only while that layer is quantized, so the float32 master
    copy of a large model (21 GB at 7B) never exists whole.

    - ``int8="full"``: the layout of
      ``quantize_attn_params(quantize_ffn_params(init_params(...)))``;
    - ``int8="ffn"``: the layout of ``quantize_ffn_params(init_params(...))``
      with the attention projections stacked in ``cfg.dtype`` (the same
      draws, reshaped).

    The embedding is stored in ``cfg.dtype`` (the reference's 7B weight
    init, ``bench.py`` ``_init_7b_int8``, does the same)."""
    if int8 not in ("full", "ffn"):
        raise ValueError(f"int8 must be full or ffn, not {int8!r}")
    device = gen.device if device is None else device
    D, H, Dh, Fd, L = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                       cfg.n_layers)
    Hk = cfg.kv_heads
    s = D ** -0.5
    shapes = {
        "wq": ((D, H * Dh), s), "wk": ((D, Hk * Dh), s),
        "wv": ((D, Hk * Dh), s), "wo": ((H * Dh, D), s),
        "w1": ((D, Fd), s), "w2": ((Fd, D), Fd ** -0.5),
    }
    stacked = {"wq": (D, H, Dh), "wk": (D, Hk, Dh), "wv": (D, Hk, Dh),
               "wo": (H, Dh, D)} if int8 == "ffn" else {}
    blocks: dict = {name: {"values": [], "scales": []} for name in shapes}
    for name, shape in stacked.items():
        blocks[name] = torch.empty((L, *shape), dtype=cfg.dtype,
                                   device=device)
    for i in range(L):
        for name, (shape, scale) in shapes.items():
            w = _normal(gen, shape, scale, device)
            if name in stacked:
                blocks[name][i] = w.reshape(stacked[name])
                continue
            q = _q8(w)
            blocks[name]["values"].append(q["values"])
            blocks[name]["scales"].append(q["scales"])
    blocks["ln1"] = torch.ones((L, D), device=device)
    blocks["ln2"] = torch.ones((L, D), device=device)
    embed = _normal(gen, (cfg.vocab_size, D), s, device).to(cfg.dtype)
    return {
        "embed": embed,
        "blocks": blocks,
        "ln_f": torch.ones((D,), device=device),
        "lm_head": _q8(_normal(gen, (D, cfg.vocab_size), s, device)),
    }


def cast_params(params, dtype=torch.bfloat16):
    """Master params cast to the serving dtype once: a new tree with every
    tensor in ``dtype`` (one already in it is shared, not copied);
    ``params`` is left as it was.  The forward casts per use, which costs
    nothing when the weights are already in the activations' dtype and
    reads the float32 copy every step otherwise."""
    if isinstance(params, torch.Tensor):
        return params.to(dtype)
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype) for v in params)
    return params


def quantize_ffn_params(params: dict, mesh: Optional[Mesh] = None) -> dict:
    """Each block's w1/w2 and the lm_head to per-channel int8, unstacked
    per layer.  Quantization is over the GLOBAL weight (per output column),
    whether or not ``params`` is placed.  With ``mesh`` the int8 leaves are
    placed tensor-parallel (:func:`shard_params`): w1 and its scales by
    column, w2 by row with its scales whole on every rank, the lm_head by
    column; a column's scale shards with it, so each rank's product is
    exact."""
    out = dict(params)
    blocks = dict(params["blocks"])
    ffn = ("w1", "w2") if "w1" in blocks else ()  # a MoE keeps its experts
    for name in ffn:
        w = unshard(blocks[name])
        qs = [quantize_int8(w[i]) for i in range(w.shape[0])]
        blocks[name] = {"values": [q.values for q in qs],
                        "scales": [q.scales for q in qs]}
    out["blocks"] = blocks
    out["lm_head"] = _q8(unshard(params["lm_head"]))
    if mesh is not None:
        for name in ffn:
            blocks[name] = _place_q8(blocks[name], mesh, name)
        out["lm_head"] = _place_q8(out["lm_head"], mesh, "lm_head")
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


def _check_q8_pipeline(params: dict, pp: int) -> None:
    """int8 leaves are per-layer lists, which pipeline stages cannot split:
    refused up front under pp, as the reference does."""
    if pp > 1 and has_quantized_params(params):
        raise ValueError(
            "int8-quantized params cannot ride the pp pipeline (per-layer "
            "unstacked tuples are not scannable); use pp=1")


def has_quantized_params(params: dict) -> bool:
    """Whether a param tree carries int8 leaves (in its blocks or the
    lm_head): the checkpoint export refusal and the verbatim load path."""
    return (any(_is_q8(v) for v in params.get("blocks", {}).values())
            or _is_q8(params.get("lm_head")))


def _layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``: stacked leaves sliced on the layer dim (each rank's
    piece of a placed leaf, nested pieces included), int8 per-layer lists
    indexed.  A tree split over pipeline stages takes its stage first
    (``parallel/pipeline.py`` ``stage_slice``)."""
    def one(v):
        if _is_q8(v):
            return {"values": v["values"][i], "scales": v["scales"][i]}
        if isinstance(v, dict):
            return {k: one(t) for k, t in v.items()}
        if isinstance(v, Shards):
            if v.axis == "pp":
                raise ValueError("a tree placed over pipeline stages: take "
                                 "its stage first (forward with pp)")
            return Shards([None if t is None else one(t) for t in v],
                          None if v.dim is None else v.dim - 1, v.axis)
        if isinstance(v, RankViews):
            return v.map(lambda t: t[i])
        return None if v is None else v[i]

    return {k: one(v) for k, v in blocks.items()}


# ----------------------------------------------------------------------
# tensor-parallel placement
# ----------------------------------------------------------------------

#: placement of the per-layer int8 leaves (values, scales): w1 and the
#: lm_head by column with their scales, w2 by row with its scales whole
Q8_SPECS = {"w1": (pspec(None, "tp"), pspec("tp")),
            "w2": (pspec("tp", None), pspec(None)),
            "lm_head": (pspec(None, "tp"), pspec("tp"))}


def param_specs(cfg: TransformerConfig, pp: int = 1) -> dict:
    """Placement spec per float leaf (Megatron): q/k/v heads and w1 columns
    over "tp", wo and w2 rows over "tp", the lm_head's vocabulary over
    "tp"; MoE experts over "dp" and their ``d_ff`` over "tp"
    (``moe_param_specs``); the stacked layer dim over "pp" when
    pipelining."""
    b = "pp" if pp > 1 else None
    block = {
        "ln1": pspec(b, None),
        "ln2": pspec(b, None),
        "wq": pspec(b, None, "tp", None),
        "wk": pspec(b, None, "tp", None),
        "wv": pspec(b, None, "tp", None),
        "wo": pspec(b, "tp", None, None),
    }
    if cfg.n_experts > 0:
        block["moe"] = {k: pspec(b, *sp) for k, sp in
                        moe_param_specs(cfg.moe_cfg()).items()}
    else:
        block["w1"] = pspec(b, None, "tp")
        block["w2"] = pspec(b, "tp", None)
    return {"embed": pspec(None, None), "blocks": block, "ln_f": pspec(None),
            "lm_head": pspec(None, "tp")}


def _check_serving_mesh(mesh: Mesh) -> None:
    if mesh.axis_size("pp") > 1:
        raise NotImplementedError(
            "the pp pipeline runs in forward and training only "
            "(forward(..., pp=) / make_train_step); serve over dp and tp")


def _place_q8(leaf: dict, mesh: Mesh, name: str) -> dict:
    """A global int8 leaf (per-layer lists, or one tensor for the lm_head)
    placed by :data:`Q8_SPECS`; each rank's values stay K-major and a whole
    scale vector is copied to every rank."""
    vspec, sspec = Q8_SPECS[name]

    def put(t, spec, layout=None):
        t = unshard(t)
        if "tp" not in spec:
            return Shards([None if d is None else t.to(d) for d in (
                mesh.holder_device(tp=r)
                for r in range(mesh.axis_size("tp")))], None)
        return place(t, named_sharding(mesh, *spec), layout=layout)

    if isinstance(leaf["values"], list):
        return {"values": [put(v, vspec, k_major) for v in leaf["values"]],
                "scales": [put(v, sspec) for v in leaf["scales"]]}
    return {"values": put(leaf["values"], vspec, k_major),
            "scales": put(leaf["scales"], sspec)}


def shard_params(params: dict, mesh: Mesh, cfg: TransformerConfig,
                 pp: int = 1) -> dict:
    """Place a param tree over ``mesh`` (:func:`param_specs`): each split
    leaf becomes a :class:`Shards` of its pieces, one per rank on that
    rank's device (nested for several axes: the layer stack's stages over
    "pp" when ``pp > 1``, MoE experts over "dp", heads, columns or rows over
    "tp"); a replicated leaf (the embedding, the norms, the router) is one
    tensor on the first device of its group.  Every piece owns its storage.
    int8 w1/w2/lm_head leaves (quantized over the global weight) take
    :data:`Q8_SPECS`, which equals quantizing the placed float tree; int8
    attention projections are refused (single-device serving only), and
    int8 leaves under pp.  wk/wv split their KV heads, so ``cfg.kv_heads``
    must divide by tp."""
    _check_q8_pipeline(params, pp)
    tp = mesh.axis_size("tp")
    if cfg.kv_heads % tp:
        raise ValueError(
            f"n_kv_heads {cfg.kv_heads} must be divisible by tp {tp}: wk/wv "
            "shard their head dim over 'tp' (KV-head replication across tp "
            "is not implemented — lower tp or raise n_kv_heads)")
    specs = param_specs(cfg, pp)

    def put(t, spec):
        return place(unshard(t), named_sharding(mesh, *spec))

    blocks = {}
    for name, leaf in params["blocks"].items():
        if _is_q8(leaf):
            if name not in Q8_SPECS:
                _check_q8_attn_single_chip({"wq": leaf}, mesh)
            blocks[name] = _place_q8(leaf, mesh, name)
        elif isinstance(leaf, dict):  # the MoE's leaves
            blocks[name] = {k: put(v, specs["blocks"][name][k])
                            for k, v in leaf.items()}
        else:
            blocks[name] = put(leaf, specs["blocks"][name])
    lm = params["lm_head"]
    return {
        "embed": put(params["embed"], specs["embed"]),
        "blocks": blocks,
        "ln_f": put(params["ln_f"], specs["ln_f"]),
        "lm_head": (_place_q8(lm, mesh, "lm_head") if _is_q8(lm)
                    else put(lm, specs["lm_head"])),
    }


def _check_q8_attn_single_chip(p: dict, mesh) -> None:
    if mesh is not None and _is_q8(p.get("wq")):
        raise ValueError(
            "int8 attention projections are single-chip serving only "
            "(the pallas kernel cannot be partitioned by GSPMD; FFN/lm_head "
            "tp-sharding goes through quantize_ffn_params(mesh=...))")


def _use(leaf, rank: int, dev):
    """Mesh rank ``rank``'s copy of a leaf on ``dev``: through its own view
    when the leaf has per-rank views (``parallel/mesh.py`` ``rank_views``,
    the training forward's)."""
    if isinstance(leaf, RankViews):
        leaf = leaf.at(rank)
    return leaf.to(dev)


def _part(leaf, r: int, dev, rank: Optional[int] = None):
    """Piece ``r`` (the tp rank's) of a placed leaf (float or int8) on
    ``dev``, as mesh rank ``rank`` uses it."""
    if _is_q8(leaf):
        return {"values": _part(leaf["values"], r, dev),
                "scales": _part(leaf["scales"], r, dev)}
    if not isinstance(leaf, Shards):
        raise ValueError("params on a mesh must be placed first "
                         "(shard_params / quantize_ffn_params(mesh=...))")
    return _use(leaf[r], rank, dev)


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
                    return_kv: bool = False, mesh: Optional[Mesh] = None):
    """Causal self-attention.  ``return_kv`` also returns the post-rope K/V
    (at ``kv_heads``) for the KV cache.  With ``cfg.use_flash`` the flash
    kernel reads the un-expanded K/V itself; the dense path expands first.
    With ``mesh`` (tensor-parallel, module docstring) the K/V returned are
    :class:`Shards` split on their head axis."""
    if mesh is not None:
        return _over_dp(mesh, x.shape[0], lambda devs, rows: _tp_attention(
            p, x[rows], positions[rows] if positions.shape[0] > 1
            else positions, cfg, devs, return_kv), kv=return_kv)
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


def _moe_ffn(p, x, cfg: TransformerConfig):
    """The MoE FFN over every token of ``x`` (B, L, D) on one device:
    routing over all B * L of them, the experts' weights cast to the
    activation dtype (the reference's).  Under a mesh: :func:`_mesh_moe`."""
    h = rmsnorm(x, p["ln2"])
    B, L, D = h.shape
    y, aux = moe_forward(p["moe"], h.reshape(B * L, D), cfg.moe_cfg())
    return x + y.reshape(B, L, D), aux


def ffn_block(p, x, cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """The FFN sublayer; returns ``(x + ffn, aux)``.  A MoE block
    (``p["moe"]``) returns its load-balancing aux loss, routed over every
    token of the call (a decode step's rows, empty slots included); the
    dense FFN (tanh GELU; int8 weights take the int8 kernel) returns aux
    0.0.  With ``mesh``: the dense FFN's w1 columns and w2 rows per rank,
    the partials summed in float32 (:func:`_tp_ffn`); the MoE's experts on
    their dp groups' ranks (:func:`_mesh_moe`)."""
    if mesh is not None:
        if "moe" in p:
            xs, aux = _mesh_moe(p, [x], cfg, _groups(mesh))
            return xs[0], aux
        return _over_dp(mesh, x.shape[0], lambda devs, rows: _tp_ffn(
            p, x[rows], cfg, devs)), 0.0
    if "moe" in p:
        return _moe_ffn(p, x, cfg)
    h = rmsnorm(x, p["ln2"])
    if _is_q8(p["w1"]):
        B, L, D = h.shape
        h1 = _q8_matmul(h.reshape(B * L, D), p["w1"], x.dtype)
        h1 = F.gelu(h1, approximate="tanh")
        out = _q8_matmul(h1, p["w2"], x.dtype).reshape(B, L, D)
        return x + out, 0.0
    h1 = torch.einsum("bld,df->blf", h, p["w1"].to(x.dtype))
    h1 = F.gelu(h1, approximate="tanh")
    return x + torch.einsum("blf,fd->bld", h1, p["w2"].to(x.dtype)), 0.0


def block_fn(p, x, positions, cfg: TransformerConfig):
    """One block on one device: ``(x, aux)``."""
    x = attention_block(p, x, positions, cfg)
    return ffn_block(p, x, cfg)


def _embed(params: dict, ids, cfg: TransformerConfig):
    # the reference casts the table then indexes; indexing first gives the
    # same values without casting the whole table
    return params["embed"][ids].to(cfg.dtype)


def _vocab_proj(x, lm_head, cfg: TransformerConfig,
                mesh: Optional[Mesh] = None):
    if mesh is not None:
        return _over_dp(mesh, x.shape[0], lambda devs, rows: _tp_vocab(
            x[rows], lm_head, cfg, devs))
    if _is_q8(lm_head):
        B, L, D = x.shape
        return _q8_matmul(x.reshape(B * L, D), lm_head, cfg.dtype).reshape(
            B, L, -1)
    return torch.einsum("bld,dv->blv", x, lm_head.to(cfg.dtype))


# ----------------------------------------------------------------------
# tensor-parallel layers: one controller, each rank's share on its device
# ----------------------------------------------------------------------

def _held(devs) -> bool:
    """Whether this process holds a rank of ``devs``."""
    return any(d is not None for d in devs)


def _dp_rows(mesh: Mesh, B: int) -> tuple:
    """The serving mesh's dp groups: each group's tp devices (a
    :class:`Ranks`) and its even share of the B rows (a slice).  In one
    process the groups must share their devices (a dp axis over distinct
    devices is one engine per group); across processes each process
    computes the groups it holds a rank of."""
    _check_serving_mesh(mesh)
    dp = mesh.axis_size("dp")
    if dp == 1:
        return [mesh.axis_devices("tp")], [slice(None)]
    if B % dp:
        raise ValueError(f"batch {B} must divide by dp {dp}")
    groups = [mesh.axis_devices("tp", dp=d) for d in range(dp)]
    if not mesh.spans_processes and any(list(g) != list(groups[0])
                                        for g in groups):
        raise NotImplementedError(
            "a dp axis over distinct devices: serve one engine per dp "
            "group")
    n = B // dp
    return groups, [slice(d * n, (d + 1) * n) for d in range(dp)]


def _everywhere(outs: list, groups: list) -> list:
    """Each dp group's output (``None`` for a group this process holds no
    rank of) in every process: across processes each group's comes from
    the process of its first rank (one group: every process has it)."""
    mesh = groups[0].mesh
    if not mesh.spans_processes or len(groups) == 1:
        return outs
    return gather(outs, Ranks.of(mesh, [g.ids[0] for g in groups]), None,
                  list, None)


def _over_dp(mesh: Mesh, B: int, fn, kv: bool = False):
    """``fn(tp devices, rows)`` for each dp group (:func:`_dp_rows`) this
    process holds, the results concatenated on rows (on its first local
    device; K/V :class:`Shards` rank by rank, across processes with zeros
    in the rows of a group another process computes)."""
    groups, rows = _dp_rows(mesh, B)
    outs = [fn(devs, r) if _held(devs) else None
            for devs, r in zip(groups, rows)]
    if len(outs) == 1:
        return outs[0]
    if not kv:
        return torch.cat(_everywhere(outs, groups), dim=0)
    xs = torch.cat(_everywhere([None if o is None else o[0] for o in outs],
                               groups), dim=0)

    def rows_of(j):  # K (j = 0) or V (1) of every group, tp rank by rank
        per = [None if o is None else o[1][j] for o in outs]
        parts = []
        for t in range(len(groups[0])):
            mine = [s[t] for s in per if s is not None and s[t] is not None]
            parts.append(None if not mine else torch.cat(
                [s[t] if s is not None and s[t] is not None
                 else torch.zeros_like(mine[0]) for s in per], dim=0))
        return Shards(parts, next(s for s in per if s is not None).dim)

    return xs, (rows_of(0), rows_of(1))


def _norm_gather(xg, scale, devs: Ranks, src: Optional[int] = None) -> list:
    """One dp group's residual normed and whole on every tp rank: sequence
    shards (a list) are normed shard by shard and all-gathered on the
    sequence; a whole residual is normed once and copied (from rank
    ``src``, the one that holds it, when given; else every process holding
    a rank of the group holds it)."""
    if isinstance(xg, list):
        return all_gather([None if x is None else rmsnorm(x, _use(
            scale, i, x.device)) for x, i in zip(xg, devs.ids)], dim=1,
            ranks=devs)
    if src is not None:
        h = None if xg is None else rmsnorm(xg, _use(scale, src, xg.device))
        return scatter(h, src, devs, lambda h: [(slice(None),)] * len(devs))
    h = rmsnorm(xg, _use(scale, devs.ids[0], xg.device))
    return [None if d is None else h.to(d) for d in devs]


def _add_partials(xg, partials: list, devs: Ranks, dtype):
    """The residual plus the row-parallel partials' float32 sum (cast to
    ``dtype``), split back onto the sequence shards (reduce-scatter) or
    added whole (where this process holds the residual)."""
    if isinstance(xg, list):
        return [None if x is None else x + piece for x, piece in zip(
            xg, psum_scatter(partials, dim=1, dtype=dtype, ranks=devs))]
    total = psum(partials, dtype=dtype, ranks=devs)
    return None if xg is None else xg + total.first.to(xg.device)


def _rank_qkv(p, h, positions, cfg: TransformerConfig, devs: list):
    """Each rank's post-rope q (B, L, H/tp, Dh) and k, v (B, L, Hkv/tp,
    Dh) of its heads, on its device (``None`` at another process's
    ranks).  ``h`` is one tensor, or one per rank (an all-gather's)."""
    tp = len(devs)
    H, Hk, Dh = cfg.n_heads // tp, cfg.kv_heads // tp, cfg.d_head

    def one(r, dev):
        hr = (h[r] if isinstance(h, list) else h).to(dev)
        pr = positions.to(dev)
        i = devs.ids[r]
        q = _attn_proj(hr, _part(p["wq"], r, dev, i), H, Dh, hr.dtype)
        k = _attn_proj(hr, _part(p["wk"], r, dev, i), Hk, Dh, hr.dtype)
        v = _attn_proj(hr, _part(p["wv"], r, dev, i), Hk, Dh, hr.dtype)
        return (rope(q, pr, cfg.rope_theta), rope(k, pr, cfg.rope_theta),
                v, pr)

    return rank_map(one, devs)


def _field(per_rank: list, i: int) -> list:
    """Item ``i`` of each rank's tuple (``None`` stays ``None``)."""
    return [None if t is None else t[i] for t in per_rank]


def _tp_attn_out(p, x, attns: list, devs: Ranks, dtype):
    """``x`` (a tensor, or its sequence shards) plus the row-parallel output
    projection: each rank's heads through its wo rows, the partials summed
    (:func:`_add_partials`) in ``dtype``, the residual's."""
    return _add_partials(x, rank_map(
        lambda r, dev, a: _attn_out(a.to(dtype), _part(
            p["wo"], r, dev, devs.ids[r]), dtype),
        devs, attns), devs, dtype)


def _rank_attention(qkv: list, cfg: TransformerConfig, devs: Ranks) -> list:
    """Each rank's attention over its heads (K3 under ``use_flash``), or
    under ``cfg.attention == "ring"`` (tp > 1): q/k/v from head to sequence
    shards (all-to-all), ring attention over the ranks with the K/V at
    kv_heads, and the output back to head shards."""
    if cfg.attention == "ring" and len(devs) > 1:
        # heads -> sequence: rank r holds every head of sequence block r
        q_seq = all_to_all(_field(qkv, 0), 1, 2, ranks=devs)
        k_seq = all_to_all(_field(qkv, 1), 1, 2, ranks=devs)
        v_seq = all_to_all(_field(qkv, 2), 1, 2, ranks=devs)
        out_seq = ring_attention(q_seq, k_seq, v_seq, causal=True,
                                 kv_chunk=cfg.ring_kv_chunk,
                                 n_rep=cfg.n_heads // cfg.kv_heads,
                                 ranks=devs)
        return all_to_all(out_seq, 2, 1, ranks=devs)  # sequence -> heads
    if cfg.use_flash:
        return rank_map(lambda r, d, t: flash_attention(t[0], t[1], t[2],
                                                        causal=True),
                        devs, qkv)
    return rank_map(lambda r, d, t: dense_attention(
        t[0], _expand_kv(t[1], cfg), _expand_kv(t[2], cfg), causal=True),
        devs, qkv)


def _tp_attention(p, x, positions, cfg: TransformerConfig, devs: Ranks,
                  return_kv: bool, on_first_rank: bool = False):
    """The attention sublayer over ``devs`` (one dp group's tp ranks);
    ``x`` is one tensor, or its sequence shards, one a rank (Megatron
    sequence parallelism: normed shard by shard, gathered, the output
    reduce-scattered back).  A whole ``x`` is held by every process that
    holds a rank of the group, or with ``on_first_rank`` by the group's
    first rank only (the training forward's layout).
    Dense: each rank attends over its heads (K3 under ``use_flash``).
    Ring (``cfg.attention == "ring"``, tp > 1): q/k/v move from head to
    sequence shards (all-to-all), ring attention runs over the ranks with
    the K/V at kv_heads, and the output moves back to head shards; the K/V
    for the cache stay head shards throughout."""
    _check_q8_attn_single_chip(p, devs)
    src = devs.ids[0] if on_first_rank and not isinstance(x, list) else None
    qkv = _rank_qkv(p, _norm_gather(x, p["ln1"], devs, src), positions, cfg,
                    devs)
    ks = Shards(_field(qkv, 1), 2)
    vs = Shards(_field(qkv, 2), 2)
    out = _tp_attn_out(p, x, _rank_attention(qkv, cfg, devs), devs,
                       cfg.dtype)
    if return_kv:
        return out, (ks, vs)
    return out


def _ffn_partials(p, h, cfg: TransformerConfig, devs: list) -> list:
    """Each rank's w1 columns, GELU and w2 rows: the row-parallel partials
    (int8: K1 per rank, its w2 input quantized per row over the rank's own
    hidden shard, as the reference's ``_q8_ffn_local``, partials in
    float32).  ``h`` is one tensor, or one per rank."""

    def one(r, dev):
        hr = (h[r] if isinstance(h, list) else h).to(dev)
        B, L, D = hr.shape
        w1 = _part(p["w1"], r, dev, devs.ids[r])
        w2 = _part(p["w2"], r, dev, devs.ids[r])
        if _is_q8(p["w1"]):
            h1 = _q8_matmul(hr.reshape(B * L, D), w1, hr.dtype)
            h1 = F.gelu(h1, approximate="tanh")
            return _q8_matmul(h1, w2, torch.float32).reshape(B, L, D)
        h1 = torch.einsum("bld,df->blf", hr, w1.to(hr.dtype))
        h1 = F.gelu(h1, approximate="tanh")
        return torch.einsum("blf,fd->bld", h1, w2.to(hr.dtype))

    return rank_map(one, devs)


def _tp_ffn(p, x, cfg: TransformerConfig, devs: Ranks,
            on_first_rank: bool = False):
    """The dense FFN sublayer over one dp group's tp ranks (``x`` as
    :func:`_tp_attention` takes it): the row-parallel partials summed in
    float32 and cast."""
    src = devs.ids[0] if on_first_rank and not isinstance(x, list) else None
    return _add_partials(x, _ffn_partials(
        p, _norm_gather(x, p["ln2"], devs, src), cfg, devs), devs, cfg.dtype)


def _vocab_rank(xr, w, q8: bool, cfg: TransformerConfig):
    """One rank's vocabulary columns of ``xr`` (B, L, D)."""
    if q8:
        B, L, D = xr.shape
        return _q8_matmul(xr.reshape(B * L, D), w, cfg.dtype).reshape(
            B, L, -1)
    return torch.einsum("bld,dv->blv", xr, w.to(cfg.dtype))


def _tp_vocab(x, lm_head, cfg: TransformerConfig, devs: Ranks):
    """Each rank's vocabulary columns, all-gathered on the last dim."""
    return all_gather(rank_map(lambda r, dev: _vocab_rank(
        x.to(dev), _part(lm_head, r, dev, devs.ids[r]), _is_q8(lm_head),
        cfg), devs), dim=-1, ranks=devs).first.to(x.device)


# ----------------------------------------------------------------------
# training: the forward over a mesh, the loss, the train step
# ----------------------------------------------------------------------

def _groups(mesh: Mesh, stage: int = 0) -> list:
    """The tp devices (a :class:`Ranks`) of each dp group at pipeline stage
    ``stage``."""
    return [mesh.axis_devices("tp", dp=g, pp=stage)
            for g in range(mesh.axis_size("dp"))]


def _row_layout(groups: list, sp: bool) -> tuple:
    """Where a (B, L, D) activation of one stage lives between its layers:
    ``(ranks, index, combine, split)``.  Under sequence sharding each dp
    group's rows split over its tp ranks on the sequence (one piece a
    rank, in rank order), else each group's rows whole on its first rank;
    ``index(x)`` gives each piece's slice of the whole, ``combine`` puts
    the pieces back together, ``split`` is its inverse."""
    dp, tp = len(groups), len(groups[0])
    if sp:
        ranks = [i for g in groups for i in g.ids]

        def index(x):
            n, l = x.shape[0] // dp, x.shape[1] // tp
            return [(slice(g * n, (g + 1) * n), slice(t * l, (t + 1) * l))
                    for g in range(dp) for t in range(tp)]

        def combine(ps):
            return torch.cat([torch.cat(ps[g * tp:(g + 1) * tp], dim=1)
                              for g in range(dp)], dim=0)

        def split(y):
            return [c for yg in torch.chunk(y, dp, dim=0)
                    for c in torch.chunk(yg, tp, dim=1)]
    else:
        ranks = [g.ids[0] for g in groups]

        def index(x):
            n = x.shape[0] // dp
            return [(slice(g * n, (g + 1) * n),) for g in range(dp)]

        def combine(ps):
            return torch.cat(ps, dim=0)

        def split(y):
            return list(torch.chunk(y, dp, dim=0))
    return Ranks.of(groups[0].mesh, ranks), index, combine, split


def _mesh_moe(p, xs: list, cfg: TransformerConfig, groups: list,
              root: Optional[int] = None):
    """The MoE sublayer over every dp group's rows at once (the reference's
    routing covers the global batch): the groups' normed rows meet in one
    place, the experts run on their groups' ranks, and each group takes
    its rows of the output back.

    - ``root`` given (the training forward): ``xs`` holds each group's
      sequence shards, or its rows on its first rank; the rows meet at rank
      ``root``, which routes them, and go back to their ranks; the aux loss
      is ``root``'s (``None`` in other processes).
    - ``root=None`` (serving): every process that holds a rank of a group
      holds its rows (``None`` for another process's group); every process
      routes every row.  ``[x]`` (one entry, every row) skips the meeting."""
    scale = p["ln2"]
    mesh = groups[0].mesh
    if root is None and len(xs) == 1:  # every row, in every process
        x = xs[0]
        h = rmsnorm(x, _use(scale, groups[0].ids[0], x.device))
        B, L, D = h.shape
        y, aux = moe_forward(p["moe"], h.reshape(B * L, D), cfg.moe_cfg(),
                             groups=groups, root=None)
        return [x + y.reshape(B, L, D).to(x.device)], aux
    sp = isinstance(xs[0], list)
    ranks, index, combine, split = _row_layout(groups, sp)
    flat = [x for xg in xs for x in xg] if sp else list(xs)
    normed = [None if x is None else rmsnorm(x, _use(scale, i, x.device))
              for x, i in zip(flat, ranks.ids)]
    h = gather(normed, ranks, root, combine, split)
    hf = None
    if h is not None:
        B, L, D = h.shape
        hf = h.reshape(B * L, D)
    y, aux = moe_forward(p["moe"], hf, cfg.moe_cfg(), groups=groups,
                         root=root, dtype=cfg.dtype)
    if y is not None:
        y = y.reshape(B, L, D)
    if root is None:
        ys = torch.chunk(y, len(xs), dim=0)
        return [None if xg is None else xg + yg.to(xg.device)
                for xg, yg in zip(xs, ys)], aux
    back = scatter(y, root, ranks, index)
    out = [None if x is None else x + b for x, b in zip(flat, back)]
    tp = len(groups[0])
    if sp:
        out = [out[g * tp:(g + 1) * tp] for g in range(len(groups))]
    return out, aux


def _mesh_ffn(p, xs: list, cfg: TransformerConfig, groups: list,
              root: Optional[int] = None):
    """The FFN sublayer over every dp group's rows ``xs``: ``(xs, aux)``.
    A MoE routes every group's rows together (:func:`_mesh_moe`); the dense
    FFN runs group by group (:func:`_tp_ffn`; with ``root`` a whole
    group's rows sit on its first rank)."""
    if "moe" in p:
        return _mesh_moe(p, xs, cfg, groups, root)
    return [_tp_ffn(p, xg, cfg, devs, on_first_rank=root is not None)
            if _held(devs) else xg for xg, devs in zip(xs, groups)], 0.0


def _mesh_block(p, xs: list, positions, cfg: TransformerConfig,
                groups: list, root: int):
    """One block over every dp group (the training layout): ``(xs, aux)``."""
    xs = [_tp_attention(p, xg, positions, cfg, devs, False,
                        on_first_rank=True) if _held(devs) else xg
          for xg, devs in zip(xs, groups)]
    return _mesh_ffn(p, xs, cfg, groups, root)


def _mesh_layers(blocks: dict, x, positions, cfg: TransformerConfig,
                 mesh: Mesh, stage: int = 0, n_layers: Optional[int] = None):
    """The ``n_layers`` layers of ``blocks`` (the stage's) over stage
    ``stage``'s ranks: ``x`` (B, L, D), on the stage's first rank (``None``
    in other processes), split over the dp groups (and over each group's
    tp ranks on the sequence under ``cfg.seq_shard``), every layer run,
    the result gathered back onto that rank.  Returns ``(x, aux)`` there
    (``(None, None)`` in other processes)."""
    groups = _groups(mesh, stage)
    root = groups[0].ids[0]
    dp, tp = len(groups), len(groups[0])
    sp = cfg.seq_shard and tp > 1
    aux = None
    if x is not None:
        B, L, _ = x.shape
        if B % dp:
            raise ValueError(f"batch {B} must divide by dp {dp}")
        if sp and L % tp:
            raise ValueError(f"sequence {L} must divide by tp {tp} under "
                             "seq_shard")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ranks, index, combine, split = _row_layout(groups, sp)
    pieces = scatter(x, root, ranks, index)
    xs = [pieces[g * tp:(g + 1) * tp] for g in range(dp)] if sp else pieces
    for i in range(cfg.n_layers if n_layers is None else n_layers):
        p = _layer_params(blocks, i)

        def block(xs, p=p):
            return _mesh_block(p, xs, positions, cfg, groups, root)

        xs, a = (torch.utils.checkpoint.checkpoint(block, xs,
                                                   use_reentrant=False)
                 if cfg.remat else block(xs))
        if aux is not None:
            aux = aux + a
    flat = [t for xg in xs for t in xg] if sp else xs
    return gather(flat, ranks, root, combine, split), aux


def _mesh_vocab(x, lm_head, cfg: TransformerConfig, mesh: Mesh):
    """The vocabulary projection of ``x`` (on the mesh's first rank) per dp
    group: each group's rows copied to its tp ranks, each rank's columns
    all-gathered, the groups' logits back on the first rank."""
    groups = _groups(mesh)
    root = groups[0].ids[0]
    dp = len(groups)
    ranks = Ranks.of(mesh, [i for g in groups for i in g.ids])

    def index(x):
        n = x.shape[0] // dp
        return [(slice(g * n, (g + 1) * n),)
                for g, devs in enumerate(groups) for _ in devs]

    xr = scatter(x, root, ranks, index)
    firsts, at = [], 0
    for devs in groups:
        mine = xr[at:at + len(devs)]
        at += len(devs)
        if not _held(devs):
            firsts.append(None)
            continue
        logits = all_gather(rank_map(lambda r, dev, xg: _vocab_rank(
            xg, _part(lm_head, r, dev, devs.ids[r]), _is_q8(lm_head), cfg),
            devs, mine), dim=-1, ranks=devs)
        firsts.append(logits[0])
    return gather(firsts, Ranks.of(mesh, [g.ids[0] for g in groups]), root,
                  lambda ps: torch.cat(ps, dim=0),
                  lambda y: list(torch.chunk(y, dp, dim=0)))


def _check_mesh_shapes(ids, cfg: TransformerConfig, mesh: Mesh, pp: int,
                       n_microbatches: int) -> None:
    """The batch splits the forward needs, checked in every process (the
    first rank alone holds the activations)."""
    B, L = ids.shape
    dp, tp = mesh.axis_size("dp"), mesh.axis_size("tp")
    rows = B
    if pp > 1:
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not divide in "
                             f"{n_microbatches} microbatches")
        rows = B // n_microbatches
    if rows % dp:
        raise ValueError(f"batch {rows} must divide by dp {dp}")
    if cfg.seq_shard and tp > 1 and L % tp:
        raise ValueError(f"sequence {L} must divide by tp {tp} under "
                         "seq_shard")


def _mesh_forward(params: dict, ids, cfg: TransformerConfig, mesh: Mesh,
                  pp: int, n_microbatches: int):
    """:func:`forward` over a mesh: ``(logits float32, aux)`` on the mesh's
    first rank, ``(None, None)`` in other processes."""
    if pp > 1 and cfg.attention == "ring":
        raise ValueError(
            "attention='ring' cannot run inside the pp pipeline (nested "
            "manual shard_map is unsupported by Shardy); use "
            "seq_shard=True with attention='dense', or pp=1")
    _check_mesh_shapes(ids, cfg, mesh, pp, n_microbatches)
    root = 0
    x = None
    if mesh.owner(root) == mesh.me:
        emb = _use(params["embed"], root, mesh.device_of(root))
        x = emb[ids.to(emb.device)].to(cfg.dtype)  # _embed's
    positions = torch.arange(ids.shape[1],
                             device=mesh.first_local_device)[None, :]
    if pp > 1:
        per_stage = cfg.n_layers // pp

        def stage(p_local, act, s):
            # the stage drops its aux (the reference's ``y, _ = block_fn``)
            return _mesh_layers(p_local, act, positions, cfg, mesh, s,
                                per_stage)[0]

        x = pipeline_apply(stage, params["blocks"], x, mesh,
                           n_microbatches=n_microbatches)
        aux = None if x is None else torch.zeros(
            (), dtype=torch.float32, device=x.device)
    else:
        x, aux = _mesh_layers(params["blocks"], x, positions, cfg, mesh)
    if x is not None:
        x = rmsnorm(x, _use(params["ln_f"], root, x.device))
    logits = _mesh_vocab(x, params["lm_head"], cfg, mesh)
    return (None if logits is None else logits.float()), aux


@contextlib.contextmanager
def _on_mesh(mesh: Mesh, cfg: TransformerConfig):
    """A forward over ``mesh``: across processes, under autograd, the
    moves' token (``exchange_tape``)."""
    if mesh.spans_processes and cfg.remat:
        raise MeshPlanError(
            "cfg.remat over ranks that span processes: a block's recompute "
            "would repeat its moves between processes inside the backward; "
            "train without remat there")
    with exchange_tape(mesh) as tape:
        yield tape


def forward(params: dict, input_ids, cfg: TransformerConfig,
            mesh: Optional[Mesh] = None, pp: int = 1,
            n_microbatches: int = 1):
    """Logits ``[B, L, V]`` in float32 and the MoE aux loss summed over
    the layers (0 for a dense model, and 0 when pp > 1: the pipeline
    carries activations only, as the reference's).

    Without ``mesh`` the layers run on the params' device (int8 leaves
    included).  With ``mesh`` (params placed by :func:`shard_params` with
    the same ``pp``) the module docstring's layout; ``pp > 1`` runs the
    stages through the GPipe schedule with ``n_microbatches``.  Under
    ``cfg.remat`` each block is recomputed in the backward (in one
    process).  Over a mesh that spans processes every process calls it
    and gets the logits and the aux."""
    _check_q8_pipeline(params, pp)
    ids = torch.as_tensor(input_ids)
    if mesh is None:
        x = _embed(params, ids.to(params["embed"].device), cfg)
        positions = torch.arange(ids.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            p = _layer_params(params["blocks"], i)

            def block(x, p=p):
                return block_fn(p, x, positions, cfg)

            x, a = (torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
                    if cfg.remat else block(x))
            aux = aux + a
        x = rmsnorm(x, params["ln_f"])
        return _vocab_proj(x, params["lm_head"], cfg).float(), aux
    with _on_mesh(mesh, cfg) as tape:
        logits, aux = _mesh_forward(rank_views(params, mesh), ids, cfg,
                                    mesh, pp, n_microbatches)
        if mesh.spans_processes:
            logits, aux = share(logits, 0, mesh), share(aux, 0, mesh)
            if tape is not None:
                logits, aux = tape.close(logits), tape.close(aux)
    return logits, aux


def _next_token_loss(logits, aux, batch: dict, aux_weight: float):
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.as_tensor(batch["targets"]).to(logp.device).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    mask = batch.get("mask")
    mask = (torch.ones_like(nll) if mask is None
            else torch.as_tensor(mask).to(nll.device, nll.dtype))
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux.to(loss.device)


def lm_loss(params, batch: dict, cfg: TransformerConfig,
            mesh: Optional[Mesh] = None, pp: int = 1,
            n_microbatches: int = 1, aux_weight: float = 0.01):
    """Next-token cross-entropy: ``batch`` holds ``input_ids`` [B, L],
    ``targets`` [B, L] and optionally ``mask`` [B, L] (1 = a real token).
    The log-softmax in float32, each target's log-probability, the mean
    over the masked tokens of the whole batch (over ``max(mask.sum(),
    1)``), plus ``aux_weight * aux``.  Over a mesh that spans processes the
    loss is computed on the mesh's first rank and every process gets it;
    a backward from it in every process is the step's backward (the
    gradient of a leaf several processes keep summed over them)."""
    if mesh is None or not mesh.spans_processes:
        logits, aux = forward(params, batch["input_ids"], cfg, mesh, pp,
                              n_microbatches)
        return _next_token_loss(logits, aux, batch, aux_weight)
    _check_q8_pipeline(params, pp)
    with _on_mesh(mesh, cfg) as tape:
        logits, aux = _mesh_forward(
            rank_views(params, mesh), torch.as_tensor(batch["input_ids"]),
            cfg, mesh, pp, n_microbatches)
        loss = None if logits is None else _next_token_loss(
            logits, aux, batch, aux_weight)
        loss = share(loss, 0, mesh)
        return loss if tape is None else tape.close(loss)


def param_leaves(tree) -> list:
    """Every tensor of a param tree (placed pieces included; this
    process's, across processes), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return []


def make_train_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                    pp: int = 1, n_microbatches: int = 1,
                    learning_rate: float = 1e-3):
    """Returns ``(init_opt, step)``.  ``init_opt(params)`` makes every leaf
    require grad and returns ``torch.optim.AdamW`` over them with optax
    ``adamw``'s defaults and the reference's decay (betas (0.9, 0.999),
    eps 1e-8, weight decay 0.01 on every leaf).  ``step(params, opt_state,
    batch)`` returns ``(params, opt_state, loss)``: the loss before the
    update (``jax.value_and_grad``'s), params updated in place (the
    reference donates them).  Over a mesh that spans processes every
    process runs the step on the leaves it keeps; a leaf several of them
    keep takes the same gradient, so the same update, in each."""

    def init_opt(params):
        leaves = param_leaves(params)
        for t in leaves:
            if not t.is_floating_point():
                raise ValueError("int8-quantized params cannot train")
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        with torch.inference_mode(False), torch.enable_grad():
            loss = lm_loss(params, batch, cfg, mesh, pp, n_microbatches)
            loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, step


def prefill(params, input_ids, cfg: TransformerConfig, max_len: int,
            logit_pos=None, mesh: Optional[Mesh] = None):
    """One forward over the whole prompt that also returns its KV cache.

    Returns ``(logits, cache)`` with ``cache = {"k", "v": (layers, B,
    max_len, Hkv, Dh), "pos": (B,)}``.  ``logit_pos`` projects only that
    position through the vocab matrix (``[B, V]`` logits): an int for every
    row, or a (B,) tensor of per-row positions; ``None`` projects all
    positions (``[B, L, V]``).  Right-padding is exact under causal
    attention, so callers pass ``logit_pos = true_len - 1``.

    With ``mesh`` the layers run tensor-parallel (sequence-parallel under
    ``cfg.attention == "ring"``) and the cache's K/V are :class:`Shards`
    split on their head axis, the layout of :func:`init_cache`'s.
    """
    if mesh is not None:
        _check_serving_mesh(mesh)
    B, L = input_ids.shape
    x = _embed(params, input_ids, cfg)
    positions = torch.arange(L, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        x, (k, v) = attention_block(p, x, positions, cfg, return_kv=True,
                                    mesh=mesh)
        x, _ = ffn_block(p, x, cfg, mesh=mesh)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["ln_f"])
    if logit_pos is not None:
        lp = torch.as_tensor(logit_pos)
        if lp.dim() == 0:
            x = x[:, int(lp)][:, None]
        else:
            x = x[torch.arange(B, device=x.device), lp.to(x.device)][:, None]
        logits = _vocab_proj(x, params["lm_head"], cfg, mesh)[:, 0].float()
    else:
        logits = _vocab_proj(x, params["lm_head"], cfg, mesh).float()
    pad = max_len - L

    def cache_of(layers):
        # (layers, B, max_len, Hkv, Dh): prompt K/V up front, zeros after
        if mesh is None:
            return F.pad(torch.stack(layers), (0, 0, 0, 0, 0, pad))
        return Shards([None if parts[0] is None else
                       F.pad(torch.stack(parts), (0, 0, 0, 0, 0, pad))
                       for parts in zip(*layers)], 3)

    cache = {"k": cache_of(ks), "v": cache_of(vs),
             "pos": torch.full((B,), L, dtype=torch.int32, device=x.device)}
    return logits, cache


# ----------------------------------------------------------------------
# decode against a slab KV cache
# ----------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int,
               max_len: Optional[int] = None, device=None,
               mesh: Optional[Mesh] = None) -> dict:
    """Slab KV cache ``{"k", "v": (layers, B, T, kv_heads, d_head), "pos":
    (B,) int32}``; GQA keeps it at ``kv_heads``.  With ``mesh`` the K/V are
    :class:`Shards` split on the KV-head axis over "tp" (each rank holds the
    KV heads of its query heads) and ``pos`` is on rank 0's device;
    ``cfg.kv_heads`` must divide by tp."""
    max_len = max_len or cfg.max_seq
    if mesh is None:
        shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    tp = mesh.axis_size("tp")
    # tp rank t's cache on the first rank with tp = t this process holds
    devs = [mesh.holder_device(tp=t) for t in range(tp)]
    if cfg.kv_heads % tp:
        raise ValueError(f"n_kv_heads {cfg.kv_heads} must divide by tp {tp}")
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads // tp, cfg.d_head)
    return {name: Shards([None if d is None else
                          torch.zeros(shape, dtype=cfg.dtype, device=d)
                          for d in devs], 3) for name in ("k", "v")} | {
        "pos": torch.zeros((batch,), dtype=torch.int32,
                           device=first_device(devs))}


def _kv_rows(kv, rows) -> Shards:
    """A placed K/V cache's rows (views, so writes reach the cache)."""
    return kv.map(lambda t: t[:, rows])


def _tp_decode(params, cache, token_ids, pos, cfg: TransformerConfig,
               mesh: Mesh):
    """:func:`decode_step`'s layers over the mesh, layer by layer over
    every dp group: each group's tp ranks write their KV heads' new rows
    and attend over their heads; the FFN takes every group's rows at once
    (:func:`_mesh_ffn`: a MoE routes every row of the call)."""
    B, K = token_ids.shape
    groups, parts = _dp_rows(mesh, B)
    xs, steps = [], []
    for devs, rows in zip(groups, parts):
        if not _held(devs):  # another process's dp group
            xs.append(None)
            steps.append(None)
            continue
        x = _embed(params, token_ids[rows], cfg).to(first_device(devs))
        positions = pos[rows].to(x.device)[:, None] + torch.arange(
            K, device=x.device)[None, :]
        xs.append(x)
        steps.append((_kv_rows(cache["k"], rows), _kv_rows(cache["v"], rows),
                      positions,
                      torch.arange(x.shape[0], device=x.device)[:, None]))
    for i in range(cfg.n_layers):
        p = _layer_params(params["blocks"], i)
        for g, (devs, step) in enumerate(zip(groups, steps)):
            if step is None:
                continue
            ck, cv, positions, rows = step
            _check_q8_attn_single_chip(p, devs)
            h = rmsnorm(xs[g], p["ln1"].to(xs[g].device))

            def attend(r, dev, qkv, ck=ck, cv=cv, rows=rows):
                q, k, v, pr = qkv
                kc, vc = ck[r][i], cv[r][i]  # (B, T, Hkv/tp, Dh) views
                rr = rows.to(kc.device)
                kc[rr, pr] = k.to(kc.dtype)
                vc[rr, pr] = v.to(vc.dtype)
                return _chunk_attention(q, kc, vc, pr)

            attns = rank_map(attend, devs,
                             _rank_qkv(p, h, positions, cfg, devs))
            xs[g] = _tp_attn_out(p, xs[g], attns, devs, cfg.dtype)
        xs, _ = _mesh_ffn(p, xs, cfg, groups)
    return _tp_logits(params, xs, cfg, groups)


def _tp_logits(params, xs: list, cfg: TransformerConfig, groups: list):
    """The final norm and the vocabulary projection of every dp group's
    rows, concatenated on rows in float32 (across processes each group's
    from the process that computes it, in every process)."""
    return torch.cat(_everywhere(
        [None if x is None else _tp_vocab(
            rmsnorm(x, params["ln_f"].to(x.device)), params["lm_head"], cfg,
            devs).float() for x, devs in zip(xs, groups)], groups), dim=0)


def decode_step(params, cache, token_ids, cfg: TransformerConfig,
                mesh: Optional[Mesh] = None):
    """Incremental decode against a slab cache.  ``token_ids`` (B,) gives
    logits (B, V); (B, K) runs a K-token chunk in one pass and gives (B, K,
    V).  Query j of row b sits at ``pos[b] + j`` and sees the cache rows
    up to it (a position mask over the whole cache, as the reference).

    Unlike the reference, the new K/V rows are written INTO ``cache`` at
    ``pos .. pos + K - 1`` (in place); the returned cache is the same
    tensors with ``pos + K``.  Rows past ``pos`` are masked and later
    overwritten, so rewinding is setting ``pos`` lower.  The caller keeps
    ``pos + K <= T``.  With ``mesh`` the cache is :func:`init_cache`'s
    placed one and the layers run tensor-parallel."""
    single = token_ids.dim() == 1
    if single:
        token_ids = token_ids[:, None]
    B, K = token_ids.shape
    T = (cache["k"].first if mesh is not None else cache["k"]).shape[2]
    if K > T:
        raise ValueError(f"chunk of {K} tokens exceeds cache length {T}")
    pos = cache["pos"].to(token_ids.device).long()
    if mesh is not None:
        logits = _tp_decode(params, cache, token_ids, pos, cfg, mesh)
        out = {"k": cache["k"], "v": cache["v"],
               "pos": (pos + K).to(torch.int32)}
        return (logits[:, 0, :] if single else logits), out
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
        x, _ = ffn_block(p, x, cfg)
    x = rmsnorm(x, params["ln_f"])
    logits = _vocab_proj(x, params["lm_head"], cfg).float()
    out = {"k": cache["k"], "v": cache["v"],
           "pos": (pos + K).to(torch.int32)}
    return (logits[:, 0, :] if single else logits), out


# ----------------------------------------------------------------------
# one-request generation loops
# ----------------------------------------------------------------------

def generate(params, prompt_ids, n_new: int, cfg: TransformerConfig,
             temperature: float = 0.0, generator=None,
             mesh: Optional[Mesh] = None):
    """Prefill, then one :func:`decode_step` per token: greedy argmax, or
    with ``temperature`` > 0 a draw from ``softmax(logits / temperature)``
    with ``generator`` (a ``torch.Generator`` on the logits' device; the
    reference's ``jax.random`` draws cannot be replayed).  ``prompt_ids``
    (B, L0); returns (B, L0 + n_new).  Under ``mesh`` the prompt runs token
    by token through the tensor-parallel :func:`decode_step`, as the
    reference's does."""
    B, L0 = prompt_ids.shape
    with torch.no_grad():
        if mesh is None:
            logits, cache = prefill(params, prompt_ids, cfg,
                                    max_len=L0 + n_new, logit_pos=L0 - 1)
        else:
            cache = init_cache(cfg, B, max_len=L0 + n_new, mesh=mesh)
            for t in range(L0):
                logits, cache = decode_step(params, cache, prompt_ids[:, t],
                                            cfg, mesh=mesh)
        out = [prompt_ids]
        for t in range(n_new):
            if temperature > 0.0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok[:, None].to(prompt_ids.dtype))
            if t < n_new - 1:
                logits, cache = decode_step(params, cache, tok, cfg,
                                            mesh=mesh)
        return torch.cat(out, dim=1)


def speculative_generate(params, draft_params, prompt_ids, n_new: int,
                         cfg: TransformerConfig, draft_cfg: TransformerConfig,
                         k_draft: int = 4, mesh: Optional[Mesh] = None):
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

    Under ``mesh`` both models run tensor-parallel (both placed on it).

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
                                    logit_pos=L0 - 1, mesh=mesh)
        _, d_cache = prefill(draft_params, prompt_ids, draft_cfg,
                             max_len=max_len, logit_pos=L0 - 1, mesh=mesh)
        out = [int(torch.argmax(t_logits[0]))]
        rounds = accepted = 0
        while len(out) < n_new:
            tok = torch.tensor([out[-1]], device=dev)
            d_tokens = []
            for _ in range(k_draft):
                dl, d_cache = decode_step(draft_params, d_cache, tok,
                                          draft_cfg, mesh=mesh)
                tok = torch.argmax(dl, dim=-1)
                d_tokens.append(int(tok[0]))
            vtokens = torch.tensor([[out[-1]] + d_tokens], device=dev)
            vlogits, t_cache = decode_step(params, t_cache, vtokens, cfg,
                                           mesh=mesh)
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
