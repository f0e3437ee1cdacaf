"""Int8 ResNet50 (port of ``seldon_core_tpu/models/resnet_int8.py``): the
float model with its BatchNorms folded into the convs, every 1x1 conv and
the head as an int8 matmul on kernel K1 (``ops.quant.int8_matmul``), and
the 7x7 and 3x3 convs in the serving dtype (cuDNN on the card).

- BN folding: inference BN is a per-channel affine map, so
  ``bn(conv(x)) = conv_scaled(x) + bias`` with the scale folded into the
  kernel's output channels (:func:`_fold_bn`).
- A 1x1 conv is a (B*H*W, Cin) @ (Cin, Cout) matmul.  Activations are NHWC
  in memory, so the (B*H*W, Cin) view is free; a strided projection reads
  ``x[:, :, ::s, ::s]`` first, which ``int8_matmul`` copies.  The folded
  1x1 kernels and the head are quantized per output channel with
  ``quantize_int8`` (K-major, the layout K1 reads).  Per ResNet50 forward
  that is 16 blocks x (c1, c3) + 4 projections + the head = 37 launches
  of K1.
- The bias is added in the activation dtype after K1, the mean over H and
  W is taken in float32 and rounded to the activation dtype, and the head
  runs K1 on float32 rows, as the reference does.

Weights come from a float :class:`~.resnet.ResNet50Model` through
:func:`convert_params`, so the int8 model serves the same function.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.resnet import (
    BN_EPS,
    ResNet50Model,
    conv2d_same,
    max_pool_same,
)
from seldon_core_tpu_torch.ops.quant import int8_matmul, quantize_int8

__all__ = ["convert_params", "forward", "Int8ResNet50Model"]


def _fold_bn(kernel: torch.Tensor, bn) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into the conv before it: returns the
    kernel (O, I, kh, kw) scaled per output channel and the bias, both
    float32."""
    inv = bn.scale.float() * torch.rsqrt(bn.var + BN_EPS)
    folded = kernel.float() * inv[:, None, None, None]
    return folded, bn.bias.float() - bn.mean * inv


def _quantized(conv, bn) -> dict:
    k, b = _fold_bn(conv.weight, bn)
    return {"q": quantize_int8(k[:, :, 0, 0].t()), "bias": b}


def _spatial(conv, bn) -> dict:
    k, b = _fold_bn(conv.weight, bn)
    return {"kernel": k.contiguous(memory_format=torch.channels_last),
            "bias": b}


def convert_params(module) -> dict:
    """A float :class:`~.resnet.ResNet` to folded and quantized serving
    weights: ``stem`` and each block's ``c2`` keep a float32 kernel, each
    block's ``c1``, ``c3`` and ``proj`` and the ``head`` hold a
    ``QuantizedLinear``."""
    blocks = []
    for blk in module.blocks:
        w: dict[str, Any] = {"c1": _quantized(blk.conv0, blk.bn0),
                             "c2": _spatial(blk.conv1, blk.bn1),
                             "c3": _quantized(blk.conv2, blk.bn2)}
        if blk.proj is not None:
            w["proj"] = _quantized(blk.proj, blk.proj_bn)
        blocks.append(w)
    return {"stem": _spatial(module.stem, module.stem_bn), "blocks": blocks,
            "head": {"q": quantize_int8(module.head_w),
                     "bias": module.head_b.float()}}


def _block_strides(stage_sizes=(3, 4, 6, 3)) -> list[int]:
    return [2 if i > 0 and j == 0 else 1
            for i, n in enumerate(stage_sizes) for j in range(n)]


def _conv(x: torch.Tensor, w: dict, strides: int,
          dtype: torch.dtype) -> torch.Tensor:
    y = conv2d_same(x.to(dtype), w["kernel"].to(dtype), strides)
    return y + w["bias"].to(dtype)[:, None, None]


def _conv1x1_int8(x: torch.Tensor, w: dict, strides: int) -> torch.Tensor:
    """``x`` (B, C, H, W) channels_last; K1 on its (B*H*W, C) rows."""
    if strides > 1:
        x = x[:, :, ::strides, ::strides]
    rows = x.permute(0, 2, 3, 1)  # NHWC: a free view when channels_last
    B, H, W, C = rows.shape
    y = int8_matmul(rows.reshape(B * H * W, C), w["q"], out_dtype=x.dtype)
    y = y.reshape(B, H, W, -1).permute(0, 3, 1, 2)
    return y + w["bias"].to(x.dtype)[:, None, None]


def forward(weights: dict, x: torch.Tensor,
            dtype: torch.dtype = torch.bfloat16,
            stage_sizes=(3, 4, 6, 3)) -> torch.Tensor:
    """Folded int8 ResNet forward.  ``x`` [B, H, W, 3] of any float or int
    dtype; returns float32 softmax probabilities."""
    x = x.to(dtype).permute(0, 3, 1, 2)
    x = torch.relu(_conv(x, weights["stem"], 2, dtype))
    x = max_pool_same(x)
    for blk, strides in zip(weights["blocks"], _block_strides(stage_sizes)):
        y = torch.relu(_conv1x1_int8(x, blk["c1"], 1))
        y = torch.relu(_conv(y, blk["c2"], strides, dtype))
        y = _conv1x1_int8(y, blk["c3"], 1)
        residual = (_conv1x1_int8(x, blk["proj"], strides) if "proj" in blk
                    else x)
        x = torch.relu(y + residual)
    x = x.float().mean(dim=(2, 3)).to(dtype)
    logits = int8_matmul(x.float(), weights["head"]["q"],
                         out_dtype=torch.float32) + weights["head"]["bias"]
    return torch.softmax(logits, dim=-1)


class Int8ResNet50Model:
    """Graph MODEL component: the int8 ResNet50 (the serving contract of
    :class:`~.resnet.ResNet50Model`), from ``source`` or from a seeded
    float model."""

    def __init__(self, seed: int = 0, num_classes: int = 1000,
                 image_size: int = 224, source: Optional[ResNet50Model] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        src = source or ResNet50Model(seed=seed, num_classes=num_classes,
                                      image_size=image_size, device=device)
        self.image_size = image_size
        self.input_shape = (image_size, image_size, 3)  # one request row
        self.stage_sizes = src.module.stage_sizes
        self.weights = convert_params(src.module)
        self.class_names = src.class_names

    @property
    def params(self) -> dict:
        return self.weights

    def predict_fn(self, weights, X):
        return forward(weights, X, stage_sizes=self.stage_sizes)

    def tags(self):
        return {"model": "resnet50-int8", "image_size": self.image_size}
