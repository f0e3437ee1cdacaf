"""ResNet50 (port of ``seldon_core_tpu/models/resnet.py``), the v1.5
bottleneck layout of the reference's flax module, in inference mode.

- Images come in as the reference takes them, [B, H, W, 3].  Inside, a
  tensor is NCHW by shape and channels_last in memory (NHWC bytes), and the
  convs run through ``torch.nn.functional.conv2d`` (cuDNN on the card): the
  reference leaves them to XLA, so no hand kernel is needed.
- Padding is flax's ``"SAME"``: for a stride of 2 it puts ``total // 2``
  before and the rest after (the 7x7/2 stem on 224 pads (2, 3), a 3x3/2 on
  56 pads (0, 1), the 3x3/2 max-pool on 112 pads (0, 1) with -inf), which
  ``F.pad`` spells out; torch's symmetric ``padding=`` would shift the
  output by a pixel.
- BatchNorm uses its running statistics with flax's arithmetic: the
  activation, the float32 statistics and the scale and bias meet in
  float32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, rounded
  once to the serving dtype.
- Weights are stored in the serving dtype except the head (float32, as
  flax's ``Dense(dtype=float32)``) and the BN statistics (float32); the
  mean over H and W is taken in float32 and rounded to the serving dtype,
  and the head and the softmax run in float32.

Seeded weights come from a ``torch.Generator``: conv and head kernels
``randn / sqrt(fan_in)``, BN scale 1 (0 for each bottleneck's last BN, as
the reference's ``scale_init=zeros``), bias 0, mean 0, var 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.device import resolve_device

__all__ = ["same_pads", "conv2d_same", "max_pool_same", "ResNet",
           "Bottleneck", "ResNet50Model", "BN_EPS"]

BN_EPS = 1e-5  # flax nn.BatchNorm's default


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding (before, after) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
    """``x`` (B, C, H, W), ``w`` (O, C, kh, kw), "SAME" padding."""
    top, bottom = same_pads(x.shape[2], w.shape[2], stride)
    left, right = same_pads(x.shape[3], w.shape[3], stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None]


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty((cout, cin, k, k), dtype=dtype).contiguous(
                memory_format=torch.channels_last), requires_grad=False)

    def forward(self, x):
        return conv2d_same(x, self.weight, self.stride)


class _BatchNorm(nn.Module):
    """Inference BatchNorm: scale and bias in the serving dtype, the running
    mean and var in float32."""

    def __init__(self, c: int, dtype: torch.dtype, zero_scale: bool = False):
        super().__init__()
        self.register_buffer("scale", torch.full((c,), 0.0 if zero_scale
                                                 else 1.0, dtype=dtype))
        self.register_buffer("bias", torch.zeros((c,), dtype=dtype))
        self.register_buffer("mean", torch.zeros((c,)))
        self.register_buffer("var", torch.ones((c,)))

    def forward(self, x):
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale.float()
        y = (x.float() - _per_channel(self.mean)) * mul[:, None, None]
        return (y + _per_channel(self.bias)).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv0 = _Conv(cin, filters, 1, 1, dtype)
        self.bn0 = _BatchNorm(filters, dtype)
        self.conv1 = _Conv(filters, filters, 3, strides, dtype)
        self.bn1 = _BatchNorm(filters, dtype)
        self.conv2 = _Conv(filters, filters * 4, 1, 1, dtype)
        self.bn2 = _BatchNorm(filters * 4, dtype, zero_scale=True)
        self.proj = self.proj_bn = None
        if cin != filters * 4 or strides != 1:  # the residual changes shape
            self.proj = _Conv(cin, filters * 4, 1, strides, dtype)
            self.proj_bn = _BatchNorm(filters * 4, dtype)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = torch.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """``forward`` takes [B, H, W, 3] images of any float or int dtype and
    returns float32 softmax probabilities [B, num_classes]."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem = _Conv(3, 64, 7, 2, dtype)
        self.stem_bn = _BatchNorm(64, dtype)
        blocks, cin = [], 64
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                filters = 64 * 2 ** i
                blocks.append(Bottleneck(cin, filters,
                                         2 if i > 0 and j == 0 else 1, dtype))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head_w = nn.Parameter(torch.empty((cin, num_classes)),
                                   requires_grad=False)
        self.head_b = nn.Parameter(torch.zeros((num_classes,)),
                                   requires_grad=False)

    def init_weights(self, gen: torch.Generator) -> "ResNet":
        """Seeded weights (see the module docstring), in place."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, _Conv):
                    o, i, kh, kw = m.weight.shape
                    w = torch.randn((o, i, kh, kw), generator=gen,
                                    device=m.weight.device)
                    m.weight.copy_(w * (i * kh * kw) ** -0.5)
            self.head_w.copy_(torch.randn(
                self.head_w.shape, generator=gen, device=self.head_w.device)
                * self.head_w.shape[0] ** -0.5)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC bytes, NCHW shape
        x = torch.relu(self.stem_bn(self.stem(x)))
        x = max_pool_same(x)
        for blk in self.blocks:
            x = blk(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        logits = x.float() @ self.head_w + self.head_b
        return torch.softmax(logits, dim=-1)


class ResNet50Model:
    """Graph MODEL component serving ResNet50 on [B, H, W, 3] images.

    ``module=`` serves a given :class:`ResNet` (weights already in place,
    for example converted from the reference with
    ``convert.resnet_from_jax``) instead of a seeded ResNet50.
    :meth:`save_checkpoint` exports it for ``model_uri``.
    """

    def __init__(self, seed: int = 0, num_classes: int = 1000,
                 image_size: int = 224, dtype: str = "bfloat16",
                 model_uri: str = "", device: str = "cuda",
                 module: Optional[ResNet] = None):
        self.device = resolve_device(device)
        if model_uri:
            # the reference's flax variables (params + batch_stats); each
            # tensor takes the dtype the module keeps it in, as the
            # reference's storage cast does
            from seldon_core_tpu_torch.convert import resnet_from_jax
            from seldon_core_tpu_torch.runtime.checkpoint import (
                load_checkpoint,
                resolve_model_uri,
            )

            variables, meta = load_checkpoint(resolve_model_uri(model_uri))
            if meta.get("family") not in (None, "resnet"):
                raise ValueError(f"model_uri holds {meta.get('family')!r},"
                                 " not resnet weights")
            module = resnet_from_jax(
                variables, ResNet(num_classes=num_classes,
                                  dtype=getattr(torch, dtype)))
        elif module is None:
            module = ResNet(num_classes=num_classes,
                            dtype=getattr(torch, dtype)).to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            module.init_weights(gen)
        self.module = module.to(self.device).eval()
        self.image_size = image_size
        self.input_shape = (image_size, image_size, 3)  # one request row
        self.class_names = [f"class:{i}" for i in range(module.num_classes)]

    @property
    def params(self) -> ResNet:
        return self.module

    def predict_fn(self, module, X):
        return module(X)

    def tags(self):
        return {"model": "resnet50", "image_size": self.image_size}

    def save_checkpoint(self, path: str) -> str:
        """Export the module as the reference's flax variables (``params``
        and ``batch_stats``, ``convert.resnet_to_jax``): a ``model_uri``
        checkpoint (``{"family": "resnet"}``) that this class and the
        reference's serve."""
        from seldon_core_tpu_torch.convert import resnet_to_jax
        from seldon_core_tpu_torch.runtime.checkpoint import export_checkpoint

        return export_checkpoint(path, resnet_to_jax(self.module),
                                 {"family": "resnet"})
