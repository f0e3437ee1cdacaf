"""Plain float32 reference of ResNet-50 in inference, in plain torch, from
the benchmark's own weights (``families/resnet50_int8.py``); it imports
nothing of the port.

The model: a 7x7/2 conv, BatchNorm, ReLU, a 3x3/2 max-pool; bottleneck
blocks of 1x1, 3x3 (carrying the block's stride) and 1x1 convs, each
followed by BatchNorm, the block's input (or its 1x1 strided projection
with BatchNorm) added before the last ReLU; a mean over the image and a
dense head.  Padding is "SAME" (for stride 2: ``total // 2`` before, the
rest after).  BatchNorm in inference: ``(x - mean) / sqrt(var + 1e-5) *
scale + bias``.  Everything in float32, TF32 off.

``control=True``: every 1x1 conv kernel and the head re-quantized per
output channel to int4 (absmax / 7), the precision just below the int8
that the configuration states for them; the rest as above.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["logits"]

BN_EPS = 1e-5


def _q4(w: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Per-output-channel int4 (symmetric, absmax / 7) of ``w``."""
    dims = tuple(i for i in range(w.dim()) if i != out_dim)
    s = w.abs().amax(dim=dims, keepdim=True) / 7.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(w / s), -7, 7) * s


def _same(x, k: int, s: int, value: float = 0.0):
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv_bn(x, kern, bn, stride: int, control: bool):
    k = kern.float()
    if control and k.shape[2] == 1:
        k = _q4(k, 0)
    y = F.conv2d(_same(x, k.shape[2], stride), k, stride=stride)
    scale, bias, mean, var = (t.float() for t in bn)
    inv = torch.rsqrt(var + BN_EPS) * scale
    return (y - mean[:, None, None]) * inv[:, None, None] \
        + bias[:, None, None]


@torch.no_grad()
def logits(w: dict, images: torch.Tensor, stage_sizes=(3, 4, 6, 3),
           control: bool = False, block: int = 64) -> torch.Tensor:
    """Float32 logits (B, classes) of ``images`` (B, H, W, 3), ``block``
    images at a time."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.cat([_forward(w, images[a:a + block], stage_sizes,
                                   control)
                          for a in range(0, images.shape[0], block)])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _forward(w, images, stage_sizes, control):
    convs, bns = w["conv"], w["bn"]
    x = images.float().permute(0, 3, 1, 2)
    x = torch.relu(_conv_bn(x, convs[0], bns[0], 2, control))
    x = F.max_pool2d(_same(x, 3, 2, float("-inf")), 3, 2)
    i, cin = 1, 64
    for st, n in enumerate(stage_sizes):
        f = 64 * 2 ** st
        for j in range(n):
            s = 2 if st > 0 and j == 0 else 1
            y = torch.relu(_conv_bn(x, convs[i], bns[i], 1, control))
            y = torch.relu(_conv_bn(y, convs[i + 1], bns[i + 1], s, control))
            y = _conv_bn(y, convs[i + 2], bns[i + 2], 1, control)
            i += 3
            if cin != 4 * f or s != 1:
                x = _conv_bn(x, convs[i], bns[i], s, control)
                i += 1
            x = torch.relu(y + x)
            cin = 4 * f
    feats = x.mean(dim=(2, 3))
    head = w["head_w"].float()
    if control:
        head = _q4(head, 1)
    return feats @ head + w["head_b"].float()
