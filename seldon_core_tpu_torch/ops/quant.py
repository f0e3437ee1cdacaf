"""Int8 weight-quantized matmul (port of ``seldon_core_tpu/ops/quant.py``).

- **offline**: per-output-channel symmetric quantization of weights
  (:func:`quantize_int8`), absmax/127 per column;
- **online**: per-row dynamic quantization of activations, an int8 x int8
  product accumulated exactly in int32, then one float32 rescale by
  ``(row scale x column scale)``.

:func:`int8_matmul` dispatches on the device of its input: a CUDA tensor
launches kernel K1 (``csrc/int8_matmul.cu``, :func:`int8_matmul_cuda`) or
raises; a CPU tensor takes the plain version :func:`int8_matmul_ref`.  The
two agree bit for bit: the accumulation is exact in integers and every
float step (IEEE division, round half to even, the two multiplies in the
same order) is the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seldon_core_tpu_torch.ops import _build

__all__ = ["QuantizedLinear", "quantize_int8", "int8_matmul",
           "int8_matmul_ref", "int8_matmul_cuda"]


class QuantizedLinear(NamedTuple):
    """Per-output-channel symmetric int8 weight."""

    values: torch.Tensor  # (K, N) int8
    scales: torch.Tensor  # (N,) float32


def _div127(a: torch.Tensor) -> torch.Tensor:
    # tensor / tensor: a true IEEE division on every backend (a Python
    # scalar divisor may become a multiply by its reciprocal on CUDA)
    return a / torch.full_like(a, 127.0)


def quantize_int8(w) -> QuantizedLinear:
    w = torch.as_tensor(w).float()
    absmax = w.abs().amax(dim=0)  # (N,)
    scales = torch.where(absmax == 0, torch.ones_like(absmax), _div127(absmax))
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return QuantizedLinear(values=q, scales=scales)


def int8_matmul_ref(x2: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """Plain version of K1 on ``x2`` (M, K): the JAX function's math.  The
    int8 product runs in float64, which is exact (every partial sum is an
    integer below 2^53) on any device and in any order; float32 would not be
    beyond 2^24 (16384 * 127^2 is more)."""
    xf = x2.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    xs = torch.where(absmax == 0, torch.ones_like(absmax), _div127(absmax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127)
    acc = xq.double() @ values.double()
    return (acc.float() * xs * scales[None, :]).to(out_dtype)


def int8_matmul_cuda(x2: torch.Tensor, values: torch.Tensor,
                     scales: torch.Tensor, out_dtype: torch.dtype
                     ) -> torch.Tensor:
    """Launch K1.  Takes x2 (M, K) float32/bfloat16, values (K, N) int8 and
    scales (N,) float32, all contiguous on one card, with K and N multiples
    of 4; raises on anything else."""
    what = "int8_matmul"
    if not (x2.is_cuda and values.is_cuda and scales.is_cuda):
        raise ValueError(f"{what}: every operand must be on the card")
    if not (x2.device == values.device == scales.device):
        raise ValueError(f"{what}: operands on different devices")
    if x2.dim() != 2 or values.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"{what}: want x (M, K), values (K, N), scales (N,)")
    M, K = x2.shape
    K2, N = values.shape
    if K2 != K or scales.shape[0] != N:
        raise ValueError(f"{what}: shapes {tuple(x2.shape)} x "
                         f"{tuple(values.shape)} / {tuple(scales.shape)}")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{what}: want int8 values and float32 scales")
    if K % 4 or N % 4:
        raise ValueError(f"{what}: K ({K}) and N ({N}) must be multiples of 4")
    for name, t in (("x", x2), ("values", values), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    x_code = _build.dtype_code(x2.dtype, what)
    o_code = _build.dtype_code(out_dtype, what)
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    if M == 0:
        return out
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x2.device)
    lib = _build.load()
    err = lib.sck_int8_matmul(
        _build.ptr(x2), _build.ptr(values), _build.ptr(scales),
        _build.ptr(xq), _build.ptr(xs), _build.ptr(out), M, K, N,
        x_code, o_code, _build.stream_of(x2),
    )
    _build.check(err, what)
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0


def int8_matmul(x, w: QuantizedLinear,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w)`` with int8 compute; ``x`` is (..., K)."""
    if out_dtype is None:
        out_dtype = x.dtype
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    N = w.values.shape[1]
    if x2.is_cuda:
        out = int8_matmul_cuda(x2.contiguous(), w.values, w.scales, out_dtype)
    else:
        out = int8_matmul_ref(x2, w.values, w.scales, out_dtype)
    return out.reshape(*lead, N)
