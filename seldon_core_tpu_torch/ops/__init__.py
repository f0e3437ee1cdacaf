"""Kernels of the port and their plain PyTorch versions.

- :mod:`seldon_core_tpu_torch.ops.attention`: causal flash attention (K3,
  ``csrc/flash_attention.cu``) for prefill and training;
- :mod:`seldon_core_tpu_torch.ops.quant`: the int8 weight-quantized matmul
  (K1, ``csrc/int8_matmul.cu``: activations quantized per row, int8
  products, int32 sums).

A wrapper runs its plain version for a CPU tensor and its CUDA kernel for a
CUDA tensor; the kernels are built at first use (``ops/_build.py``).
"""

from seldon_core_tpu_torch.ops.attention import flash_attention
from seldon_core_tpu_torch.ops.quant import (
    QuantizedLinear,
    int8_matmul,
    quantize_int8,
)

__all__ = [
    "flash_attention",
    "QuantizedLinear",
    "int8_matmul",
    "quantize_int8",
]
