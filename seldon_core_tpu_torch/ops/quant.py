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

Weight layout: ``values`` has the reference's shape (K, N) at every public
function, but is stored K-major: it is the ``.t()`` view of a contiguous
(N, K) buffer, strides (1, K) (:func:`k_major`).  Every function that makes
int8 weights gives that layout (:func:`quantize_int8`, the model's
``init_params_int8``, ``convert.params_from_jax``), the plain version runs
on the view unchanged, and the kernel wrapper refuses any other layout.
The kernel then reads each output column's K bytes contiguously.

Schedules (:func:`int8_variant`): ``"mma_gemv"`` for M <= 16 rows (decode),
``"mma_gemm"`` above (prefill buckets), whose tile rows and K splits come
from :func:`gemm_plan`; both are checked bit for bit against the plain
version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seldon_core_tpu_torch.ops import _build

__all__ = ["QuantizedLinear", "quantize_int8", "k_major", "is_k_major",
           "quantize_rows", "int8_variant", "int8_matmul", "int8_matmul_ref",
           "int8_matmul_cuda", "GemmPlan", "gemm_plan",
           "GEMV_MAX_ROWS"]

#: the most rows K1's decode schedule ("mma_gemv") takes
GEMV_MAX_ROWS = 16


class QuantizedLinear(NamedTuple):
    """Per-output-channel symmetric int8 weight."""

    values: torch.Tensor  # (K, N) int8, K-major: strides (1, K)
    scales: torch.Tensor  # (N,) float32


def _div127(a: torch.Tensor) -> torch.Tensor:
    # tensor / tensor: a true IEEE division on every backend (a Python
    # scalar divisor may become a multiply by its reciprocal on CUDA)
    return a / torch.full_like(a, 127.0)


def k_major(values: torch.Tensor) -> torch.Tensor:
    """The same (K, N) values stored K-major: the ``.t()`` view of a
    contiguous (N, K) copy."""
    return values.t().contiguous().t()


def is_k_major(values: torch.Tensor) -> bool:
    """Strides (1, K), ignoring the stride of a dim of size 1."""
    K, N = values.shape
    return ((K == 1 or values.stride(0) == 1)
            and (N == 1 or values.stride(1) == K))


def quantize_int8(w) -> QuantizedLinear:
    w = torch.as_tensor(w).float()
    absmax = w.abs().amax(dim=0)  # (N,)
    scales = torch.where(absmax == 0, torch.ones_like(absmax), _div127(absmax))
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return QuantizedLinear(values=k_major(q), scales=scales)


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic quantization of ``x2`` (M, K): ``xq`` (M, K) as
    float32 integers in [-127, 127] and the row scales ``xs`` (M, 1)."""
    xf = x2.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    xs = torch.where(absmax == 0, torch.ones_like(absmax), _div127(absmax))
    return torch.clamp(torch.round(xf / xs), -127, 127), xs


def int8_variant(M: int) -> str:
    """K1's schedule for ``M`` rows: the bandwidth-bound batched GEMV up to
    :data:`GEMV_MAX_ROWS` rows, the tiled tensor-core GEMM above."""
    return "mma_gemv" if M <= GEMV_MAX_ROWS else "mma_gemm"


_VARIANT_CODES = {"mma_gemv": 0, "mma_gemm": 1}  # csrc/int8_matmul.cu
_GEMM_BN, _GEMM_BK = 128, 128  # "mma_gemm" tile columns, K bytes per stage


class GemmPlan(NamedTuple):
    """How ``"mma_gemm"`` covers an (M, K) x (K, N) product."""

    bm: int      # tile rows (32, 64 or 128); tiles are bm x 128
    splits: int  # K splits per output tile


def gemm_plan(M: int, K: int, N: int, sms: int) -> GemmPlan:
    """The plan of ``"mma_gemm"`` on a card with ``sms`` SMs.  K is split
    in two while the blocks still fit one per SM and each split keeps two
    k-tiles.  Tile rows: the most of 128, 64 and 32 (no more than M needs)
    whose tiles, split at most 4 ways, fill at least half the SMs; else 32.
    So a large weight is streamed once, and a small one is re-read from L2
    by more row tiles rather than split deeper (PERF.md)."""
    nk = -(-K // _GEMM_BK)

    def tiles_and_splits(bm: int) -> tuple[int, int]:
        tiles = -(-M // bm) * -(-N // _GEMM_BN)
        splits = 1
        while tiles * splits * 2 <= sms and nk // (splits * 2) >= 2:
            splits *= 2
        return tiles, splits

    for bm in (128, 64):
        if M > bm // 2:  # else a smaller tile covers M
            tiles, splits = tiles_and_splits(bm)
            if tiles * min(splits, 4) * 2 >= sms:
                return GemmPlan(bm, splits)
    return GemmPlan(32, tiles_and_splits(32)[1])


def _gemm_scratch_ints(M: int, N: int, plan: GemmPlan) -> int:
    """int32 scratch of a split-K plan: arrival counters (whole int4s),
    then the tiles' sums (csrc/int8_matmul.cu sck_int8_matmul)."""
    tiles = -(-M // plan.bm) * -(-N // _GEMM_BN)
    return -(-tiles // 4) * 4 + tiles * plan.bm * _GEMM_BN


def int8_matmul_ref(x2: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """Plain version of K1 on ``x2`` (M, K): the JAX function's math.  The
    int8 product runs in float64, which is exact (every partial sum is an
    integer below 2^53) on any device and in any order; float32 would not be
    beyond 2^24 (16384 * 127^2 is more)."""
    xq, xs = quantize_rows(x2)
    acc = xq.double() @ values.double()
    return (acc.float() * xs * scales[None, :]).to(out_dtype)


def int8_matmul_cuda(x2: torch.Tensor, values: torch.Tensor,
                     scales: torch.Tensor, out_dtype: torch.dtype,
                     plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Launch K1.  Takes x2 (M, K) float32/bfloat16 contiguous, values
    (K, N) int8 K-major (:func:`k_major`) and scales (N,) float32
    contiguous, all on one card, x2 and values 16-byte aligned, with K a
    multiple of 16; raises on anything else.  ``plan`` replaces
    :func:`gemm_plan`'s for ``"mma_gemm"`` (measurement only)."""
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
    if K % 16:
        raise ValueError(f"{what}: K ({K}) must be a multiple of 16")
    if not is_k_major(values):
        raise ValueError(f"{what}: values must be K-major (the .t() view of "
                         f"a contiguous (N, K) buffer, strides (1, K)), not "
                         f"strides {values.stride()}; see k_major()")
    for name, t in (("x", x2), ("values", values)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start 16-byte aligned")
    for name, t in (("x", x2), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    x_code = _build.dtype_code(x2.dtype, what)
    o_code = _build.dtype_code(out_dtype, what)
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    if M == 0:
        return out
    dev = x2.device
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M,), dtype=torch.float32, device=dev)
    variant = int8_variant(M)
    if plan is None and variant == "mma_gemm":
        plan = gemm_plan(M, K, N, _build.sm_count(dev))
    if plan is None:
        plan = GemmPlan(0, 1)  # unused by "mma_gemv"
    scratch = None
    if variant == "mma_gemm" and plan.splits > 1:
        scratch = torch.empty((_gemm_scratch_ints(M, N, plan),),
                              dtype=torch.int32, device=dev)
    err = _build.load().sck_int8_matmul(
        _build.ptr(x2), _build.ptr(values), _build.ptr(scales),
        _build.ptr(xq), _build.ptr(xs), _build.ptr(out), M, K, N,
        x_code, o_code, _VARIANT_CODES[variant], plan.bm, plan.splits,
        None if scratch is None else _build.ptr(scratch),
        _build.stream_of(x2),
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
