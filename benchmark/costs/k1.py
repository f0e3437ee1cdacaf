"""Kernel K1 (the int8 product, ``csrc/int8_matmul.cu``): its operations
and bytes per launch, and the names its kernels run under on the card.

A launch of M rows takes x (M, K) in its activation dtype, the int8 weight
(K, N) and its (N,) float32 scales, quantizes x per row and writes (M, N)
in its output dtype: ``2 M N K`` integer operations, each input read once
and the output written once (the quantized rows live on chip or in L2).
"""

#: substrings of K1's kernel names (its quantize pass and both schedules)
KERNELS = ("quant_rows_kernel", "int8_gemv_kernel", "int8_gemm_kernel")


def launch(M: int, K: int, N: int, x_bytes: int = 2,
           out_bytes: int = 2) -> tuple:
    """``(int8 ops, bytes)`` of one launch."""
    return (2.0 * M * N * K,
            float(M * K * x_bytes + K * N + 4 * N + M * N * out_bytes))


def ideal_s(launches, peaks: dict) -> float:
    """Least time of ``launches`` ((ops, bytes) pairs) on the card: each
    launch bound by its larger of ops over the int8 peak and bytes over
    the memory bandwidth."""
    return sum(max(ops / peaks["int8_ops"], b / peaks["hbm_bytes"])
               for ops, b in launches)
