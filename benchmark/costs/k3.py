"""Kernel K3 (flash attention, ``csrc/flash_attention.cu``): causal
prefill of one row of L tokens (the padded bucket the launch covers) in
one layer.

Operations: scores and weighted sum over the causal half, ``2 heads
d_head L (L + 1)``, in bf16 against the bf16 peak.  Bytes: q and the
output (``heads``), k and v (``kv_heads``), each ``L d_head``, read or
written once.
"""

#: substrings of K3's kernel names
KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_simt_kernel")


def prefill(L: int, heads: int, kv_heads: int, d_head: int,
            dtype_bytes: int = 2) -> tuple:
    """``(flops, bytes)`` of one row's causal attention in one layer."""
    return (2.0 * heads * d_head * L * (L + 1),
            float((2 * heads + 2 * kv_heads) * L * d_head * dtype_bytes))


def ideal_s(calls, peaks: dict) -> float:
    return sum(max(f / peaks["bf16_flops"], b / peaks["hbm_bytes"])
               for f, b in calls)
