"""Kernel K2 (paged decode attention, ``csrc/paged_attention.cu``): one
query token of one slot against its context, per layer.

Bytes: the context's keys and values (``ctx x kv_heads x d_head`` each, in
the cache dtype), the query read and the output written.  Operations:
``4 heads d_head ctx`` (scores and the weighted sum), in bf16 against the
bf16 peak.  Only the slots that carry a request count: what these inputs
need, not what a launch over idle slots does.
"""

#: substrings of K2's kernel names
KERNELS = ("paged_decode_kernel",)


def token(ctx: int, heads: int, kv_heads: int, d_head: int,
          dtype_bytes: int = 2) -> tuple:
    """``(flops, bytes)`` of one slot's attention at context ``ctx`` in one
    layer."""
    return (4.0 * heads * d_head * ctx,
            float(2 * ctx * kv_heads * d_head * dtype_bytes
                  + 2 * heads * d_head * dtype_bytes))


def ideal_s(calls, peaks: dict) -> float:
    return sum(max(f / peaks["bf16_flops"], b / peaks["hbm_bytes"])
               for f, b in calls)
