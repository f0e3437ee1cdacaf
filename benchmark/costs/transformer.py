"""Work of the int8 transformer's steps, from the requests' own lengths:
K1's launches of a decode tick and of a prefill, and the model's useful
operations for MFU (int8 products against the int8 peak, attention in
bf16 against the bf16 peak)."""

from __future__ import annotations

from benchmark.costs import k1, k2, k3


def _projections(d) -> list:
    """(in, out) of each layer's products, in the order they run."""
    Dq, Dkv = d.heads * d.d_head, d.kv_heads * d.d_head
    return [(d.d_model, Dq), (d.d_model, Dkv), (d.d_model, Dkv),
            (Dq, d.d_model), (d.d_model, d.d_ff), (d.d_ff, d.d_model)]


def k1_tick(d, rows: int) -> list:
    """K1 launches of one decode tick over ``rows`` slots (every slot of
    the tick, busy or not: the launch covers them all): the layers'
    products and the head (float32 logits)."""
    out = [k1.launch(rows, K, N) for _ in range(d.layers)
           for K, N in _projections(d)]
    out.append(k1.launch(rows, d.d_model, d.vocab, out_bytes=2))
    return out


def k1_prefill(d, bucket: int, rows: int = 1) -> list:
    """K1 launches of one prefill of ``rows`` x ``bucket`` padded tokens;
    only each row's last position goes through the head."""
    M = rows * bucket
    out = [k1.launch(M, K, N) for _ in range(d.layers)
           for K, N in _projections(d)]
    out.append(k1.launch(rows, d.d_model, d.vocab, out_bytes=2))
    return out


def k2_token(d, ctx: int) -> list:
    """K2's work for one slot's decode token at context ``ctx`` (itself
    included), every layer."""
    return [k2.token(ctx, d.heads, d.kv_heads, d.d_head)] * d.layers


def k3_prefill(d, bucket: int) -> list:
    return [k3.prefill(bucket, d.heads, d.kv_heads, d.d_head)] * d.layers


def linear_ops_per_token(d) -> float:
    return 2.0 * d.layers * sum(K * N for K, N in _projections(d))


def decode_token_work(d, ctx: int) -> tuple:
    """``(int8 ops, bf16 flops)`` of one generated token at context
    ``ctx``: every product and the head, and attention over ``ctx``."""
    return (linear_ops_per_token(d) + 2.0 * d.d_model * d.vocab,
            4.0 * d.heads * d.d_head * ctx * d.layers)


def prefill_work(d, L: int) -> tuple:
    """``(int8 ops, bf16 flops)`` of a prompt of ``L`` true tokens (no
    padding): the products of every token, the head of the last, causal
    attention."""
    return (linear_ops_per_token(d) * L + 2.0 * d.d_model * d.vocab,
            2.0 * d.heads * d.d_head * L * (L + 1) * d.layers)
