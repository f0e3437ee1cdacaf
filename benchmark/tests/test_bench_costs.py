"""The cost functions against hand counts at small shapes."""

import pytest

from benchmark.costs import k1, k2, k3, resnet50, transformer
from benchmark.families import transformer_int8

PEAKS = {"int8_ops": 1000.0, "bf16_flops": 500.0, "hbm_bytes": 100.0}


def test_k1_launch():
    ops, b = k1.launch(2, 3, 4)
    assert ops == 2 * 2 * 3 * 4
    # x bf16 (2x3x2) + int8 weight 3x4 + scales 4x4 + out bf16 2x4x2
    assert b == 12 + 12 + 16 + 16
    assert k1.ideal_s([(1000.0, 50.0), (10.0, 200.0)], PEAKS) == \
        pytest.approx(1.0 + 2.0)


def test_k2_token_and_k3_prefill():
    f, b = k2.token(ctx=5, heads=4, kv_heads=2, d_head=8)
    assert f == 4 * 4 * 8 * 5
    assert b == 2 * 5 * 2 * 8 * 2 + 2 * 4 * 8 * 2
    f, b = k3.prefill(L=3, heads=2, kv_heads=1, d_head=4)
    # causal pairs 3 * 4 / 2 = 6, two products of 2 * d_head each, 2 heads
    assert f == 6 * 2 * 2 * 4 * 2
    assert b == (2 * 2 + 2 * 1) * 3 * 4 * 2


def test_transformer_work_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "num_hidden_layers": 3,
           "intermediate_size": 16, "vocab_size": 10, "rope_theta": 1e4,
           "norm_epsilon": 1e-6}
    d = transformer_int8.dims(cfg)
    # per layer: q 8x8, k 8x4, v 8x4, o 8x8, w1 8x16, w2 16x8
    per_layer = 64 + 32 + 32 + 64 + 128 + 128
    assert transformer.linear_ops_per_token(d) == 2 * 3 * per_layer
    i8, f16 = transformer.decode_token_work(d, ctx=7)
    assert i8 == 2 * 3 * per_layer + 2 * 8 * 10
    assert f16 == 4 * 2 * 4 * 7 * 3
    i8, f16 = transformer.prefill_work(d, 5)
    assert i8 == 2 * 3 * per_layer * 5 + 2 * 8 * 10
    assert f16 == 2 * 2 * 4 * 5 * 6 * 3
    tick = transformer.k1_tick(d, rows=4)
    assert len(tick) == 3 * 6 + 1
    assert sum(ops for ops, _ in tick) == 4 * (2 * 3 * per_layer
                                               + 2 * 8 * 10)
    pf = transformer.k1_prefill(d, bucket=16)
    assert pf[0] == k1.launch(16, 8, 8) and pf[-1] == k1.launch(1, 8, 10)


def test_resnet50_counts():
    i8, f16 = resnet50.image_work()
    # ResNet-50 (stride on the 3x3): about 4.1 G multiply-adds an image
    assert (i8 + f16) / 2 == pytest.approx(4.089e9, rel=1e-3)
    lay = resnet50.layers()
    assert sum(1 for x in lay if x[0] != "bf16") == 37
    assert len(resnet50.k1_forward(64)) == 37
    first = resnet50.k1_forward(64)[0]
    assert first == k1.launch(64 * 56 * 56, 64, 64)
