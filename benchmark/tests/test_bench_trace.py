"""The traced slice's reduction on hand-made events."""

import pytest

from benchmark.core import trace


def test_union_and_idle_gaps_named_by_host_op():
    dev = [(0, 100, "int8_gemm_kernel<1>"), (50, 150, "paged_decode_kernel"),
           (400, 500, "int8_gemm_kernel<1>"), (600, 700, "elementwise")]
    host = [(90, 700, "tick"), (200, 300, "aten::sort"),
            (120, 390, "cudaGraphLaunch")]
    r = trace.reduce_events(dev, host, slice_s=1e-6)
    assert r["busy_s"] == pytest.approx(350e-9)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::sort", pytest.approx(250e-9)]
    assert gaps[1] == ["tick", pytest.approx(100e-9)]
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["int8_gemm_kernel<1>"] == pytest.approx(200e-9)
    s = trace.Slice()
    s.result = r
    assert s.kernel_s(("int8_gemm_kernel",)) == pytest.approx(200e-9)
    assert s.kernel_s(("flash_fwd_mma_kernel",)) is None


def test_slice_on_the_cpu_reads_host_time():
    import torch

    s = trace.Slice()
    s.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    s.stop()
    r = s.reduce()
    assert r["window_s"] > 0 and r["busy_s"] == 0.0
