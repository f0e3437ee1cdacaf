"""Published peaks of the cards the benchmark knows, dense rates without
sparsity, at the card's full power limit (NVIDIA H100 data sheet, SXM
part: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s HBM3).  A card not in
the table has no peaks: rooflines and MFU are then left out of the line,
never read against another card's numbers."""

from __future__ import annotations

from typing import Optional

__all__ = ["PEAKS", "peaks_for"]

PEAKS = {
    # torch.cuda.get_device_name() of the SXM part
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "fp8_flops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks_for(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)
