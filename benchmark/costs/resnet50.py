"""Work of the int8 ResNet-50's forward (bottlenecks with the stride on the
3x3 conv, "SAME" padding), from its stage sizes and image size: K1's
launches (every 1x1 conv on its B x H x W rows, and the head on float32
rows) and the useful operations per image for MFU (K1's int8 products
against the int8 peak; the 7x7 and 3x3 convs in bf16 against the bf16
peak)."""

from __future__ import annotations

from benchmark.costs import k1


def layers(stage_sizes=(3, 4, 6, 3), image: int = 224,
           classes: int = 1000) -> list:
    """``(kind, cin, cout, k, out_hw, in_hw)`` of every conv and the head,
    ``kind`` "int8" (a 1x1 on K1, or the head) or "bf16" (7x7, 3x3)."""
    out = []
    hw = -(-image // 2)
    out.append(("bf16", 3, 64, 7, hw, image))
    hw = -(-hw // 2)  # the 3x3/2 max-pool
    cin = 64
    for i, n in enumerate(stage_sizes):
        f = 64 * 2 ** i
        for j in range(n):
            s = 2 if i > 0 and j == 0 else 1
            ohw = -(-hw // s)
            out.append(("int8", cin, f, 1, hw, hw))
            out.append(("bf16", f, f, 3, ohw, hw))
            out.append(("int8", f, 4 * f, 1, ohw, ohw))
            if cin != 4 * f or s != 1:
                out.append(("int8", cin, 4 * f, 1, ohw, hw))
            cin, hw = 4 * f, ohw
    out.append(("head", cin, classes, 1, 1, 1))
    return out


def k1_forward(rows: int, stage_sizes=(3, 4, 6, 3), image: int = 224,
               classes: int = 1000) -> list:
    """K1 launches of one forward over ``rows`` images."""
    out = []
    for kind, cin, cout, _, ohw, _ in layers(stage_sizes, image, classes):
        if kind == "int8":
            out.append(k1.launch(rows * ohw * ohw, cin, cout))
        elif kind == "head":
            out.append(k1.launch(rows, cin, cout, x_bytes=4, out_bytes=4))
    return out


def image_work(stage_sizes=(3, 4, 6, 3), image: int = 224,
               classes: int = 1000) -> tuple:
    """``(int8 ops, bf16 flops)`` of one image."""
    i8 = f16 = 0.0
    for kind, cin, cout, k, ohw, _ in layers(stage_sizes, image, classes):
        w = 2.0 * ohw * ohw * cin * cout * k * k
        if kind == "bf16":
            f16 += w
        else:
            i8 += w
    return i8, f16
