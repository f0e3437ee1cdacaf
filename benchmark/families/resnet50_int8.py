"""ResNet-50 served int8 by the port's graph engine: the benchmark's
weights in the port's ``ResNet`` module, through ``Int8ResNet50Model``
(BatchNorms folded into the convs, every 1x1 conv and the head on K1, the
7x7 and 3x3 convs on cuDNN), booted by ``operator/local.py`` from the
cell's SeldonDeployment.

The weights are made from the seed on the card, in the dtypes the module
keeps them in (bf16 convs, BatchNorm scale and bias; float32 running
statistics and head), in one draw per kind.  Unlike the port's own seeded
init, every BatchNorm has a non-zero scale and random statistics, so that
every conv changes the answer and the comparison sees each of them.

The spec names :class:`SeededInt8ResNet50` as its ``model_class``: the
deployment's node builds it from its ``seed`` parameter, which the
driver sets to the run's seed.
"""

from __future__ import annotations

import torch

__all__ = ["make_weights", "SeededInt8ResNet50", "build_system",
           "counters"]


def _convs(stage_sizes) -> list:
    """``(name, cout, cin, k)`` of every conv, in the module's order."""
    out = [("stem", 64, 3, 7)]
    cin = 64
    for i, n in enumerate(stage_sizes):
        f = 64 * 2 ** i
        for j in range(n):
            s = 2 if i > 0 and j == 0 else 1
            b = f"b{len(out)}"
            out += [(b + ".c1", f, cin, 1), (b + ".c2", f, f, 3),
                    (b + ".c3", 4 * f, f, 1)]
            if cin != 4 * f or s != 1:
                out.append((b + ".proj", 4 * f, cin, 1))
            cin = 4 * f
    return out


def make_weights(seed: int, stage_sizes=(3, 4, 6, 3), classes: int = 1000,
                 device="cuda", input_scale: float = 1.0) -> dict:
    """``conv``: a list of (cout, cin, k, k) bf16 kernels scaled by
    fan_in^-1/2 (the stem's also by ``input_scale``: a model that takes
    raw pixels folds their scaling into its first conv); ``bn``: per conv
    (scale, bias) bf16 and (mean, var) float32; ``head_w`` (2048, classes)
    and ``head_b`` float32."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    convs = _convs(stage_sizes)
    sizes = [co * ci * k * k for _, co, ci, k in convs]
    flat = torch.randn((sum(sizes),), generator=g, device=device,
                       dtype=torch.bfloat16)
    chans = sum(co for _, co, _, _ in convs)
    bn = torch.rand((4, chans), generator=g, device=device)
    w = {"conv": [], "bn": []}
    at = c_at = 0
    for (name, co, ci, k), n in zip(convs, sizes):
        kern = flat[at:at + n].view(co, ci, k, k) * (
            (ci * k * k) ** -0.5 * (input_scale if name == "stem" else 1.0))
        w["conv"].append(kern)
        scale = bn[0, c_at:c_at + co] * 0.5 + 0.5
        if name.endswith(".c3"):
            scale = scale * 0.5  # each branch's last BN: a smaller step
        w["bn"].append((scale.to(torch.bfloat16),
                        ((bn[1, c_at:c_at + co] - 0.5) * 0.2
                         ).to(torch.bfloat16),
                        (bn[2, c_at:c_at + co] - 0.5) * 0.2,
                        bn[3, c_at:c_at + co] + 0.5))
        at += n
        c_at += co
    cin = 64 * 2 ** (len(stage_sizes) - 1) * 4
    w["head_w"] = torch.randn((cin, classes), generator=g,
                              device=device) * cin ** -0.5
    w["head_b"] = (torch.rand((classes,), generator=g, device=device)
                   - 0.5) * 0.2
    return w


def _module(w: dict, stage_sizes, classes: int, device):
    """The port's ``ResNet`` holding ``w``."""
    from seldon_core_tpu_torch.models.resnet import ResNet

    m = ResNet(stage_sizes=stage_sizes, num_classes=classes).to(device)
    pairs = [(m.stem, m.stem_bn)]
    for blk in m.blocks:
        pairs += [(blk.conv0, blk.bn0), (blk.conv1, blk.bn1),
                  (blk.conv2, blk.bn2)]
        if blk.proj is not None:
            pairs.append((blk.proj, blk.proj_bn))
    if len(pairs) != len(w["conv"]):
        raise ValueError("the weights do not fit the module's convs")
    with torch.no_grad():
        for (conv, bn), k, (s, b, mu, var) in zip(pairs, w["conv"],
                                                 w["bn"]):
            conv.weight.copy_(k)
            bn.scale.copy_(s)
            bn.bias.copy_(b)
            bn.mean.copy_(mu)
            bn.var.copy_(var)
        m.head_w.copy_(w["head_w"])
        m.head_b.copy_(w["head_b"])
    return m


class SeededInt8ResNet50:
    """The port's ``Int8ResNet50Model`` over the benchmark's weights for
    ``seed`` (its graph component: ``predict_fn``, ``params``,
    ``input_shape`` are the port's)."""

    def __new__(cls, seed: int = 0, num_classes: int = 1000,
                image_size: int = 224, stage_sizes: str = "3,4,6,3",
                input_scale: float = 1.0, device: str = "cuda"):
        from seldon_core_tpu_torch.models.resnet import ResNet50Model
        from seldon_core_tpu_torch.models.resnet_int8 import (
            Int8ResNet50Model,
        )

        stages = tuple(int(x) for x in str(stage_sizes).split(","))
        w = make_weights(seed, stages, num_classes, device, input_scale)
        src = ResNet50Model(num_classes=num_classes, image_size=image_size,
                            device=device,
                            module=_module(w, stages, num_classes, device))
        return Int8ResNet50Model(num_classes=num_classes,
                                 image_size=image_size, source=src,
                                 device=device)


def build_system(deployment: dict, device: str):
    """The ``LocalDeployment`` the port's local runner boots from
    ``deployment`` (a SeldonDeployment as a dict)."""
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    return LocalDeployment(load_deployment(deployment), device=device,
                           publish_status=False)


def counters(dep) -> dict:
    """Batches, rows and pad rows of the fused segments' batchers, and the
    segments' replays and captured buckets, over the deployment's first
    engine."""
    out = {"batches": 0, "rows": 0, "pad_rows": 0, "replays": 0,
           "buckets": 0}
    plan = dep.engine.plan
    for s in (plan.segments if plan else ()):
        if s.batcher is not None:
            for k in ("batches", "rows", "pad_rows"):
                out[k] += s.batcher.stats[k]
        out["replays"] += s.n_replays
        out["buckets"] += len(s.capture_s)
    return out
