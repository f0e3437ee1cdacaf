"""Reference params to port params.  Every function takes host arrays only
(call ``jax.tree.map(np.asarray, params)`` first), so it needs no jax.

:func:`params_from_jax` turns the JAX package's transformer params (a
nested dict of numpy arrays, float leaves or ``{"values", "scales"}``
quantized leaves, with tuples of per-layer arrays) into the port's params
on a given device, with the same layout and orientation: ``wq`` (D, H, Dh)
or int8 ``(D, H*Dh)``, int8 ``wo`` ``(H*Dh, D)``, ``w1`` (D, F), ``lm_head``
(D, V).  Tuples become Python lists.  The int8 ``values`` keep their (K, N)
shape but are stored K-major (``ops.quant.k_major``), the layout the int8
kernel reads.  With ``mesh`` (and the model's config) it places them
tensor-parallel as ``models.transformer.shard_params`` does: a reference
tree sharded over its mesh (float or int8 FFN leaves, as ``jax.device_get``
gives them, global arrays) arrives split the same way over the port's,
a MoE's ``router``/``w_in``/``w_out`` and the layer stack's pipeline stages
(``pp``) included.  The MLP's list of ``{"w", "b"}`` and the iris classifier's
``{"w", "b"}`` have the port's layout already, so it converts them too.

:func:`resnet_from_jax` loads the reference's flax ResNet variables
(``params`` and ``batch_stats``) into a port ``ResNet``,
:func:`resnet_to_jax` is its inverse (what the port's ``ResNet50Model``
exports), and
:func:`resnet_int8_from_jax` turns the reference's folded int8 ResNet
weights (``models/resnet_int8.py convert_params``) into the port's.  Conv
kernels go from flax's HWIO to torch's OIHW, stored channels_last, and
back.
"""

from __future__ import annotations

import numpy as np
import torch

from seldon_core_tpu_torch.ops.quant import QuantizedLinear, k_major

__all__ = ["params_from_jax", "to_torch", "resnet_from_jax",
           "resnet_to_jax", "resnet_int8_from_jax"]


def to_torch(a, device=None) -> torch.Tensor:
    """One host array (or a tensor, as a checkpoint loads) to a tensor;
    bfloat16 (``ml_dtypes``) arrays keep their bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a private, writable copy
    return t.to(device)


def params_from_jax(tree, device=None, mesh=None, cfg=None, pp: int = 1):
    if mesh is not None:
        from seldon_core_tpu_torch.models.transformer import shard_params

        if cfg is None:
            raise ValueError("placing over a mesh needs the model's cfg")
        return shard_params(params_from_jax(tree, device), mesh, cfg, pp=pp)
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device) for k, v in tree.items()}
        if "values" in out and "scales" in out:  # an int8 leaf
            vals = out["values"]
            out["values"] = ([k_major(v) for v in vals]
                             if isinstance(vals, list) else k_major(vals))
        return out
    if isinstance(tree, (tuple, list)):
        return [params_from_jax(v, device) for v in tree]
    return to_torch(tree, device)


def _oihw(kernel, device=None) -> torch.Tensor:
    """A flax HWIO conv kernel as an OIHW tensor, channels_last."""
    return to_torch(kernel, device).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def resnet_from_jax(variables, module):
    """Copy the flax ResNet ``variables`` into the port ``module`` (a
    ``models.resnet.ResNet`` of the same ``stage_sizes`` and classes), in
    place; each tensor takes the dtype the module keeps it in."""
    p, stats = variables["params"], variables["batch_stats"]

    def conv(dst, src):
        dst.weight.copy_(_oihw(src["kernel"]))

    def bn(dst, src, src_stats):
        for name, a in (("scale", src["scale"]), ("bias", src["bias"]),
                        ("mean", src_stats["mean"]),
                        ("var", src_stats["var"])):
            getattr(dst, name).copy_(to_torch(a))

    with torch.no_grad():
        conv(module.stem, p["Conv_0"])
        bn(module.stem_bn, p["BatchNorm_0"], stats["BatchNorm_0"])
        for i, blk in enumerate(module.blocks):
            bp, bs = p[f"Bottleneck_{i}"], stats[f"Bottleneck_{i}"]
            for j, (c, n) in enumerate(((blk.conv0, blk.bn0),
                                        (blk.conv1, blk.bn1),
                                        (blk.conv2, blk.bn2))):
                conv(c, bp[f"Conv_{j}"])
                bn(n, bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"])
            if blk.proj is not None:
                conv(blk.proj, bp["proj"])
                bn(blk.proj_bn, bp["proj_bn"], bs["proj_bn"])
        module.head_w.copy_(to_torch(p["Dense_0"]["kernel"]))
        module.head_b.copy_(to_torch(p["Dense_0"]["bias"]))
    return module


def resnet_to_jax(module) -> dict:
    """The flax variables (``params`` and ``batch_stats``) of the port
    ``module``, the exact inverse of :func:`resnet_from_jax`: HWIO conv
    kernels, flax's names, each leaf a contiguous CPU tensor in the dtype
    the module keeps it in (convs and the BN scale and bias in the serving
    dtype, the head and the BN statistics in float32)."""
    def host(t):
        return t.detach().cpu().contiguous()

    def conv(src):
        return {"kernel": host(src.weight.permute(2, 3, 1, 0))}

    def bn(src):
        return ({"bias": host(src.bias), "scale": host(src.scale)},
                {"mean": host(src.mean), "var": host(src.var)})

    params, stats = {}, {}
    params["Conv_0"] = conv(module.stem)
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(module.stem_bn)
    for i, blk in enumerate(module.blocks):
        bp, bs = {}, {}
        for j, (c, n) in enumerate(((blk.conv0, blk.bn0),
                                    (blk.conv1, blk.bn1),
                                    (blk.conv2, blk.bn2))):
            bp[f"Conv_{j}"] = conv(c)
            bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"] = bn(n)
        if blk.proj is not None:
            bp["proj"] = conv(blk.proj)
            bp["proj_bn"], bs["proj_bn"] = bn(blk.proj_bn)
        params[f"Bottleneck_{i}"], stats[f"Bottleneck_{i}"] = bp, bs
    params["Dense_0"] = {"bias": host(module.head_b),
                         "kernel": host(module.head_w)}
    return {"params": params, "batch_stats": stats}


def resnet_int8_from_jax(weights, device=None) -> dict:
    """The reference's folded int8 ResNet weights (``{"stem", "blocks",
    "head"}``, int8 leaves as ``(values, scales)``) in the port's layout."""
    def quantized(d):
        values, scales = d["q"]
        return {"q": QuantizedLinear(k_major(to_torch(values, device)),
                                     to_torch(scales, device)),
                "bias": to_torch(d["bias"], device)}

    def spatial(d):
        return {"kernel": _oihw(d["kernel"], device),
                "bias": to_torch(d["bias"], device)}

    blocks = []
    for b in weights["blocks"]:
        blk = {"c1": quantized(b["c1"]), "c2": spatial(b["c2"]),
               "c3": quantized(b["c3"])}
        if "proj" in b:
            blk["proj"] = quantized(b["proj"])
        blocks.append(blk)
    return {"stem": spatial(weights["stem"]), "blocks": blocks,
            "head": quantized(weights["head"])}
