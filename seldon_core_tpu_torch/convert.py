"""Reference params to port params.

:func:`params_from_jax` turns the JAX package's transformer params (a
nested dict of numpy arrays, float leaves or ``{"values", "scales"}``
quantized leaves, with tuples of per-layer arrays) into the port's params
on a given device, with the same layout and orientation: ``wq`` (D, H, Dh)
or int8 ``(D, H*Dh)``, int8 ``wo`` ``(H*Dh, D)``, ``w1`` (D, F), ``lm_head``
(D, V).  Tuples become Python lists.  The int8 ``values`` keep their (K, N)
shape but are stored K-major (``ops.quant.k_major``), the layout the int8
kernel reads.  It takes host arrays only (call
``jax.tree.map(np.asarray, params)`` first), so it needs no jax itself.
"""

from __future__ import annotations

import numpy as np
import torch

from seldon_core_tpu_torch.ops.quant import k_major

__all__ = ["params_from_jax", "to_torch"]


def to_torch(a, device=None) -> torch.Tensor:
    """One host array to a tensor; bfloat16 (``ml_dtypes``) arrays keep
    their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a private, writable copy
    return t.to(device)


def params_from_jax(tree, device=None):
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
