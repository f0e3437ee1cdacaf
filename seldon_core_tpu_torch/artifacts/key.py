"""Content-addressed artifact identity (port of
``seldon_core_tpu/artifacts/key.py``).

A captured bucket is valid for exactly one (segment program, bucket
shape, dtype, device topology, runtime) tuple; the key folds all of them
in, so any drift gives a miss and a live capture instead of a wrong
answer:

- **segment fingerprint**: member names and kinds, and a blake2b digest
  of every parameter tensor's bytes (a weight rollout re-fingerprints the
  segment).  Taken once per segment when the plan is attached.
- **bucket shape x dtype**: ``FusedSegment.bucket_key``.
- **mesh spec** and **sharding slice**: the reference's fields: the
  placement plane's ``seldon.io/mesh`` spec ("" without one) and, for a
  sharded bucket, the segment's armed mesh slice.
- **runtime identity** (the reference's jaxlib version): the torch
  version, ``torch.version.cuda``, cuDNN's version, the device's name, its
  SM count and the kernel library's ``source_hash()``.  The SM count is in
  because K1's ``gemm_plan`` and K2's ``paged_split_plan`` read it: a
  graph captured on one card's plans belongs to no other card.
- **format version**: the store's own layout escape hatch.

Keys are blake2b hex digests: equal keys mean byte-equal identity
material, and nothing about the inputs can be recovered from a key.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = ["FORMAT_VERSION", "runtime_identity", "segment_fingerprint",
           "artifact_key"]

#: bump when the payload layout or the key material changes (v3: the
#: runtime identity of the port replaces the jaxlib version)
FORMAT_VERSION = 3


def runtime_identity(device) -> str:
    """The runtime a captured graph is pinned to, on ``device``."""
    from seldon_core_tpu_torch.ops import _build

    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        sms = _build.sm_count(dev)
    else:
        name, sms = "cpu", 0
    cudnn = torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None
    return (f"torch={torch.__version__};cuda={torch.version.cuda};"
            f"cudnn={cudnn};device={name};sms={sms};"
            f"kernels={_build.source_hash()}")


def _digest_leaf(h, leaf) -> None:
    """One parameter leaf: shape, dtype and raw bytes for a tensor or an
    array; ``repr`` for a scalar, a string or None; the type's name for
    anything else (its ``repr`` may hold an address)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        if t.numel():
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif isinstance(leaf, np.ndarray):
        h.update(str(leaf.shape).encode())
        h.update(str(leaf.dtype).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    elif leaf is None or isinstance(leaf, (bool, int, float, str)):
        h.update(repr(leaf).encode())
    else:
        h.update(type(leaf).__qualname__.encode())


def _digest_tree(h, tree) -> None:
    """Pre-order walk over the params container (sorted dict keys, so
    insertion order cannot move the fingerprint); a module is its state
    dict."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.state_dict())
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            h.update(str(k).encode())
            _digest_tree(h, tree[k])
    elif isinstance(tree, (list, tuple)):
        h.update(f"[{len(tree)}]".encode())
        for item in tree:
            _digest_tree(h, item)
    else:
        _digest_leaf(h, tree)


def segment_fingerprint(segment) -> str:
    """Identity of one fused segment's program: member structure and the
    content of every parameter leaf (a copy to the host of every weight on
    the card, so it is taken once, when the plan is attached)."""
    h = hashlib.blake2b(digest_size=16)
    for st in segment.members:
        h.update(st.name.encode())
        h.update(b"\x00")
        h.update(st.kind.encode())
        h.update(b"\x00")
        _digest_tree(h, st.params)
        h.update(b"\x01")
    return h.hexdigest()


def artifact_key(segment_fp: str, bucket_shape: Iterable[int], dtype: str,
                 mesh_spec: str = "", runtime: Optional[str] = None,
                 format_version: int = FORMAT_VERSION,
                 sharding: str = "", device="cpu") -> str:
    """The store key: segment hash x bucket x dtype x mesh spec x sharding
    slice x runtime identity x format version, blake2b-hexed.  ``runtime``
    defaults to :func:`runtime_identity` of ``device``."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(segment_fp).encode())
    h.update(b"|")
    h.update("x".join(str(int(d)) for d in bucket_shape).encode())
    h.update(b"|")
    h.update(str(dtype).encode())
    h.update(b"|")
    h.update(str(mesh_spec or "").encode())
    h.update(b"|")
    h.update(str(sharding or "").encode())
    h.update(b"|")
    h.update((runtime if runtime is not None
              else runtime_identity(device)).encode())
    h.update(b"|")
    h.update(str(int(format_version)).encode())
    return h.hexdigest()
