"""Content-addressed prediction-cache keys (port of
``seldon_core_tpu/caching/key.py``; the digests are the reference's, byte
for byte, for the same payload).

A key is a stable 128-bit blake2b digest over everything that can change
a deterministic node's response:

- the tensor payload: raw bytes + shape + dtype (so ``[[1, 2], [3, 4]]``
  and ``[1, 2, 3, 4]`` never collide, nor do equal-byte float32/int32
  buffers); a torch tensor hashes as the numpy array of its values (a
  tensor on the card is copied to the host first), and a bfloat16 or
  float8 one by its raw bytes under its wire name (``bfloat16``, as the
  reference's ml_dtypes arrays name themselves);
- ``names`` (component name fallbacks read them);
- non-tensor payloads (``binData``/``strData``/``jsonData``, the last
  canonicalized with sorted keys);
- the node (or fused-segment) label, the graph name, and an optional
  model/deployment ``version`` string (the runner passes the
  ``seldon.io/spec-hash`` annotation so a weight rollout can never serve
  stale entries).

Per-request meta (puid, tags, routing) is deliberately EXCLUDED: cache
tiers only ever front deterministic pure nodes, which cannot read it, and
coalesced/hit responses re-stamp each caller's own meta.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.messages import wire_array

__all__ = ["message_key", "array_key", "raw_key"]

#: bump when the key layout changes — old entries must never alias new ones
_KEY_VERSION = b"skey1"


def _new_hash() -> "hashlib.blake2b":
    h = hashlib.blake2b(digest_size=16)
    h.update(_KEY_VERSION)
    return h


def _update_str(h, s: str) -> None:
    b = s.encode("utf-8", "surrogatepass")
    h.update(len(b).to_bytes(4, "little"))
    h.update(b)


def _update_array(h, arr: Any) -> bool:
    """Hash dtype + shape + raw bytes; False if the payload cannot be
    stably serialized (object dtype etc.) — caller must not cache."""
    if isinstance(arr, torch.Tensor):
        arr, dtype = wire_array(arr)  # host bytes and the dtype's name
    else:
        if not isinstance(arr, np.ndarray):
            arr = np.asarray(arr)
        if arr.dtype == object:
            return False
        dtype = str(arr.dtype)
    _update_str(h, dtype)
    h.update(len(arr.shape).to_bytes(1, "little"))
    for d in arr.shape:
        h.update(int(d).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(arr).tobytes())
    return True


def array_key(
    arr: Any,
    names: Any = (),
    node: str = "",
    graph: str = "",
    version: str = "",
) -> Optional[str]:
    """Key for a bare tensor payload (the fused-segment tier)."""
    h = _new_hash()
    _update_str(h, graph)
    _update_str(h, node)
    _update_str(h, version)
    if not _update_array(h, arr):
        return None
    for n in names or ():
        _update_str(h, str(n))
    return h.hexdigest()


def message_key(
    msg: Any,
    node: str = "",
    graph: str = "",
    version: str = "",
) -> Optional[str]:
    """Key for a SeldonMessage payload, or None when the message carries
    nothing stably hashable (then the caller must take the cold path)."""
    h = _new_hash()
    _update_str(h, graph)
    _update_str(h, node)
    _update_str(h, version)
    if msg.data is not None:
        h.update(b"d")
        if not _update_array(h, msg.data):
            return None
    elif msg.bin_data is not None:
        h.update(b"b")
        h.update(msg.bin_data)
    elif msg.str_data is not None:
        h.update(b"s")
        _update_str(h, msg.str_data)
    elif msg.json_data is not None:
        h.update(b"j")
        try:
            _update_str(h, json.dumps(msg.json_data, sort_keys=True))
        except (TypeError, ValueError):
            return None
    else:
        return None
    for n in msg.names or ():
        _update_str(h, str(n))
    return h.hexdigest()


def raw_key(*parts: Any) -> str:
    """Key over opaque byte/str parts (the reference's gateway tier hashes
    a raw request body this way)."""
    h = _new_hash()
    for p in parts:
        if isinstance(p, str):
            _update_str(h, p)
        else:
            b = bytes(p)
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()
