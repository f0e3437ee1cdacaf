"""Model-weights checkpoints (port of ``seldon_core_tpu/runtime/checkpoint.py``).

A checkpoint is a directory holding ``model.safetensors`` (every tensor of
a param tree, plus the tree's structure and the model config in the
file's metadata) and ``config.json`` (a readable copy of that metadata).
The format is the reference's, byte for byte in what it means: the port
reads what the reference writes and the reference reads what the port
writes.

The safetensors file is read and written here without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header (``dtype``,
``shape``, ``data_offsets`` per tensor, and ``__metadata__``) padded with
spaces to 8 bytes, then the tensors' bytes back to back.  Tensors load
with ``torch.frombuffer`` over a copy-on-write ``mmap`` of the file.

Trees are nested dicts (plain dot-free string keys), lists, tuples
(marked, as JSON has none), scalars and tensors (torch or numpy).
Transformer trees quantize at LOAD (:func:`load_transformer`), so int8
weights come out K-major as the int8 kernel reads them; a tree saved
already quantized loads verbatim, its int8 leaves put K-major.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "export_checkpoint",
    "load_checkpoint",
    "save_transformer",
    "load_transformer",
    "resolve_model_uri",
    "read_safetensors",
    "write_safetensors",
]

TENSOR_FILE = "model.safetensors"
CONFIG_FILE = "config.json"
FORMAT_VERSION = 1

# skeleton markers (reserved keys: tree dict keys must not collide)
_T, _TUP, _VAL = "__tensor__", "__tuple__", "__value__"
_RESERVED = (_T, _TUP, _VAL)

# safetensors dtype codes
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_CODES = {v: k for k, v in _DTYPES.items()}
# numpy dtypes torch has no tensor type for: read as these, then viewed
_NP_ONLY = {"U16": np.uint16, "U32": np.uint32, "U64": np.uint64}


# ----------------------------------------------------------------------
# the safetensors file
# ----------------------------------------------------------------------

_NP_CODES = {np.dtype(v): k for k, v in _NP_ONLY.items()}


def _as_tensor(x) -> torch.Tensor:
    """A host tensor of any tree leaf (numpy arrays with ``ml_dtypes``
    bfloat16 keep their bits)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _encode(name: str, x) -> tuple:
    """``(code, element size, shape, bytes)`` of one leaf."""
    if not isinstance(x, torch.Tensor) and np.asarray(x).dtype in _NP_CODES:
        a = np.ascontiguousarray(x)
        return _NP_CODES[a.dtype], a.itemsize, list(a.shape), a.tobytes()
    t = _as_tensor(x).contiguous()
    if t.dtype not in _CODES:
        raise TypeError(f"{name!r}: dtype {t.dtype} has no safetensors "
                        "code here")
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return (_CODES[t.dtype], t.element_size(), list(t.shape),
            raw.numpy().tobytes())


def write_safetensors(path: str, tensors: dict, metadata: dict) -> None:
    """Write ``{name: tensor}`` and string ``metadata`` as a safetensors
    file.  Tensors go largest element first (then by name), so every
    tensor starts aligned to its element size, as the format's own writer
    does."""
    items = [(name,) + _encode(name, x) for name, x in tensors.items()]
    items.sort(key=lambda it: (-it[2], it[0]))
    header: dict[str, Any] = {"__metadata__": {str(k): str(v)
                                               for k, v in metadata.items()}}
    blobs, off = [], 0
    for name, code, _, shape, b in items:
        header[name] = {"dtype": code, "shape": shape,
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)
        f.flush()
        os.fsync(f.fileno())


def read_safetensors(path: str) -> tuple[dict, dict]:
    """``({name: CPU tensor}, metadata)`` of a safetensors file.  Tensors
    share a copy-on-write map of the file (no read of the data until it is
    used); one that does not start aligned to its element size is
    copied."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path!r} is not a safetensors file (too "
                             "short)")
        (n,) = struct.unpack("<Q", head)
        size = os.fstat(f.fileno()).st_size
        if n > min(size - 8, 100 << 20):
            raise ValueError(f"{path!r} is not a safetensors file (header "
                             f"length {n})")
        raw = f.read(n)
        try:
            header = json.loads(raw.decode())
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"{path!r} is not a safetensors file "
                             f"({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path!r}: header is not a JSON object")
        base = 8 + n
        data = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                if size > base else bytearray())
    metadata = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        code = info["dtype"]
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        if code in _DTYPES:
            dt = _DTYPES[code]
            itemsize = torch.empty((), dtype=dt).element_size()
        elif code in _NP_ONLY:
            dt = None
            itemsize = np.dtype(_NP_ONLY[code]).itemsize
        else:
            raise ValueError(f"{name!r}: unsupported safetensors dtype "
                             f"{code}")
        count = int(np.prod(shape)) if shape else 1
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{name!r}: data_offsets {info['data_offsets']} "
                             f"do not hold {shape} {code}")
        if dt is None:
            arr = np.frombuffer(data, _NP_ONLY[code], count, base + begin)
            out[name] = arr.reshape(shape).copy()
            continue
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
        elif (base + begin) % itemsize:
            chunk = bytearray(data[base + begin:base + end])
            out[name] = torch.frombuffer(chunk, dtype=dt).reshape(shape)
        else:
            out[name] = torch.frombuffer(data, dtype=dt, count=count,
                                         offset=base + begin).reshape(shape)
    return out, metadata


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------

def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _flatten(tree: Any, path: str, tensors: dict) -> Any:
    """Tree to JSON skeleton; array leaves land in ``tensors`` under their
    dotted path.  Tuples are marked (the reference's int8 layout keeps
    per-layer tuples); dict keys must be dot-free strings."""
    if _is_array(tree):
        if isinstance(tree, (np.ndarray, np.generic)) and \
                np.asarray(tree).dtype == object:
            raise TypeError(f"non-numeric array at {path!r}")
        tensors[path] = tree
        return {_T: path}
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            # '.' would alias into another path's tensor name
            if not isinstance(k, str) or k in _RESERVED or "." in k:
                raise TypeError(f"checkpoint dict keys must be plain "
                                f"dot-free strings, got {k!r} at {path!r}")
            out[k] = _flatten(tree[k], f"{path}.{k}" if path else k, tensors)
        return out
    if isinstance(tree, tuple):
        return {_TUP: [_flatten(v, f"{path}.{i}", tensors)
                       for i, v in enumerate(tree)]}
    if isinstance(tree, list):
        return [_flatten(v, f"{path}.{i}", tensors)
                for i, v in enumerate(tree)]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {_VAL: tree}
    raise TypeError(f"unsupported leaf {type(tree).__name__} at {path!r}")


def _unflatten(skel: Any, tensors: dict) -> Any:
    if isinstance(skel, dict):
        if _T in skel:
            return tensors[skel[_T]]
        if _TUP in skel:
            return tuple(_unflatten(v, tensors) for v in skel[_TUP])
        if _VAL in skel:
            return skel[_VAL]
        return {k: _unflatten(v, tensors) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, tensors) for v in skel]
    raise ValueError(f"corrupt skeleton node {skel!r}")


def save_checkpoint(path: str, tree: Any, model_config: Optional[dict] = None,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` and ``model_config`` to directory ``path``.  Device
    tensors are copied to the host.  The tensor file carries the skeleton
    and config in its metadata and lands by a write to a temporary name and
    a rename, so a save over an existing checkpoint leaves the old one or
    the new one, never a mix; ``config.json`` is written after."""
    os.makedirs(path, exist_ok=True)
    tensors: dict = {}
    skeleton = _flatten(tree, "", tensors)
    cfg = {"format_version": FORMAT_VERSION, "model": model_config or {},
           "skeleton": skeleton}
    cfg_json = json.dumps(cfg)
    # both keys: "seldon_checkpoint" is what earlier readers look for
    meta = {"framework": "seldon-core-tpu", "seldon.checkpoint": cfg_json,
            "seldon_checkpoint": cfg_json}
    for k, v in (metadata or {}).items():
        if str(k) in meta:
            raise ValueError(
                f"metadata key {k!r} is reserved by the checkpoint format")
        meta[str(k)] = str(v)
    final = os.path.join(path, TENSOR_FILE)
    tmp = f"{final}.tmp.{os.getpid()}"
    write_safetensors(tmp, tensors, meta)
    os.replace(tmp, final)
    tmp = os.path.join(path, f"{CONFIG_FILE}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(cfg, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, CONFIG_FILE))
    return path


def _jax_order(tree: Any) -> Any:
    """``tree`` with every dict's keys sorted, as jax's tree functions
    rebuild a tree."""
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_order(v) for v in tree)
    return tree


def export_checkpoint(path: str, tree: Any,
                      model_config: Optional[dict] = None) -> str:
    """Write a model's weights as the reference's ``save_checkpoint`` method
    writes them: its tree has been rebuilt by jax, so every dict's keys are
    sorted and the skeleton is in that order.  Every model's export goes
    through here."""
    return save_checkpoint(path, _jax_order(tree), model_config)


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Read a checkpoint directory: ``(tree of CPU tensors, model_config)``.
    The skeleton comes from the tensor file's own metadata."""
    tensor_path = os.path.join(path, TENSOR_FILE)
    if not os.path.exists(tensor_path):
        raise FileNotFoundError(
            f"{path!r} is not a checkpoint directory ({TENSOR_FILE} missing"
            " - interrupted save, or wrong model_uri?)")
    tensors, md = read_safetensors(tensor_path)
    raw = md.get("seldon.checkpoint") or md.get("seldon_checkpoint")
    if raw is None:
        raise ValueError(
            f"{tensor_path!r} carries no seldon.checkpoint metadata (foreign "
            "safetensors file? convert via save_checkpoint)")
    cfg = json.loads(raw)
    ver = cfg.get("format_version")
    if ver != FORMAT_VERSION:
        raise ValueError(f"checkpoint format_version {ver!r} unsupported "
                         f"(expected {FORMAT_VERSION})")
    return _unflatten(cfg["skeleton"], tensors), cfg.get("model", {})


# ----------------------------------------------------------------------
# transformer weights
# ----------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _transformer_config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    d["family"] = "transformer"
    return d


def _transformer_config(d: dict):
    """The port's config from a saved one (the reference's fields, MoE
    ones included, all kept)."""
    from seldon_core_tpu_torch.models.transformer import TransformerConfig

    names = {f.name for f in dataclasses.fields(TransformerConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return TransformerConfig(**kw)


def save_transformer(path: str, params: dict, cfg,
                     metadata: Optional[dict] = None) -> str:
    """Save transformer params and their :class:`TransformerConfig`.
    Canonical (unquantized) trees re-target any int8 mode at load; a
    quantized tree saves with its int8 leaves as tuples (the reference's
    layout) and loads only as it is."""
    return save_checkpoint(path, _int8_lists_as_tuples(params),
                           _transformer_config_dict(cfg), metadata=metadata)


def _int8_lists_as_tuples(tree):
    """The port's per-layer int8 lists as the reference's tuples (the file
    stores every tensor row-major, so K-major values are copied)."""
    if isinstance(tree, dict):
        return {k: (tuple(v) if isinstance(v, list)
                    and k in ("values", "scales")
                    else _int8_lists_as_tuples(v))
                for k, v in tree.items()}
    return tree


def _int8_k_major(tree):
    """A loaded quantized tree in the port's layout: per-layer tuples as
    lists, int8 ``values`` K-major."""
    from seldon_core_tpu_torch.ops.quant import k_major

    if isinstance(tree, dict):
        out = {k: _int8_k_major(v) for k, v in tree.items()}
        if "values" in out and "scales" in out:
            vals = out["values"]
            out["values"] = ([k_major(v) for v in vals]
                             if isinstance(vals, list) else k_major(vals))
        return out
    if isinstance(tree, (tuple, list)):
        return [_int8_k_major(v) for v in tree]
    return tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree if device is None else tree.to(device)


def load_transformer(path: str, mesh=None, int8: str = "none", device=None):
    """Load transformer weights for serving: ``(params on device, cfg)``.

    - ``int8``: "ffn" / "full" quantize at load, per channel and
      deterministically, so a loaded engine equals one quantized in
      process from the same weights; "none" / "as-saved" serve the stored
      dtype.
    - ``mesh``: the tensor-parallel placement of ``shard_params`` (and of
      ``quantize_ffn_params(mesh=)`` under int8 "ffn"), the placement a
      seeded tp engine uses, so a restored tp engine serves as the one that
      saved; the mesh brings its devices (``device`` is not read).
      ``int8="full"`` is refused with a mesh: int8 attention projections
      serve on one device.
    - A tree saved already quantized loads verbatim (``int8`` "none" or
      "as-saved", no ``mesh``), its int8 leaves put K-major.
    """
    from seldon_core_tpu_torch.models.transformer import (
        has_quantized_params,
        quantize_attn_params,
        quantize_ffn_params,
        shard_params,
    )

    params, model_cfg = load_checkpoint(path)
    fam = model_cfg.get("family")
    if fam != "transformer":
        raise ValueError(f"{path!r} holds a {fam!r} model, not a transformer")
    cfg = _transformer_config(model_cfg)
    if has_quantized_params(params):
        if int8 not in ("none", "as-saved") or mesh is not None:
            raise ValueError(
                "checkpoint stores an already-quantized tree: it loads "
                "verbatim only (int8='none', mesh=None) - save canonical "
                "weights to re-target tp/int8 at deployment time")
        return _int8_k_major(_to(params, device)), cfg
    if int8 not in ("none", "as-saved", "ffn", "full"):
        raise ValueError(f"unknown int8 mode {int8!r}")
    if int8 == "full" and mesh is not None:
        raise ValueError("int8='full' is single-chip (see "
                         "quantize_attn_params); use int8='ffn' with tp")
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
    else:
        params = _to(params, device)
    if int8 in ("ffn", "full"):
        params = quantize_ffn_params(params, mesh=mesh)
    if int8 == "full":
        params = quantize_attn_params(params)
    return params, cfg


# ----------------------------------------------------------------------
# model_uri
# ----------------------------------------------------------------------

_SCHEME = re.compile(r"^[a-z][a-z0-9+.-]*://", re.IGNORECASE)


def resolve_model_uri(uri: str) -> str:
    """A ``model_uri`` parameter as a local checkpoint directory: ``file://``
    and bare paths resolve directly; a remote scheme (gs://, s3://,
    http(s)://) is materialized by the operator's storage initContainer
    in a cluster, so seeing one here is an error."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if _SCHEME.match(uri):
        raise ValueError(
            f"remote model_uri {uri!r} reaches the component unmaterialized:"
            " in a cluster the operator's model-initializer initContainer "
            "downloads it and rewrites the parameter to the local mount; for "
            "the local runtime pass a filesystem path or file:// URI")
    return uri
