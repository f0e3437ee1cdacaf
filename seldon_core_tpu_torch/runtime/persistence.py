"""State persistence for learning components: routers and outlier
detectors (port of ``seldon_core_tpu/runtime/persistence.py``).

A component with ``get_state()``/``set_state()`` (``EpsilonGreedy``,
``MahalanobisOutlier``) has its state pushed to a store under
``persistence_<deployment>_<predictor>_<unit>`` every ``push_frequency``
seconds and restored at boot (:class:`PersistenceManager`).  Stores:
:class:`FileStateStore` (one file per key, atomic writes; a PVC in k8s) and
:class:`MemoryStateStore` (one process).

The port's blob is its own and holds no pickle: ``b"SNTT1"``, the byte
length of an npz archive of the state's array leaves (loaded with
``allow_pickle=False``), the archive, then the state's structure as JSON
(dicts with string keys, lists, numbers, strings, None, and numpy or torch
arrays by index into the archive).  The reference's blob
pickles a jax treedef (``SNST1``) or the whole object (``SNPK1``): neither
can be read without jax or unpickled safely, so both are refused with an
error, never misread.  A component without ``get_state``/``set_state`` is
refused too (the reference pickles it whole).  The orbax backend needs jax
and is refused by name.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
from typing import Any, Optional, Protocol

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "StateStore",
    "FileStateStore",
    "MemoryStateStore",
    "OrbaxStateStore",
    "persistence_key",
    "pack_state",
    "unpack_state",
    "PersistenceManager",
    "store_from_env",
]

DEFAULT_PUSH_FREQUENCY = 60.0  # seconds

_MAGIC = b"SNTT1"
# the reference's blobs: a pickled jax treedef, a pickled object
_REFERENCE_MAGICS = {b"SNST1": "a state blob with a pickled jax treedef",
                     b"SNPK1": "a pickled component"}


def persistence_key(deployment: str, predictor: str, unit: str) -> str:
    return f"persistence_{deployment}_{predictor}_{unit}"


class StateStore(Protocol):
    def save(self, key: str, blob: bytes) -> None: ...

    def load(self, key: str) -> Optional[bytes]: ...


class MemoryStateStore:
    """In-process store (tests, one process)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}

    def save(self, key: str, blob: bytes) -> None:
        self._data[key] = blob

    def load(self, key: str) -> Optional[bytes]:
        return self._data.get(key)


class FileStateStore:
    """One file per key under ``root``; writes are atomic (a temporary
    file, fsync, rename).

    With ``require_owner=True`` the root must belong to the current user
    (and loses group and world write): another local user who could create
    the directory first could plant state there.  It is set for the
    implicit default root only; an explicit ``SELDON_STATE_DIR`` is the
    operator's choice."""

    def __init__(self, root: str, require_owner: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        if require_owner and hasattr(os, "getuid"):
            st = os.stat(root)
            if st.st_uid != os.getuid():
                raise PermissionError(
                    f"state dir {root!r} is owned by uid {st.st_uid}, not "
                    f"the current user ({os.getuid()}): refusing to load "
                    "state from a directory another user controls")
            if st.st_mode & 0o022:
                os.chmod(root, st.st_mode & ~0o022)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key.replace('/', '_')}.state")

    def save(self, key: str, blob: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()


class OrbaxStateStore:
    """The reference's orbax backend, which needs orbax and jax: refused."""

    def __init__(self, root: str):
        raise NotImplementedError(
            "the orbax state backend (SELDON_STATE_BACKEND=orbax) needs "
            "orbax and jax, which the PyTorch port does not use; use the "
            "file backend (SELDON_STATE_BACKEND=file)")


# ---- the state blob ----------------------------------------------------

def _encode(x: Any, arrays: list) -> Any:
    if isinstance(x, torch.Tensor):
        arrays.append(x.detach().cpu().numpy())
        return {"array": len(arrays) - 1, "torch": True}
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype.hasobject:
            raise TypeError("state arrays of Python objects are not stored "
                            "(they would need pickle)")
        arrays.append(a)
        return {"array": len(arrays) - 1, "scalar": isinstance(x, np.generic)}
    if isinstance(x, dict):
        if not all(isinstance(k, str) for k in x):
            raise TypeError("state dict keys must be strings")
        return {"dict": {k: _encode(v, arrays) for k, v in x.items()}}
    if isinstance(x, (list, tuple)):  # a tuple comes back as a list
        return {"list": [_encode(v, arrays) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"cannot store a state leaf of type {type(x).__name__}")


def _decode(node: dict, npz) -> Any:
    if "array" in node:
        a = npz[f"a{node['array']}"]
        if node.get("torch"):
            return torch.from_numpy(a)
        return a[()] if node.get("scalar") else a
    if "dict" in node:
        return {k: _decode(v, npz) for k, v in node["dict"].items()}
    if "list" in node:
        return [_decode(v, npz) for v in node["list"]]
    if "value" in node:
        return node["value"]
    raise ValueError(f"unknown state node {sorted(node)}")


def pack_state(state: Any) -> bytes:
    """The port's blob of ``state`` (module docstring)."""
    arrays: list = []
    structure = json.dumps(_encode(state, arrays)).encode()
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
    npz = buf.getvalue()
    return _MAGIC + len(npz).to_bytes(8, "little") + npz + structure


def unpack_state(blob: bytes) -> Any:
    """The state of a port blob; a reference blob or anything else raises
    ``ValueError``."""
    magic = bytes(blob[:5])
    if magic in _REFERENCE_MAGICS:
        raise ValueError(
            f"state blob {magic!r} is the JAX reference's format "
            f"({_REFERENCE_MAGICS[magic]}); the PyTorch port cannot read it "
            "without jax or unpickling it: push the state again from the "
            "port")
    if magic != _MAGIC:
        raise ValueError(f"unrecognized state blob (magic {magic!r})")
    n = int.from_bytes(blob[5:13], "little")
    npz = np.load(io.BytesIO(blob[13:13 + n]), allow_pickle=False)
    return _decode(json.loads(blob[13 + n:]), npz)


class PersistenceManager:
    """Restore at boot and a periodic push for one component with
    ``get_state``/``set_state``."""

    def __init__(self, user: Any, store: StateStore, key: str,
                 push_frequency: float = DEFAULT_PUSH_FREQUENCY):
        if not (callable(getattr(user, "get_state", None))
                and callable(getattr(user, "set_state", None))):
            raise TypeError(
                f"{type(user).__name__} has no get_state/set_state: the "
                "port persists component state only (the reference's "
                "fallback pickles the whole object)")
        self.user = user
        self.store = store
        self.key = key
        self.push_frequency = push_frequency
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def restore(self) -> bool:
        """True when a state was found and applied; a blob the port cannot
        read raises ``ValueError``."""
        blob = self.store.load(self.key)
        if blob is None:
            return False
        self.user.set_state(unpack_state(blob))
        return True

    def push(self) -> None:
        self.store.save(self.key, pack_state(self.user.get_state()))

    def start(self) -> "PersistenceManager":
        """A daemon thread pushing every ``push_frequency`` seconds."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.push_frequency):
                try:
                    self.push()
                except Exception:  # a failed push must not stop serving
                    logger.exception("state push failed for %s", self.key)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"persist-{self.key}")
        self._thread.start()
        return self

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_push:
            try:
                self.push()
            except Exception:
                logger.exception("final state push failed for %s", self.key)


def store_from_env() -> StateStore:
    """The store the environment names: ``SELDON_STATE_DIR`` (the file
    store's root) and ``SELDON_STATE_BACKEND`` (``file``; ``orbax`` is
    refused).  Without ``SELDON_STATE_DIR`` the root is the user's own
    ``$XDG_STATE_HOME/seldon-state`` (or ``~/.local/state/seldon-state``),
    never a world-predictable ``/tmp`` path, and its owner is checked."""
    root = os.environ.get("SELDON_STATE_DIR")
    implicit = not root
    if implicit:
        base = os.environ.get("XDG_STATE_HOME") or os.path.join(
            os.path.expanduser("~"), ".local", "state")
        root = os.path.join(base, "seldon-state")
        legacy = "/tmp/seldon-state"
        if os.path.isdir(legacy) and not os.path.isdir(root):
            logger.warning(
                "state found at legacy default %s but the default root is "
                "now %s (the old path was world-predictable); set "
                "SELDON_STATE_DIR=%s explicitly to keep using it",
                legacy, root, legacy)
    backend = os.environ.get("SELDON_STATE_BACKEND", "file")
    if backend == "orbax":
        return OrbaxStateStore(root)
    return FileStateStore(root, require_owner=implicit)
