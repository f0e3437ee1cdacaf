"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
source compiles to an object in its own ``nvcc`` process, all started
together, then one link makes ``build/torch_kernels/libsck_<hash>.so`` at
the repository root.  The hash covers every source, so an edited kernel
rebuilds and an unchanged one loads the library already built.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and no
``--use_fast_math``: it would turn ``x / xs`` and ``expf`` into
approximations, and the int8 kernel must quantize exactly as the plain
version does.

With an artifact plane attached (:func:`attach_artifacts`, done by the
local runner when ``seldon.io/artifact-store`` is set), :func:`load`
looks in the plane's store first: an entry whose sha256 matches its
sidecar is written beside the build's own library and loaded without
``nvcc`` (``build_stats``: ``compiled`` False, ``store`` the entry); a
mismatch is quarantined and never passed to ``dlopen``; a miss builds as
usual and publishes the library.  Without a plane nothing changes.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns a ``cudaError_t`` (0 = launched); :func:`check` raises on anything
else.  The build happens at first use, never when a module is imported:
the CPU tests import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["build", "load", "check", "ptr", "stream_of", "dtype_code",
           "check_head_dim", "sm_count", "HEAD_DIMS", "BUILD_DIR",
           "SOURCE_DIR", "build_stats", "attach_artifacts", "source_hash"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu (extern "C"); every function returns cudaError_t
_SIGNATURES = {
    # x, w (the (N, K) buffer), ws, xq scratch, xs scratch, out, M, K, N,
    # x dtype, out dtype, variant, tile rows, K splits, split-K scratch,
    # stream
    "sck_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P],
    # q, k_pages, v_pages, lengths, tables, out, partials scratch, arrival
    # counters, S, H, Hkv, n_pages, page_size, D, pages_per_slot, n_split,
    # pages per split, scale, dtype, stream
    "sck_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, out, B, L, H, Hkv, D, causal, scale, dtype, variant, stream
    "sck_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                            _I, _P],
}

#: head dims the attention kernels (K2, K3) are instantiated for
HEAD_DIMS = (8, 16, 32, 64, 128, 256)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the artifact plane load() consults first (attach_artifacts)
_artifacts = None
#: what the last build did: seconds, whether it compiled, the library path
build_stats: dict = {}


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in ("/usr/local/cuda/bin/nvcc",):
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and link
    them into the hashed library; return its path.  The compiler's report
    (``-Xptxas -v``: registers and spills per kernel) is kept in
    ``build_stats["log"]``.  Processes that build at once (worker
    processes starting together on a fresh checkout, test workers)
    serialize on a lock file: one compiles, the others load its library."""
    t0 = time.perf_counter()
    so = BUILD_DIR / f"libsck_{source_hash()}.so"
    if so.exists():
        build_stats.update(seconds=time.perf_counter() - t0, compiled=False,
                           library=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            log = None if so.exists() else _compile(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_stats.update(seconds=time.perf_counter() - t0,
                       compiled=log is not None, library=str(so))
    if log is not None:
        build_stats["log"] = log
    return so


def _compile(so: Path) -> str:
    """Build the library at ``so``; returns the compiler's output."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    procs = []
    for src in sorted(SOURCE_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(SOURCE_DIR),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"libsck_{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for o in objs:
        Path(o).unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return "\n".join(logs)


def attach_artifacts(plane) -> None:
    """Make :func:`load` look in ``plane``'s store first (None detaches).
    The library is process-wide, so is this."""
    global _artifacts
    _artifacts = plane


def _from_store(plane) -> Optional[Path]:
    """The stored library, checked and written beside the build's own, or
    None (a miss, or a quarantined entry)."""
    h = source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            t0 = time.perf_counter()
            so = plane.load_library(h, BUILD_DIR / f"libsck_{h}.store.so")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if so is not None:
        build_stats.clear()
        build_stats.update(seconds=time.perf_counter() - t0, compiled=False,
                           library=str(so),
                           store=plane.library.get("store"))
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built (or taken from the attached artifact
    store) at first use."""
    global _lib
    with _lock:
        if _lib is None:
            plane = _artifacts
            so = _from_store(plane) if plane is not None else None
            if so is None:
                so = build()
                if plane is not None:
                    plane.publish_library(source_hash(), so)
            lib = ctypes.CDLL(str(so))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.sck_error_string.argtypes = [ctypes.c_int]
            lib.sck_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = load().sck_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_SM_COUNTS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (the kernels' plans depend on it), read once."""
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype, what: str) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, not "
                        f"{dtype}") from None


def check_head_dim(D: int, what: str) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
