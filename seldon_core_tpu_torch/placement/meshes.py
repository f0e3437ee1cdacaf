"""Process-local device-mesh registry (port of
``seldon_core_tpu/placement/meshes.py``).

One :class:`~seldon_core_tpu_torch.parallel.mesh.Mesh` per distinct
``seldon.io/mesh`` spec per process: every deployment asking for ``dp=2,tp=2``
shares the same Mesh object, and the admin surfaces can list the topology the
process is committed to.  Meshes are built on the CUDA devices by default and
refused when the spec wants more than are visible; ``device="cpu"`` builds
them on repeats of the CPU (the counterpart of the reference's virtual CPU
devices), registered under ``<spec>@cpu``.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from seldon_core_tpu_torch.parallel.mesh import (
    MeshPlan,
    MeshPlanError,
    make_mesh,
)
from seldon_core_tpu_torch.placement.config import PlacementConfig

__all__ = ["mesh_for", "device_count", "registry_stats", "lookup", "clear"]

_lock = threading.Lock()
#: canonical spec string (``@cpu`` for CPU meshes) -> live Mesh
_meshes: dict = {}


def device_count() -> int:
    """Visible CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _key(spec: str, device) -> str:
    kind = torch.device(device).type
    return spec if kind == "cuda" else f"{spec}@{kind}"


def mesh_for(config: PlacementConfig, device="cuda"):
    """The process-wide Mesh for this config, built on first use.

    Raises :class:`MeshPlanError` when the axis product exceeds the visible
    CUDA devices: the defect the admission lint rejects (GL1202), checked
    again because the runtime may see another device inventory."""
    key = _key(config.spec(), device)
    with _lock:
        mesh = _meshes.get(key)
        if mesh is not None:
            return mesh
        want = config.n_devices
        if torch.device(device).type == "cuda" and want > device_count():
            raise MeshPlanError(
                f"mesh {config.spec()!r} wants {want} device(s) but only "
                f"{device_count()} visible")
        plan = MeshPlan(dp=config.dp, pp=config.pp, tp=config.tp)
        mesh = make_mesh(plan, device=device)
        _meshes[key] = mesh
        return mesh


def registry_stats() -> dict:
    """Admin-surface view: which meshes this process holds."""
    with _lock:
        return {key: {"axes": dict(mesh.shape),
                      "devices": [str(d) for d in mesh.devices.flat]}
                for key, mesh in _meshes.items()}


def clear() -> None:
    """Test helper: forget every mesh."""
    with _lock:
        _meshes.clear()


def lookup(spec: str, device="cuda") -> Optional[object]:
    """The registered Mesh for a canonical spec string, or None."""
    with _lock:
        return _meshes.get(_key(spec, device))
