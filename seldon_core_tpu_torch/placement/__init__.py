"""Placement plane: device meshes, segment placement by device bytes, and
sharded fused-segment execution (port of ``seldon_core_tpu/placement/``).

Annotation-driven (``seldon.io/mesh``, ``seldon.io/placement``): the mesh
manager (``meshes.py``) builds one Mesh per spec per process, the planner
(``planner.py``) bin-packs fused segments onto mesh devices, the layouts
(``layouts.py``) say which weights split over ``tp`` and place them as
per-rank pieces (``tp.py``), and :class:`PlacementPlane` (``plane.py``)
wires them into the engine so segments with shardable batch dims serve
dp-sharded calls.  Admission validation lives in graphlint (GL12xx); the
admin surface is ``/admin/placement`` (``http.py``); the control-plane
surface is ``status.placement`` through ``registry.py``.

The annotations, the planner and the registry import without torch (the
admission lint reads them in a process that may not load it); the names
of ``meshes.py``, ``plane.py`` and ``http.py`` load on first use.
"""

import importlib

from seldon_core_tpu_torch.placement.config import (
    MESH_ANNOTATION,
    PLACEMENT_ANNOTATION,
    PlacementConfig,
    placement_config_from_annotations,
)
from seldon_core_tpu_torch.placement.planner import (
    Assignment,
    PlacementPlan,
    SegmentFacts,
    plan_placement,
)
from seldon_core_tpu_torch.placement.registry import (
    clear,
    publish,
    snapshot,
    unpublish,
)

__all__ = [
    "MESH_ANNOTATION",
    "PLACEMENT_ANNOTATION",
    "Assignment",
    "PlacementConfig",
    "PlacementPlan",
    "PlacementPlane",
    "SegmentFacts",
    "device_count",
    "mesh_for",
    "placement_body",
    "placement_config_from_annotations",
    "plan_placement",
    "publish",
    "registry_stats",
    "segment_facts",
    "snapshot",
    "unpublish",
    "clear",
]

#: the names that import torch, by the module that holds them
_LAZY = {
    "placement_body": "http",
    "device_count": "meshes",
    "mesh_for": "meshes",
    "registry_stats": "meshes",
    "PlacementPlane": "plane",
    "segment_facts": "plane",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
