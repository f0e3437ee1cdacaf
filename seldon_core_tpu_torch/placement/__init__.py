"""Placement plane: so far its annotations and their parser, the planner
and the tensor-parallel rule table, which the admission lint reads
(``analysis/graphlint.py`` GL12xx, ``analysis/tracelint.py`` GL1604 and
GL1207), the process-local registry the operator's ``status.placement``
reads (``registry.py``; nothing publishes to it until the placement plane
runs), and the mesh manager (``meshes.py``: one Mesh per ``seldon.io/mesh``
spec per process).  The sharded executor and the admin surface of
``seldon_core_tpu/placement/`` (``plane.py``, ``http.py``,
``layouts.build_shardings``) are not ported yet."""

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
    "SegmentFacts",
    "placement_config_from_annotations",
    "plan_placement",
    "publish",
    "unpublish",
    "snapshot",
    "clear",
]
