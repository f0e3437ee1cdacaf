"""Parallelism primitives: mesh planning, the mesh's collectives and ring
attention (port of ``seldon_core_tpu/parallel/``).  The MoE dispatch and
the pipeline schedule come with the training slice."""

from seldon_core_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    Mesh,
    MeshPlan,
    MeshPlanError,
    NamedSharding,
    Shards,
    all_gather,
    all_to_all,
    make_mesh,
    named_sharding,
    place,
    plan_mesh,
    ppermute,
    pspec,
    psum,
    single_axis_mesh,
    unshard,
)
from seldon_core_tpu_torch.parallel.ring_attention import (
    dense_attention,
    ring_attention,
    ring_attention_sharded,
)

__all__ = [
    "AXIS_ORDER",
    "Mesh",
    "MeshPlan",
    "MeshPlanError",
    "NamedSharding",
    "Shards",
    "all_gather",
    "all_to_all",
    "dense_attention",
    "make_mesh",
    "named_sharding",
    "place",
    "plan_mesh",
    "ppermute",
    "pspec",
    "psum",
    "ring_attention",
    "ring_attention_sharded",
    "single_axis_mesh",
    "unshard",
]
