"""Parallelism primitives: mesh planning and the mesh's collectives, plus
the three sharded building blocks, the pipeline schedule, the MoE dispatch
and ring attention (port of ``seldon_core_tpu/parallel/``)."""

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
    psum_scatter,
    single_axis_mesh,
    unshard,
)
from seldon_core_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_capacity,
    moe_forward,
    moe_param_specs,
)
from seldon_core_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
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
    "MoEConfig",
    "NamedSharding",
    "Shards",
    "all_gather",
    "all_to_all",
    "dense_attention",
    "init_moe_params",
    "make_mesh",
    "moe_capacity",
    "moe_forward",
    "moe_param_specs",
    "named_sharding",
    "pipeline_apply",
    "place",
    "plan_mesh",
    "ppermute",
    "pspec",
    "psum",
    "psum_scatter",
    "ring_attention",
    "ring_attention_sharded",
    "single_axis_mesh",
    "stack_stage_params",
    "unshard",
]
