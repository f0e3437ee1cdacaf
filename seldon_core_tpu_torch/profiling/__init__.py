"""Continuous profiling plane (port of ``seldon_core_tpu/profiling/``):
the third observability pillar next to sampled tracing and the always-on
health plane — *where the cycles go*.  Three pillars, one subsystem:

1. **Host sampling profiler**
   (:mod:`~seldon_core_tpu_torch.profiling.hostsampler`): a daemon thread
   samples every thread's stack at ``seldon.io/profile-hz`` into a
   bounded folded-stack table keyed by thread + running asyncio task;
   collapsed-flamegraph export at ``/admin/profile``, on-demand
   baseline-diff capture windows (optionally wrapping a ``torch.profiler``
   device trace, ``?device=<dir>``) at ``/admin/profile/capture``.
2. **Capture observability**
   (:mod:`~seldon_core_tpu_torch.profiling.compilewatch`): every
   fused-segment shape bucket captured as a CUDA graph reports its
   capture wall time, its FLOPs and bytes counted from the stages'
   shapes, and its graph pool's bytes; ``seldon_compile_*`` metrics,
   ``/admin/profile/compile``, and a storm signal fused into the
   ``/admin/health`` verdict.
3. **Per-request cost attribution**
   (:mod:`~seldon_core_tpu_torch.profiling.attribution`): estimated
   FLOPs/HBM-bytes per request from segment cost × dynamic-batch share,
   stamped into the flight recorder and exported as counters, plus the
   ``/admin/profile/capacity`` headroom estimate (achievable rps vs. the
   card's peak).

Enabled by ``seldon.io/profile: "true"`` (env ``SELDON_PROFILE=1``);
validated when the deployment loads (``graph/spec.py profile_config``,
the reference's messages).
"""

from seldon_core_tpu_torch.profiling.attribution import (
    CostAttribution,
    attribution_scope,
    device_kind,
    device_peak_tflops,
    note_segment_cost,
)
from seldon_core_tpu_torch.profiling.compilewatch import (
    STORM_WINDOW_S,
    CompileWatch,
)
from seldon_core_tpu_torch.profiling.config import (
    PROFILE_ANNOTATION,
    PROFILE_HZ_ANNOTATION,
    PROFILE_STACKS_ANNOTATION,
    PROFILE_STORM_ANNOTATION,
    PROFILE_WINDOW_S_ANNOTATION,
    ProfileConfig,
    profile_config_from_annotations,
)
from seldon_core_tpu_torch.profiling.hostsampler import HostSampler
from seldon_core_tpu_torch.profiling.plane import ProfilePlane

__all__ = [
    "PROFILE_ANNOTATION",
    "PROFILE_HZ_ANNOTATION",
    "PROFILE_STACKS_ANNOTATION",
    "PROFILE_STORM_ANNOTATION",
    "PROFILE_WINDOW_S_ANNOTATION",
    "ProfileConfig",
    "profile_config_from_annotations",
    "HostSampler",
    "CompileWatch",
    "STORM_WINDOW_S",
    "CostAttribution",
    "attribution_scope",
    "note_segment_cost",
    "device_peak_tflops",
    "device_kind",
    "ProfilePlane",
]
