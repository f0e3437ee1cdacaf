"""Built-in trace providers for the model zoo (GL16xx trace-lint; port of
``seldon_core_tpu/models/traceable.py``).

Each provider returns a :class:`~seldon_core_tpu_torch.models.TraceTarget`:
the class's serving function unbound from any instance, plus its
parameters built by the same init code the real constructor runs.  The
trace-lint calls providers inside its ``FakeTensorMode``, so those
parameters are fake tensors: no storage is allocated and no op computes
(``analysis/tracelint.py``).

Not every model is statically traceable, as in the reference:

- ``llm_demo.DemoLLM`` wraps the continuous-batching engine — per-request
  host state, paged KV caches; there is no pure ``fn(params, X)``.
- ``outlier.MahalanobisOutlier`` is a learning numpy component with a
  shapeless signature; nothing declared means nothing to verify.
"""

from __future__ import annotations

import torch

from seldon_core_tpu_torch.models import TraceTarget, register_trace_provider

_PKG = "seldon_core_tpu_torch.models"


def _iris_target() -> TraceTarget:
    from seldon_core_tpu_torch.models.iris import IrisClassifier

    # __init__ trains; its parameters are statically (4, 3) + (3,)
    params = {"w": torch.empty((4, 3)), "b": torch.empty((3,))}
    # predict_fn never touches self — trace it unbound
    return TraceTarget(
        fn=lambda p, X: IrisClassifier.predict_fn(None, p, X),
        params=params,
    )


def _mlp_params() -> list:
    from seldon_core_tpu_torch.models.mlp import init_mlp_params

    return init_mlp_params(torch.Generator().manual_seed(0),
                           (784, 512, 256, 10))


def _mlp_target() -> TraceTarget:
    from seldon_core_tpu_torch.models.mlp import MNISTMLP

    return TraceTarget(fn=lambda p, X: MNISTMLP.predict_fn(None, p, X),
                       params=_mlp_params())


def _mlp_classifier_target() -> TraceTarget:
    from seldon_core_tpu_torch.models.mlp import MNISTMLPClassifier

    return TraceTarget(
        fn=lambda p, X: MNISTMLPClassifier.predict_fn(None, p, X),
        params=_mlp_params())


def _resnet_module():
    from seldon_core_tpu_torch.models.resnet import ResNet

    return ResNet(num_classes=1000, dtype=torch.bfloat16).eval()


def _resnet_target() -> TraceTarget:
    from seldon_core_tpu_torch.models.resnet import ResNet50Model

    return TraceTarget(
        fn=lambda module, X: ResNet50Model.predict_fn(None, module, X),
        params=_resnet_module())


def _resnet_int8_target() -> TraceTarget:
    from seldon_core_tpu_torch.models.resnet_int8 import (
        convert_params,
        forward,
    )

    return TraceTarget(fn=forward, params=convert_params(_resnet_module()))


def install() -> None:
    """Register the model-zoo providers (idempotent)."""
    register_trace_provider(f"{_PKG}.iris:IrisClassifier", _iris_target)
    register_trace_provider(f"{_PKG}.mlp:MNISTMLP", _mlp_target)
    register_trace_provider(f"{_PKG}.mlp:MNISTMLPClassifier",
                            _mlp_classifier_target)
    register_trace_provider(f"{_PKG}.resnet:ResNet50Model", _resnet_target)
    register_trace_provider(f"{_PKG}.resnet_int8:Int8ResNet50Model",
                            _resnet_int8_target)
