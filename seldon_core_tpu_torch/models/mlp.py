"""MNIST MLP (port of ``seldon_core_tpu/models/mlp.py``): 784 -> hidden ->
hidden/2 -> 10, ReLU, softmax.

Seeded weights come from a ``torch.Generator`` on the model's device
(``randn / sqrt(fan_in)``, zero biases), so for one seed they differ from
the reference's ``jax.random`` draw; ``params=`` takes given weights (a
list of ``{"w": (m, n), "b": (n,)}``, the reference's layout), and
``model_uri`` a checkpoint of them (``runtime/checkpoint.py``), which
:meth:`MNISTMLP.save_checkpoint` writes as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from seldon_core_tpu_torch.device import resolve_device

__all__ = ["init_mlp_params", "mlp_apply", "mlp_classify", "MNISTMLP",
           "MNISTMLPClassifier"]


def init_mlp_params(gen: torch.Generator, sizes=(784, 512, 256, 10),
                    device=None) -> list:
    return [{"w": torch.randn((m, n), generator=gen, device=device)
             * (m ** -0.5),
             "b": torch.zeros((n,), device=device)}
            for m, n in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return torch.softmax(x @ last["w"] + last["b"], dim=-1)


def mlp_classify(params: list, x: torch.Tensor) -> torch.Tensor:
    """Class ids instead of probabilities."""
    return torch.argmax(mlp_apply(params, x), dim=-1).to(torch.int32)


class MNISTMLP:
    """Graph MODEL component."""

    class_names = [f"class:{i}" for i in range(10)]

    def __init__(self, seed: int = 0, hidden: int = 512, model_uri: str = "",
                 params: Optional[list] = None, device: str = "cuda"):
        self.device = resolve_device(device)
        if model_uri:
            from seldon_core_tpu_torch.runtime.checkpoint import (
                load_checkpoint,
                resolve_model_uri,
            )

            params, meta = load_checkpoint(resolve_model_uri(model_uri))
            if meta.get("family") not in (None, "mlp"):
                raise ValueError(f"model_uri holds {meta.get('family')!r},"
                                 " not mlp weights")
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = init_mlp_params(gen, (784, hidden, hidden // 2, 10),
                                     device=self.device)
        self.params = [{k: torch.as_tensor(v, device=self.device)
                        for k, v in layer.items()} for layer in params]

    def predict_fn(self, params, X):
        # JSON ndarray bodies parse as float64
        return mlp_apply(params, X.to(torch.float32))

    def tags(self):
        return {"model": "mnist-mlp"}

    def save_checkpoint(self, path: str) -> str:
        """Export the layer list as a ``model_uri`` checkpoint
        (``{"family": "mlp"}``), the reference's file for the same
        weights."""
        from seldon_core_tpu_torch.runtime.checkpoint import export_checkpoint

        host = [{k: v.detach().cpu() for k, v in layer.items()}
                for layer in self.params]
        return export_checkpoint(path, host, {"family": "mlp"})


class MNISTMLPClassifier(MNISTMLP):
    """The same MLP serving class ids."""

    def predict_fn(self, params, X):
        return mlp_classify(params, X.to(torch.float32))

    def tags(self):
        return {"model": "mnist-mlp-classifier"}
