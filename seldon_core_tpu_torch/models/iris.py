"""Iris classifier (port of ``seldon_core_tpu/models/iris.py``): multinomial
logistic regression trained at construction on a deterministic stand-in for
the iris data set.

The port trains the reference's loss (mean cross-entropy of softmax
logits), learning rate, epochs and data (its own copy of ``_iris_data``)
with torch autograd on the model's device.  Its initial weights come from a
``torch.Generator`` seeded with ``seed``, so for one seed they differ from
the reference's ``jax.random`` draw; ``params=`` takes given weights
instead (the tests give it the reference's trained ones).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from seldon_core_tpu_torch.device import resolve_device

__all__ = ["IrisClassifier", "train_logreg"]


def _iris_data():
    """Three Gaussian-ish clusters with the classic feature scales."""
    rng = np.random.default_rng(0)
    means = np.array(
        [[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.1]]
    )
    X = np.concatenate(
        [rng.normal(m, [0.35, 0.35, 0.3, 0.15], (50, 4)) for m in means]
    ).astype(np.float32)
    y = np.repeat(np.arange(3), 50)
    return X, y


def train_logreg(w: torch.Tensor, b: torch.Tensor, X: torch.Tensor,
                 y: torch.Tensor, epochs: int, lr: float) -> dict:
    """Full-batch gradient descent on the mean softmax cross-entropy from
    ``w`` (4, 3), ``b`` (3,); returns ``{"w", "b"}``."""
    onehot = torch.nn.functional.one_hot(y, w.shape[1]).to(w.dtype)
    w = w.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    for _ in range(epochs):
        logits = X @ w + b
        loss = -(onehot * torch.log_softmax(logits, -1)).sum(-1).mean()
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    return {"w": w.detach(), "b": b.detach()}


class IrisClassifier:
    class_names = ["setosa", "versicolor", "virginica"]

    def __init__(self, epochs: int = 200, lr: float = 0.1, seed: int = 0,
                 params: Optional[dict] = None, device: str = "cuda"):
        self.device = resolve_device(device)
        if params is None:
            X, y = _iris_data()
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            w = torch.randn((4, 3), generator=gen, device=self.device) * 0.01
            b = torch.zeros((3,), device=self.device)
            params = train_logreg(
                w, b, torch.from_numpy(X).to(self.device),
                torch.from_numpy(y).to(self.device), epochs, lr)
        self.params = {k: torch.as_tensor(v, device=self.device)
                       for k, v in params.items()}

    def predict_fn(self, params, X):
        return torch.softmax(X.float() @ params["w"] + params["b"], dim=-1)

    def tags(self):
        return {"model": "iris-logreg"}
