"""Built-in graph units (port of ``seldon_core_tpu/graph/builtins.py``).

- ``SIMPLE_MODEL``: fixed values [1, 2, 3], class names svc1..svc3;
- ``SIMPLE_ROUTER``: always branch 0;
- ``RANDOM_ABTEST``: branch 0 with probability ``ratioA``;
- ``AVERAGE_COMBINER``: element-wise mean of the children's outputs;
- ``EPSILON_GREEDY``: multi-armed-bandit router that learns from feedback.

The routers draw from ``random.Random(seed)`` exactly as the reference
does, so with a seed the port routes request for request as the reference
does.  The combiner averages torch tensors with a torch mean on their
device (:func:`tensor_mean`): an ensemble of models on the card aggregates
there, with no copy to the host.  A fused segment (``graph/plan.py``) runs
the same :func:`tensor_mean` as its pure aggregate, so the walk and the
segment launch the same kernels.
"""

from __future__ import annotations

import inspect
import random
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["SimpleModel", "SimpleRouter", "RandomABTest", "AverageCombiner",
           "EpsilonGreedy", "make_builtin", "tensor_mean"]


class SimpleModel:
    """Static stub model returning fixed values."""

    class_names = ["svc1", "svc2", "svc3"]
    _values = np.array([[1.0, 2.0, 3.0]])

    def predict(self, X, names):
        X = np.asarray(X)
        n = X.shape[0] if X.ndim > 1 else 1
        return np.broadcast_to(self._values, (n, 3))


class SimpleRouter:
    """Always routes to branch 0."""

    def route(self, X, names) -> int:
        return 0


class RandomABTest:
    """Random A/B split: branch 0 with probability ``ratioA``."""

    def __init__(self, ratioA: float = 0.5, seed: Optional[int] = None):
        self.ratio_a = float(ratioA)
        self._rng = random.Random(seed)

    def route(self, X, names) -> int:
        return 0 if self._rng.random() < self.ratio_a else 1


def tensor_mean(Xs: Sequence[Any]) -> torch.Tensor:
    """Element-wise mean of ``Xs`` on the device of the first tensor among
    them: one stack, then one mean over the new axis."""
    dev = next(x for x in Xs if isinstance(x, torch.Tensor)).device
    return torch.stack([torch.as_tensor(x, device=dev)
                        for x in Xs]).mean(dim=0)


class AverageCombiner:
    """Element-wise mean over the children's outputs; torch tensors are
    averaged on their device."""

    accepts_tensors = True  # the handle passes tensors as they are

    def aggregate(self, Xs: Sequence[Any], names_list):
        if not Xs:
            raise ValueError("AverageCombiner: no inputs")
        if any(isinstance(x, torch.Tensor) for x in Xs):
            return tensor_mean(Xs)
        return np.mean(np.stack([np.asarray(x) for x in Xs]), axis=0)


class EpsilonGreedy:
    """Multi-armed-bandit router: explore with probability ``epsilon``,
    else take the branch of best mean reward; ``send_feedback`` credits the
    branch recorded in the response's ``meta.routing``.  Its counts and
    mean rewards persist through ``get_state``/``set_state``."""

    def __init__(self, n_branches: int = 2, epsilon: float = 0.1,
                 seed: Optional[int] = None):
        self.n_branches = int(n_branches)
        self.epsilon = float(epsilon)
        self.counts = np.zeros(self.n_branches, dtype=np.int64)
        self.values = np.zeros(self.n_branches, dtype=np.float64)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def route(self, X, names) -> int:
        with self._lock:
            if self._rng.random() < self.epsilon:
                return self._rng.randrange(self.n_branches)
            return int(np.argmax(self.values))

    def send_feedback(self, request, names, reward, truth, routing=None):
        # routing comes from client-supplied response meta: bounds-check it
        if routing is None or not (0 <= routing < self.n_branches):
            return None
        with self._lock:
            self.counts[routing] += 1
            n = self.counts[routing]
            self.values[routing] += (reward - self.values[routing]) / n
        return None

    # the persistence protocol (runtime/persistence.py)
    def get_state(self) -> dict:
        with self._lock:
            return {"counts": self.counts.copy(), "values": self.values.copy()}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self.counts = np.asarray(state["counts"], dtype=np.int64).copy()
            self.values = np.asarray(state["values"], dtype=np.float64).copy()


_BUILTINS = {
    "SIMPLE_MODEL": SimpleModel,
    "SIMPLE_ROUTER": SimpleRouter,
    "RANDOM_ABTEST": RandomABTest,
    "AVERAGE_COMBINER": AverageCombiner,
    "EPSILON_GREEDY": EpsilonGreedy,
}


def make_builtin(implementation: str, parameters: dict) -> Any:
    """The built-in object for ``implementation``, built from the node's
    parameters that its constructor takes."""
    impl = _BUILTINS.get(implementation)
    if impl is None:
        raise KeyError(f"unknown builtin implementation {implementation!r}")
    sig = inspect.signature(impl)
    return impl(**{k: v for k, v in (parameters or {}).items()
                   if k in sig.parameters})
