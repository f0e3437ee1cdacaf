"""Online Mahalanobis outlier detector (port of
``seldon_core_tpu/models/outlier.py``): an OUTLIER_DETECTOR that scores
each row by its squared Mahalanobis distance to the running mean and
covariance (Welford updates, shrinkage toward the diagonal).  Host numpy
code, as in the reference; its scores are the reference's to the bit.  Its
running moments persist through ``get_state``/``set_state``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MahalanobisOutlier"]


class MahalanobisOutlier:
    """Each row is scored against the state BEFORE it updates the state;
    the first ``warmup`` rows score 0.0."""

    def __init__(self, warmup: int = 10, shrinkage: float = 1e-2):
        self.warmup = int(warmup)
        self.shrinkage = float(shrinkage)
        self.n = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None  # sum of centered outer products

    def score(self, X, feature_names):
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        scores = np.zeros(X.shape[0])
        for i, x in enumerate(X):
            scores[i] = self._score_one(x)
            self._update(x)
        return scores

    def _score_one(self, x: np.ndarray) -> float:
        if self.n < max(self.warmup, 2):
            return 0.0
        cov = self.m2 / (self.n - 1)
        diag = np.diag(np.diag(cov)) + np.eye(len(x)) * 1e-9
        cov = (1 - self.shrinkage) * cov + self.shrinkage * diag
        d = x - self.mean
        try:
            return float(d @ np.linalg.solve(cov, d))
        except np.linalg.LinAlgError:
            return 0.0

    def _update(self, x: np.ndarray) -> None:
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros((len(x), len(x)))
        self.n += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.n
        self.m2 = self.m2 + np.outer(delta, x - self.mean)

    # the persistence protocol (runtime/persistence.py): the reference's
    # npz fields, as a dict of arrays
    def get_state(self) -> dict:
        return {"n": np.asarray(self.n, np.int64),
                "mean": self.mean if self.mean is not None else np.zeros(0),
                "m2": self.m2 if self.m2 is not None else np.zeros((0, 0))}

    def set_state(self, state: dict) -> None:
        self.n = int(state["n"])
        mean, m2 = np.asarray(state["mean"]), np.asarray(state["m2"])
        self.mean = mean.copy() if mean.size else None
        self.m2 = m2.copy() if m2.size else None

    def tags(self):
        return {"detector": "mahalanobis", "observed": self.n}
