"""Synthetic tabular data standing in for the paper's Adult / cod-rna.

The counterpart of ``repro.data.synthetic``'s ``tabular_binary``: the
same numpy generator, so the same seed gives the same arrays in both
packages.  Splits follow the paper (75 / 12.5 / 12.5 for tabular).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def tabular_binary(n=20_000, num_features=14, seed=0,
                   class_sep=1.2) -> Dict[str, np.ndarray]:
    """Binary tabular task: mixture of 4 Gaussian clusters per class with
    a nonlinear (xor-ish) decision component — linearly inseparable, like
    Adult."""
    rng = np.random.default_rng(seed)
    n_clusters = 4
    means = rng.normal(0, 2.0, (2, n_clusters, num_features))
    y = rng.integers(0, 2, n)
    cl = rng.integers(0, n_clusters, n)
    X = means[y, cl] * class_sep + rng.normal(0, 1.0, (n, num_features))
    # nonlinear flip region to keep trees honest
    flip = (np.sin(X[:, 0]) * X[:, 1] > 1.5)
    y = np.where(flip, 1 - y, y).astype(np.int32)
    X = X.astype(np.float32)
    return _split_751212(X, y, rng)


def _split_751212(X, y, rng):
    n = len(X)
    idx = rng.permutation(n)
    X, y = X[idx], y[idx]
    n_tr = int(n * 0.75)
    n_pub = int(n * 0.125)
    return {"X_train": X[:n_tr], "y_train": y[:n_tr],
            "X_public": X[n_tr:n_tr + n_pub],
            "y_public": y[n_tr:n_tr + n_pub],
            "X_test": X[n_tr + n_pub:], "y_test": y[n_tr + n_pub:]}
