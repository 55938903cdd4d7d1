"""Synthetic data standing in for the paper's datasets.

The counterpart of ``repro.data.synthetic``: the same numpy generators,
so the same seed gives the same arrays in both packages.

  tabular_binary : Gaussian-mixture tabular binary task ("adult"/"cod-rna")
  digits         : 10-class procedural image task ("mnist"/"svhn")
  tokens         : token streams of a sparse bigram process (the LM path)

Splits follow the paper (75 / 12.5 / 12.5 for tabular; public = half of
the test pool for images).
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


def digits(n=12_000, image_size=16, num_classes=10, seed=0,
           noise=0.35) -> Dict[str, np.ndarray]:
    """Procedural 10-class image task: each class is a fixed stroke
    template; samples are jittered, scaled, noised copies (MNIST-like
    difficulty at 16x16).  Images are NHWC float32, one channel."""
    rng = np.random.default_rng(seed)
    # class templates: random smooth masks
    t = rng.normal(0, 1, (num_classes, image_size, image_size))
    for _ in range(3):  # smooth
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
             + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0
    t = (t > 0.1).astype(np.float32)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    shifts = rng.integers(-2, 3, (n, 2))
    X = np.empty((n, image_size, image_size, 1), np.float32)
    for i in range(n):
        img = np.roll(np.roll(t[y[i]], shifts[i, 0], 0), shifts[i, 1], 1)
        X[i, :, :, 0] = img * rng.uniform(0.7, 1.3) \
            + rng.normal(0, noise, (image_size, image_size))
    # images: public = half of the test pool, like the paper's MNIST split
    n_tr = int(n * 0.75)
    n_half = (n - n_tr) // 2
    return {"X_train": X[:n_tr], "y_train": y[:n_tr],
            "X_public": X[n_tr:n_tr + n_half],
            "y_public": y[n_tr:n_tr + n_half],
            "X_test": X[n_tr + n_half:], "y_test": y[n_tr + n_half:]}


def tokens(n_seqs=512, seq_len=128, vocab=512, seed=0,
           order=2) -> Dict[str, np.ndarray]:
    """Token streams from a random sparse bigram process (a learnable
    non-trivial LM task for the distillation path)."""
    rng = np.random.default_rng(seed)
    # sparse transition table: each context -> 8 likely next tokens
    nexts = rng.integers(0, vocab, (vocab, 8))
    seqs = np.empty((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, n_seqs)
    for tpos in range(seq_len):
        choose = rng.integers(0, 8, n_seqs)
        rand = rng.integers(0, vocab, n_seqs)
        use_rand = rng.random(n_seqs) < 0.1
        state = np.where(use_rand, rand, nexts[state, choose])
        seqs[:, tpos] = state
    n_tr = int(n_seqs * 0.75)
    n_half = (n_seqs - n_tr) // 2
    return {"train": seqs[:n_tr], "public": seqs[n_tr:n_tr + n_half],
            "test": seqs[n_tr + n_half:], "vocab": vocab}


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
