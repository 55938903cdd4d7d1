"""The tree learners behind the Learner contract (``repro.core.learners``).

RFLearner / GBDTLearner : the histogram tree learners (trees.py), with
the same ``fit``/``predict`` and ``fit_stacked``/``predict_stacked``
hooks the engines call.  A learner carries its ``device`` ("cuda"
unless the caller asks for the CPU); states are nested tuples of
tensors on that device, and states handed back as numpy arrays (a
decoded wire update) are moved there first.

Keys are threefry keys from ``repro_torch.prng`` (numpy (2,) uint32),
consumed split for split as the reference consumes ``jax.random``
keys, so a fit at a given key draws the reference's bootstrap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import trees as T
from repro_torch.tree_util import tree_map


def _pow2_bucket(n, min_size=32):
    return max(min_size, 1 << (n - 1).bit_length())


def _mask_cols(X, mask):
    """Selects a party's feature columns (vertical federation); ``mask``
    is a tuple of column indices, None = all columns."""
    if mask is None:
        return np.asarray(X)
    return np.asarray(X)[:, list(mask)]


def _pad_pow2(X, y, min_size=32, bucket=None):
    """Rows padded to a pow2 bucket: (X, y, row mask) as numpy."""
    n = len(X)
    m = bucket or _pow2_bucket(n, min_size)
    mask = np.zeros((m,), np.float32)
    mask[:n] = 1.0
    Xp = np.zeros((m,) + X.shape[1:], X.dtype)
    Xp[:n] = X
    yp = np.zeros((m,), np.int32)
    yp[:n] = y
    return Xp, yp, mask


def _on(device, tree):
    """Every leaf of a state as a tensor on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def _first(tree):
    return tree_map(lambda a: a[0], tree)


def _batch(tree):
    return tree_map(lambda a: a[None], tree)


@dataclass(frozen=True)
class RFLearner:
    num_classes: int
    num_trees: int = 20
    depth: int = 6
    feature_mask: Any = None      # vertical: this silo's columns
    device: str = D.DEFAULT

    def _rf(self):
        return T.RandomForest(self.num_trees, self.depth, self.num_classes)

    def fit(self, key, X, y):
        """One forest: the stacked fit of one, on its own unpadded rows.
        Returns (forest, edges)."""
        forest, edges = self.fit_stacked(np.asarray(key)[None], [X], [y],
                                         pad=False)
        return _first(forest), edges[0]

    def fit_stacked(self, keys, Xs, ys, *, pad=True):
        """k forests as one stacked fit (federation vmap engine).

        Each dataset keeps its own quantile edges and a bootstrap draw
        at its TRUE size (key-for-key identical to serial ``fit``); rows
        padding up to the shared pow2 bucket carry ZERO sample weight,
        so every stacked tree equals its serial fit."""
        dev = D.resolve(self.device)
        rf = self._rf()
        Xs = [_mask_cols(X, self.feature_mask).astype(np.float32)
              for X in Xs]
        bucket = (max(_pow2_bucket(len(X)) for X in Xs) if pad
                  else len(Xs[0]))
        edges, Xp, yp, wp, fm = [], [], [], [], []
        for kk, X, y in zip(keys, Xs, ys):
            edges.append(T.make_bins(X))
            w_i, fm_i = rf.bootstrap(kk, len(X), X.shape[1])
            w_pad = np.zeros((self.num_trees, bucket), np.float32)
            w_pad[:, :len(X)] = w_i
            Xi, yi, _ = _pad_pow2(X, np.asarray(y), bucket=bucket)
            Xp.append(Xi), yp.append(yi), wp.append(w_pad), fm.append(fm_i)
        edges, Xp, yp, wp, fm = _on(dev, tuple(
            np.stack(a) for a in (edges, Xp, yp, wp, fm)))
        forest = T.fit_forest_stacked(Xp, edges, yp, wp, fm,
                                      depth=self.depth,
                                      num_classes=self.num_classes)
        return (forest, edges)

    def predict(self, state, X):
        return self.predict_stacked(_batch(state), X)[0]

    def predict_stacked(self, states, X):
        """(k, T) predictions of k stacked forests on one shared X."""
        dev = D.resolve(self.device)
        forest, edges = _on(dev, states)
        X = torch.as_tensor(_mask_cols(X, self.feature_mask)
                            .astype(np.float32)).to(dev)
        return T.predict_forest_stacked(forest, X, edges)


@dataclass(frozen=True)
class GBDTLearner:
    num_classes: int = 2
    num_rounds: int = 30
    depth: int = 6
    feature_mask: Any = None      # vertical: this silo's columns
    device: str = D.DEFAULT

    def _gb(self):
        return T.GBDT(self.num_rounds, self.depth)

    def fit(self, key, X, y):
        """One GBDT: the stacked fit of one, on its own unpadded rows.
        Returns (trees, edges); the key is unused, as in the reference."""
        trees, edges = self.fit_stacked(np.asarray(key)[None], [X], [y],
                                        pad=False)
        return _first(trees), edges[0]

    def fit_stacked(self, keys, Xs, ys, *, pad=True):
        """k GBDTs as one stacked fit.  Shared pow2 bucket; padding rows
        carry zero g/h weight (see trees.fit_gbdt_stacked)."""
        dev = D.resolve(self.device)
        gb = self._gb()
        Xs = [_mask_cols(X, self.feature_mask).astype(np.float32)
              for X in Xs]
        bucket = (max(_pow2_bucket(len(X)) for X in Xs) if pad
                  else len(Xs[0]))
        edges, Xp, yp, wp = [], [], [], []
        for X, y in zip(Xs, ys):
            edges.append(T.make_bins(X))
            Xi, yi, mi = _pad_pow2(X, np.asarray(y), bucket=bucket)
            Xp.append(Xi), yp.append(yi), wp.append(mi)
        edges, Xp, yp, wp = _on(dev, tuple(
            np.stack(a) for a in (edges, Xp, yp, wp)))
        trees = T.fit_gbdt_stacked(Xp, edges, yp, wp, gb.learning_rate,
                                   num_rounds=self.num_rounds,
                                   depth=self.depth)
        return (trees, edges)

    def predict(self, state, X):
        return self.predict_stacked(_batch(state), X)[0]

    def predict_stacked(self, states, X):
        """(k, T) predictions of k stacked GBDTs on one shared X."""
        dev = D.resolve(self.device)
        trees, edges = _on(dev, states)
        X = torch.as_tensor(_mask_cols(X, self.feature_mask)
                            .astype(np.float32)).to(dev)
        return T.predict_gbdt_stacked(trees, X, edges,
                                      self._gb().learning_rate)


def accuracy(learner, state, X, y) -> float:
    preds = learner.predict(state, X).cpu().numpy()
    return float((preds == np.asarray(y)).mean())
