"""The learners behind the Learner contract (``repro.core.learners``).

NNLearner : an Adam training loop over a smallnet (MLP / CNN / VGG).
            Data is padded to power-of-two buckets, as in the reference,
            so a stacked fit of k models shares one bucket.
RFLearner / GBDTLearner : the histogram tree learners (trees.py).
LMLearner : a decoder LM (``models.Model``) trained by the distill.py
            steps; predictions are one vocab id per token.

Each has the same ``fit``/``predict`` and ``fit_stacked``/
``predict_stacked`` hooks the engines call.  A learner carries its
``device`` ("cuda" unless the caller asks for the CPU); states are
nested tuples or dicts of tensors on that device, and states handed back
as numpy arrays (a decoded wire update) are moved there first.

Keys are threefry keys from ``repro_torch.prng`` (numpy (2,) uint32),
consumed split for split as the reference consumes ``jax.random``
keys, so a fit at a given key draws the reference's bootstrap, and an
nn fit the reference's batches, row for row.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as D
from repro_torch import prng
from repro_torch.core import trees as T
from repro_torch.optim import adamw
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


def _first(tree):
    return tree_map(lambda a: a[0], tree)


def _batch(tree):
    return tree_map(lambda a: a[None], tree)


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def _ce(net, p, xb, yb):
    """Mean cross-entropy: the mean of -log_softmax(logits)[y]."""
    return F.cross_entropy(net.apply(p, xb), yb)


def _draw_batches(step_keys, mask, batch_size):
    """(steps, batch_size) row indices, one ``choice`` a step key over
    the rows ``mask`` marks, as the reference's fit draws them."""
    p = mask / mask.sum()
    return prng.choice(step_keys, len(mask), (batch_size,), p)


@dataclass(frozen=True)
class NNLearner:
    net: Any                      # smallnets module object (init/apply)
    num_classes: int
    steps: int = 300
    batch_size: int = 64
    lr: float = 1e-3
    l2: float = 1e-6
    # vertical federation: this party trains and predicts on only these
    # feature columns of any X it is handed; the net must be sized to
    # len(feature_mask)
    feature_mask: Any = None      # Optional[Tuple[int, ...]]
    device: str = D.DEFAULT

    def fit(self, key, X, y):
        """One model: the stacked fit of one, in its own pow2 bucket."""
        return _first(self.fit_stacked(np.asarray(key)[None], [X], [y]))

    def fit_stacked(self, keys, Xs, ys):
        """Trains len(Xs) models as ONE batched fit (the vmap engine),
        the counterpart of the reference's ``jax.vmap`` of the fit:
        ``torch.func.vmap`` of the gradient over a leading model axis on
        every parameter, then one Adam update of the stacked trees (it
        is elementwise).  vmap keeps the net's single-model ``apply``
        the only definition of the model; it batches the products into
        ``bmm`` and the convolutions into grouped ones.  All datasets
        share the largest member's pow2 bucket; per-row masks keep each
        model's batches on its own rows, so a model trained here draws
        its serial ``fit``'s batches whenever the buckets match.

        Every step's indices are drawn on the host before the loop and
        copied to the device once; the loop itself never waits for the
        device."""
        dev = D.resolve(self.device)
        keys = np.asarray(keys, np.uint32)
        bucket = max(_pow2_bucket(len(X)) for X in Xs)
        padded = [_pad_pow2(_mask_cols(X, self.feature_mask)
                            .astype(np.float32), np.asarray(y),
                            bucket=bucket) for X, y in zip(Xs, ys)]
        X, Y, masks = (np.stack([p[i] for p in padded]) for i in range(3))
        idx = np.stack([_draw_batches(
            prng.split(prng.fold_in(k, 2), self.steps), m,
            self.batch_size) for k, m in zip(keys, masks)], axis=1)
        params = D.put(_stack([self.net.init(prng.fold_in(k, 1), "cpu")
                               for k in keys]), dev)
        X = torch.from_numpy(X).to(dev)
        Y = torch.from_numpy(Y).long().to(dev)
        idx = torch.from_numpy(idx).to(dev)             # (steps, k, B)
        rows = torch.arange(len(keys), device=dev)[:, None]
        grad = torch.func.vmap(torch.func.grad(
            lambda p, xb, yb: _ce(self.net, p, xb, yb)))
        opt = adamw(weight_decay=self.l2)
        with D.full_float32(dev):
            state = opt.init(params)
            for s in range(self.steps):
                g = grad(params, X[rows, idx[s]], Y[rows, idx[s]])
                params, state = opt.update(g, state, params, self.lr)
        return params

    def predict(self, state, X):
        return self.predict_stacked(_batch(state), X)[0]

    def predict_stacked(self, states, X):
        """(k, T) int32 predictions of k stacked models on one shared X;
        ties go to the first class, as ``jnp.argmax``'s."""
        dev = D.resolve(self.device)
        params = D.put(states, dev)
        X = torch.as_tensor(_mask_cols(X, self.feature_mask)
                            .astype(np.float32)).to(dev)
        with D.full_float32(dev), torch.no_grad():
            logits = torch.func.vmap(self.net.apply,
                                     in_dims=(0, None))(params, X)
        return torch.argmax(logits, -1).to(torch.int32)


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
        edges, Xp, yp, wp, fm = D.put(tuple(
            np.stack(a) for a in (edges, Xp, yp, wp, fm)), dev)
        forest = T.fit_forest_stacked(Xp, edges, yp, wp, fm,
                                      depth=self.depth,
                                      num_classes=self.num_classes)
        return (forest, edges)

    def predict(self, state, X):
        return self.predict_stacked(_batch(state), X)[0]

    def predict_stacked(self, states, X):
        """(k, T) predictions of k stacked forests on one shared X."""
        dev = D.resolve(self.device)
        forest, edges = D.put(states, dev)
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
        edges, Xp, yp, wp = D.put(tuple(
            np.stack(a) for a in (edges, Xp, yp, wp)), dev)
        trees = T.fit_gbdt_stacked(Xp, edges, yp, wp, gb.learning_rate,
                                   num_rounds=self.num_rounds,
                                   depth=self.depth)
        return (trees, edges)

    def predict(self, state, X):
        return self.predict_stacked(_batch(state), X)[0]

    def predict_stacked(self, states, X):
        """(k, T) predictions of k stacked GBDTs on one shared X."""
        dev = D.resolve(self.device)
        trees, edges = D.put(states, dev)
        X = torch.as_tensor(_mask_cols(X, self.feature_mask)
                            .astype(np.float32)).to(dev)
        return T.predict_gbdt_stacked(trees, X, edges,
                                      self._gb().learning_rate)


@dataclass(frozen=True, eq=False)
class LMLearner:
    """Language model as a FedKT learner (the paper's "any
    classification model" claim at LM scale).

    X is an (N, S+1) int32 token matrix; ``fit`` dispatches on the label
    shape: per-sequence labels (size N — the partitioner's proxy
    classes) mean plain next-token training, per-token labels (size N*S
    — a vote answer) mean distillation on the given labels.
    ``predict`` returns one vocab id per token, flattened to (N*S,),
    which is exactly the (t, T) layout ``teacher_vote`` and
    ``consistent_vote`` consume.  A state is a float32 parameter tree
    (``models.transformer``) on ``device``; a serving module predicts
    too.

    PRNG contract: LM training randomness is owned by ``tcfg.seed``
    (init, split for split as the reference's ``Model.init``) and
    ``data_seed`` (the TokenDataset shuffle stream), matching
    launch/train.py's ``train_lm``; the federation key a fit receives
    only feeds DP vote noise elsewhere in the protocol, so it is unused
    here.  Construct with ``data_seed=cfg.seed`` for the student and
    final roles and the default 0 for teachers.

    On the card the attention layers train through the flash kernel and
    its hand-written backward; a recurrent arch raises in ``fit`` (its
    kernels have no backward yet) and trains on the CPU.
    """
    model: Any                    # models.Model
    tcfg: Any                     # configs.TrainConfig
    data_seed: int = 0            # TokenDataset shuffle seed
    device: str = D.DEFAULT

    # the step caches live in __dict__ (cached_property); drop them on
    # pickle so process transports ship only the config fields
    def __getstate__(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __setstate__(self, state):
        for k, v in state.items():
            object.__setattr__(self, k, v)

    @functools.cached_property
    def _train_machinery(self):
        from repro_torch.core.distill import make_train_step
        return make_train_step(self.model, self.tcfg)

    @functools.cached_property
    def _label_steps(self):
        return {}                 # (num_members, gamma) -> step

    def _tokens(self, X):
        X = np.asarray(X)
        assert X.ndim == 2 and X.shape[1] >= 3, \
            "LMLearner expects (N, S+1) token sequences with S >= 2"
        return X.astype(np.int32)

    def _params(self, state, dev):
        return state if isinstance(state, torch.nn.Module) \
            else D.put(state, dev)

    def fit(self, key, X, y=None):
        from repro_torch.data.pipeline import TokenDataset
        dev = D.resolve(self.device)
        X = self._tokens(X)
        N, S = X.shape[0], X.shape[1] - 1
        if N < self.tcfg.batch_size:
            raise ValueError(f"LMLearner.fit needs >= batch_size="
                             f"{self.tcfg.batch_size} sequences, got {N}")
        labels = None
        if y is not None:
            y = np.asarray(y)
            if y.size == N * S:               # voted token labels
                labels = y.reshape(N, S).astype(np.int32)
            elif y.size != N:                 # size N: proxy classes
                raise ValueError(f"labels of size {y.size} match neither "
                                 f"{N} sequences nor {N * S} tokens")
        step, opt = self._train_machinery
        params = self.model.init_tree(prng.PRNGKey(self.tcfg.seed), dev)
        ds = TokenDataset(X, self.data_seed)
        with D.full_float32(dev):
            opt_state = opt.init(params)
            for batch in ds.batches(self.tcfg.batch_size,
                                    steps=self.tcfg.steps, labels=labels):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                params, opt_state, _ = step(params, opt_state, batch)
        return params

    def predict(self, state, X):
        """(N*S,) int32 greedy next-token predictions."""
        dev = D.resolve(self.device)
        toks = torch.from_numpy(self._tokens(X)[:, :-1]).to(dev)
        with D.full_float32(dev):
            return self.model.predict(self._params(state, dev),
                                      {"tokens": toks}).reshape(-1)

    def predict_stacked(self, bank, X):
        """(M, N*S) predictions of a bank of M members (a sequence of
        states), one member after another."""
        return torch.stack([self.predict(st, X) for st in bank])

    def vote_domain(self, Xq, default_num_classes: int, *,
                    fingerprint=None):
        """The LM path's vote layout, declared by the learner: one vote
        row per query TOKEN (T = N*S over an (N, S+1) query matrix)
        ranging over the model's own vocab, whatever the session's
        default class count."""
        from repro_torch.federation.domain import (fingerprint_queries,
                                                   token_domain)
        X = self._tokens(Xq)
        if fingerprint is None:
            fingerprint = fingerprint_queries(np.asarray(Xq))
        return token_domain(X.shape[0] * (X.shape[1] - 1),
                            self.model.cfg.vocab_size,
                            fingerprint=fingerprint)

    def label_step(self, num_members: int, gamma: float = 0.0):
        """The raw ``distill.make_label_step`` over ``num_members``
        parameter sets."""
        from repro_torch.core.distill import make_label_step
        return make_label_step(self.model, num_members, gamma=gamma)

    def vote_members(self, bank, X, *, gamma: float = 0.0, key=None):
        """Greedy predict + token vote over a member bank in one step.
        Returns (labels (N*S,), clean gaps (N*S,)): bit for bit the
        serial per-member predicts + ``teacher_vote``."""
        dev = D.resolve(self.device)
        toks = torch.from_numpy(self._tokens(X)[:, :-1]).to(dev)
        ck = (len(bank), float(gamma))
        if ck not in self._label_steps:
            self._label_steps[ck] = self.label_step(len(bank), gamma)
        with D.full_float32(dev):
            labels, gap = self._label_steps[ck](
                [self._params(st, dev) for st in bank], {"tokens": toks},
                key)
        return labels.reshape(-1), gap.reshape(-1)


def accuracy(learner, state, X, y) -> float:
    preds = learner.predict(state, X).cpu().numpy()
    return float((preds == np.asarray(y)).mean())
