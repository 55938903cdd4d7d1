"""Execution engines: HOW a party's teachers get trained and queried
(``repro.federation.engines``).

  LoopEngine : one ``learner.fit`` per teacher, serially.
  VmapEngine : all given teachers in ONE stacked fit over a shared
               pow2-padded bucket, through the learner's
               ``fit_stacked``/``predict_stacked`` hooks — a batch axis
               in place of the reference's ``jax.vmap``.  For the tree
               learners that makes each depth level of a party's whole
               s*t teacher grid one histogram launch on the card.
  LMEngine   : the distill.py steps as the backend of an ``LMLearner``:
               full training loops for the fits, and each partition's
               vote as the label step (greedy predicts + the token vote).

PRNG contract: engines never split keys.  The Party precomputes the
serial key schedule and passes one key per teacher, so switching
engines never changes which key a teacher sees.

Vote contract: ``label_queries`` returns the labels AND the CLEAN
(pre-noise) top1-top2 gap the Lemma-7 accountant needs.
"""
from __future__ import annotations

from typing import Any, List, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.voting import party_vote_counts, teacher_vote
from repro_torch.tree_util import tree_map


class Engine(Protocol):
    """Pluggable teacher/student-execution backend."""
    name: str

    def fit_teachers(self, keys: Sequence[Any], learner,
                     datasets: Sequence[Tuple[Any, Any]]) -> Any:
        ...

    def slice_bank(self, bank, start: int, stop: int) -> Any:
        ...

    def predict_teachers(self, learner, bank, X) -> torch.Tensor:
        ...

    def label_queries(self, learner, bank, X, num_classes: int, *,
                      gamma: float = 0.0, key=None):
        ...

    def fit_students(self, keys: Sequence[Any], learner, X,
                     labelsets: Sequence[Any]) -> List[Any]:
        ...

    def predict_students(self, learner, states: Sequence[Any],
                         X) -> torch.Tensor:
        ...

    def student_vote_counts(self, learner, states: Sequence[Any], X,
                            domain, *,
                            consistent: bool = True) -> torch.Tensor:
        ...


def _stack(*leaves):
    return torch.stack([torch.as_tensor(leaf) for leaf in leaves])


def _students_vote_counts(engine, learner, states, X, domain,
                          consistent):
    preds = engine.predict_students(learner, states, X)
    return party_vote_counts(preds, domain, consistent=consistent)


def _serial_predict(learner, states, X):
    return torch.stack([learner.predict(st, X) for st in states])


def _histogram_vote(engine, learner, bank, X, num_classes, gamma, key):
    """Per-teacher predicts + one histogram build (the vote kernel)."""
    preds = engine.predict_teachers(learner, bank, X)
    vote = teacher_vote(preds, num_classes, gamma=gamma, key=key)
    return vote.labels, vote.top_gap


class LoopEngine:
    """Serial reference engine."""
    name = "loop"

    def fit_teachers(self, keys, learner, datasets):
        return [learner.fit(kk, X, y)
                for kk, (X, y) in zip(keys, datasets)]

    def slice_bank(self, bank, start, stop):
        return bank[start:stop]

    def predict_teachers(self, learner, bank, X):
        return _serial_predict(learner, bank, X)

    def label_queries(self, learner, bank, X, num_classes, *,
                      gamma=0.0, key=None):
        return _histogram_vote(self, learner, bank, X, num_classes,
                               gamma, key)

    def fit_students(self, keys, learner, X, labelsets):
        return [learner.fit(kk, X, y) for kk, y in zip(keys, labelsets)]

    def predict_students(self, learner, states, X):
        return _serial_predict(learner, states, X)

    def student_vote_counts(self, learner, states, X, domain, *,
                            consistent=True):
        return _students_vote_counts(self, learner, states, X,
                                     domain, consistent)


class VmapEngine:
    """Batched engine: every fit and predict is one stacked call."""
    name = "vmap"

    def fit_teachers(self, keys, learner, datasets):
        return learner.fit_stacked(np.stack(list(keys)),
                                   [X for X, _ in datasets],
                                   [y for _, y in datasets])

    def slice_bank(self, bank, start, stop):
        return tree_map(lambda leaf: leaf[start:stop], bank)

    def predict_teachers(self, learner, bank, X):
        return learner.predict_stacked(bank, X)

    def label_queries(self, learner, bank, X, num_classes, *,
                      gamma=0.0, key=None):
        return _histogram_vote(self, learner, bank, X, num_classes,
                               gamma, key)

    def fit_students(self, keys, learner, X, labelsets):
        stacked = learner.fit_stacked(np.stack(list(keys)),
                                      [X] * len(labelsets),
                                      list(labelsets))
        return [tree_map(lambda leaf: leaf[i], stacked)
                for i in range(len(labelsets))]

    def predict_students(self, learner, states, X):
        return learner.predict_stacked(tree_map(_stack, *states), X)

    def student_vote_counts(self, learner, states, X, domain, *,
                            consistent=True):
        return _students_vote_counts(self, learner, states, X,
                                     domain, consistent)


class LMEngine:
    """LM engine: distill.py's label and train steps as the execution
    backend.  A bank is the sequence of member states (the reference
    stacks them on a leading axis for its vmap'd label step; the port's
    label step predicts member by member, since a ctypes kernel cannot
    be batched, so a list holds them without a stacked copy).  The
    per-partition vote is the fused label step: greedy predicts + the
    token vote (the vote kernel on the card, with noise).

    Requires the learner to provide the LM hooks (``vote_members``,
    ``predict_stacked`` — core.learners.LMLearner); generic learners
    should use the loop/vmap engines instead."""
    name = "lm"

    @staticmethod
    def _require_lm(learner):
        if not hasattr(learner, "vote_members"):
            raise TypeError(
                f"engine='lm' needs an LM learner (vote_members/"
                f"predict_stacked hooks); got {type(learner).__name__}. "
                f"Use engine='loop' or 'vmap' for generic learners.")

    def fit_teachers(self, keys, learner, datasets):
        self._require_lm(learner)
        return [learner.fit(kk, X, y) for kk, (X, y) in zip(keys, datasets)]

    def slice_bank(self, bank, start, stop):
        return bank[start:stop]

    def predict_teachers(self, learner, bank, X):
        return learner.predict_stacked(bank, X)

    def label_queries(self, learner, bank, X, num_classes, *,
                      gamma=0.0, key=None):
        self._require_lm(learner)
        vocab = learner.model.cfg.vocab_size
        if num_classes != vocab:
            raise ValueError(f"cfg.num_classes={num_classes} must equal "
                             f"the model vocab_size={vocab} on the LM "
                             f"path (token labels ARE class labels)")
        return learner.vote_members(bank, X, gamma=gamma, key=key)

    def fit_students(self, keys, learner, X, labelsets):
        return [learner.fit(kk, X, y) for kk, y in zip(keys, labelsets)]

    def predict_students(self, learner, states, X):
        return _serial_predict(learner, states, X)

    def student_vote_counts(self, learner, states, X, domain, *,
                            consistent=True):
        return _students_vote_counts(self, learner, states, X,
                                     domain, consistent)


_ENGINES = {"loop": LoopEngine, "vmap": VmapEngine, "lm": LMEngine}


def get_engine(engine) -> Engine:
    """Engine instance from a name ("loop" | "vmap" | "lm") or
    pass-through."""
    if isinstance(engine, str):
        if engine not in _ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"available: {sorted(_ENGINES)}")
        return _ENGINES[engine]()
    return engine
