"""Party: the data-holder side of the FedKT protocol (Algorithm 1
lines 2-12; ``repro.federation.party``).

A party never shares raw examples or teacher models.  Its entire
contribution to the round is one PartyUpdate: s student models, each
distilled from a t-teacher ensemble vote on the public queries, plus
(under L2) the vote-gap trace its local accountant needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.partition import subsets_of_partition
from repro_torch.federation.bindings import learner_kind
from repro_torch.federation.domain import fingerprint_queries, learner_domain
from repro_torch.federation.engines import Engine, get_engine
from repro_torch.federation.messages import LABEL_BYTES, PartyUpdate


def query_budget(cfg: FedKTConfig, num_public: int):
    """(party, server) query counts.  The noised side of the protocol
    answers only a ``query_fraction`` of D_aux — the DP budget knob."""
    frac = max(1, int(num_public * cfg.query_fraction))
    tq_party = num_public if cfg.privacy_level != "L2" else frac
    tq_server = num_public if cfg.privacy_level != "L1" else frac
    return tq_party, tq_server


@dataclass
class Party:
    """One silo.  ``indices`` selects its local shard of the training
    arrays.  The learner/student_learner/engine triple is the party's
    binding; ``engine`` may be None, and ``local_round`` then needs an
    explicit engine argument."""
    party_id: int
    X: np.ndarray
    y: np.ndarray
    indices: np.ndarray
    cfg: FedKTConfig
    learner: Any
    student_learner: Any
    engine: Any = None

    @property
    def num_examples(self) -> int:
        return len(self.indices)

    def _key_schedule(self, key, s: int, t: int):
        """The serial split order: per partition j, t teacher keys, then
        one vote key, then one student key."""
        teacher_keys, vote_keys, student_keys = [], [], []
        for _ in range(s):
            for _ in range(t):
                key, kk = prng.split(key)
                teacher_keys.append(kk)
            key, kk = prng.split(key)
            vote_keys.append(kk)
            key, kk = prng.split(key)
            student_keys.append(kk)
        return teacher_keys, vote_keys, student_keys, key

    def advance_key(self, key):
        """The key ``local_round`` would return, WITHOUT training."""
        cfg = self.cfg
        return self._key_schedule(key, cfg.num_partitions,
                                  cfg.num_subsets)[3]

    def subset_plan(self):
        """The party's teacher subsets: for each of the s partitions of
        its shard, the t index arrays its teachers fit on."""
        cfg = self.cfg
        return subsets_of_partition(self.indices, cfg.num_partitions,
                                    cfg.num_subsets,
                                    seed=cfg.seed + 17 * self.party_id)

    def local_round(self, key, X_public, num_queries: int,
                    engine: Engine = None):
        """Runs the party side of the single round.  Returns
        (PartyUpdate, advanced key); key threading matches the reference
        split for split."""
        cfg = self.cfg
        if engine is None:
            if self.engine is None:
                raise ValueError(
                    f"party {self.party_id} has no bound engine; pass "
                    f"engine= to local_round or bind one at construction")
            engine = self.engine
        engine = get_engine(engine)
        # the declared VoteDomain: the layout the party's STUDENTS vote
        # in at the server, over the server-side query slice
        _, tq_server = query_budget(cfg, len(X_public))
        Xq_server = X_public[:tq_server]
        dom = learner_domain(self.student_learner, Xq_server,
                             cfg.num_classes,
                             fingerprint=fingerprint_queries(Xq_server))
        s, t, u = cfg.num_partitions, cfg.num_subsets, dom.num_classes
        Xq = X_public[:num_queries]
        plan = self.subset_plan()
        gamma = cfg.gamma if cfg.privacy_level == "L2" else 0.0

        teacher_keys, vote_keys, student_keys, key = \
            self._key_schedule(key, s, t)
        datasets = [(self.X[sub], self.y[sub])
                    for j in range(s) for sub in plan[j]]
        bank = engine.fit_teachers(teacher_keys, self.learner, datasets)

        labelsets: List[np.ndarray] = []
        gaps: List[np.ndarray] = []
        for j in range(s):
            bank_j = engine.slice_bank(bank, j * t, (j + 1) * t)
            labels, gap = engine.label_queries(
                self.learner, bank_j, Xq, u, gamma=gamma,
                key=vote_keys[j])
            gaps.append(gap.cpu().numpy())
            labelsets.append(labels.cpu().numpy())
        # the teachers have voted: release them before the students fit
        # (at LM scale s t members would sit on the card beside the fits)
        del bank, bank_j
        students: List[Any] = engine.fit_students(
            student_keys, self.student_learner, Xq, labelsets)

        update = PartyUpdate(party_id=self.party_id,
                             student_states=students,
                             vote_gaps=np.concatenate(gaps),
                             num_examples=self.num_examples,
                             learner_kind=learner_kind(
                                 self.student_learner),
                             domain=dom,
                             meta={"num_teachers": s * t,
                                   "num_query_labels": int(
                                       labelsets[0].size),
                                   "label_payload_bytes": int(
                                       labelsets[0].size * LABEL_BYTES)})
        return update, key
