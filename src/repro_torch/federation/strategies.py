"""Strategies: every algorithm the paper compares is one Strategy
(``repro.federation.strategies``).

A Strategy bundles its model/learner and hyper-parameters at
construction and exposes one call:

    strategy.run(data, cfg, party_indices=None) -> StrategyResult

All strategies keep the reference's seeding (``PRNGKey(cfg.seed + 1)``
for SOLO, ``+ 2`` for central PATE, ``icfg.seed + 3`` for the iterative
baselines, ``default_rng(cfg.seed)`` for PATE's split), so each draws
the reference's keys.  A learner's ``device`` decides where SOLO and
PATE run; FedKT and the iterative baselines take a ``device`` of their
own ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch import device as D
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.baselines import _local_adam, _local_scaffold, _wavg
from repro_torch.core.learners import _pad_pow2, accuracy
from repro_torch.core.partition import dirichlet_partition
from repro_torch.core.voting import teacher_vote
from repro_torch.federation.session import FedKTSession
from repro_torch.tree_util import tree_map


@dataclass
class StrategyResult:
    name: str
    accuracy: float
    epsilon: Optional[float] = None
    state: Any = None
    meta: Dict[str, Any] = field(default_factory=dict)


class Strategy(Protocol):
    name: str

    def run(self, data: Dict[str, np.ndarray], cfg: FedKTConfig, *,
            party_indices=None) -> StrategyResult:
        ...


@dataclass
class FedKTStrategy:
    """The paper's algorithm, via FedKTSession."""
    learner: Any
    engine: str = "loop"
    student_learner: Any = None
    final_learner: Any = None
    name: str = "fedkt"
    device: str = D.DEFAULT

    def run(self, data, cfg, *, party_indices=None) -> StrategyResult:
        session = FedKTSession(self.learner, data, cfg,
                               student_learner=self.student_learner,
                               final_learner=self.final_learner,
                               engine=self.engine,
                               party_indices=party_indices,
                               device=self.device)
        res = session.run()
        return StrategyResult(self.name, res.accuracy, epsilon=res.epsilon,
                              state=res.final_state, meta=res.meta)


@dataclass
class SoloStrategy:
    """No federation: mean per-party local accuracy (paper Table 1)."""
    learner: Any
    name: str = "solo"

    def run(self, data, cfg, *, party_indices=None) -> StrategyResult:
        key = prng.PRNGKey(cfg.seed + 1)
        Xtr, ytr = data["X_train"], data["y_train"]
        if party_indices is None:
            party_indices = dirichlet_partition(ytr, cfg.num_parties,
                                                cfg.beta, cfg.seed)
        accs = []
        for ix in party_indices:
            key, kk = prng.split(key)
            st = self.learner.fit(kk, Xtr[ix], ytr[ix])
            accs.append(accuracy(self.learner, st, data["X_test"],
                                 data["y_test"]))
        return StrategyResult(self.name, float(np.mean(accs)),
                              meta={"per_party": accs})


@dataclass
class CentralPATEStrategy:
    """Centralized PATE upper bound (paper baseline 2): split the WHOLE
    training set into teachers, vote on D_aux, train one student.
    Ignores party_indices — centralization is the point."""
    learner: Any
    num_teachers: Optional[int] = None
    name: str = "pate-central"

    def run(self, data, cfg, *, party_indices=None) -> StrategyResult:
        key = prng.PRNGKey(cfg.seed + 2)
        Xtr, ytr = data["X_train"], data["y_train"]
        m = self.num_teachers or cfg.num_parties
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(len(Xtr))
        states = []
        for sub in np.array_split(perm, m):
            key, kk = prng.split(key)
            states.append(self.learner.fit(kk, Xtr[sub], ytr[sub]))
        preds = torch.stack([self.learner.predict(st, data["X_public"])
                             for st in states])
        vote = teacher_vote(preds, cfg.num_classes)
        key, kk = prng.split(key)
        st = self.learner.fit(kk, data["X_public"],
                              vote.labels.cpu().numpy())
        acc = accuracy(self.learner, st, data["X_test"], data["y_test"])
        return StrategyResult(self.name, acc, state=st)


@dataclass
class IterativeStrategy:
    """Multi-round baselines: FedAvg / FedProx / SCAFFOLD.  ``cfg``
    supplies the federation shape (parties, beta) when ``party_indices``
    is not given."""
    net: Any
    icfg: Any                           # core.baselines.IterConfig
    init_params: Any = None
    eval_every: int = 1
    label: Optional[str] = None
    device: str = D.DEFAULT

    @property
    def name(self) -> str:
        return self.label or self.icfg.algo

    def run(self, data, cfg=None, *, party_indices=None) -> StrategyResult:
        dev = D.resolve(self.device)
        with D.full_float32(dev):
            return self._run(dev, data, cfg, party_indices)

    def _run(self, dev, data, cfg, party_indices) -> StrategyResult:
        icfg = self.icfg
        num_parties = cfg.num_parties if cfg is not None else 10
        beta = cfg.beta if cfg is not None else 0.5
        key = prng.PRNGKey(icfg.seed + 3)
        Xtr, ytr = data["X_train"], data["y_train"]
        if party_indices is None:
            party_indices = dirichlet_partition(ytr, num_parties, beta,
                                                icfg.seed)
        padded = []
        for ix in party_indices:
            Xp, yp, mask = _pad_pow2(Xtr[ix].astype(np.float32), ytr[ix])
            padded.append((torch.from_numpy(Xp).to(dev),
                           torch.from_numpy(yp).long().to(dev), mask))
        sizes = np.array([len(ix) for ix in party_indices], np.float64)

        key, kk = prng.split(key)
        g_params = (D.put(self.init_params, dev)
                    if self.init_params is not None
                    else self.net.init(kk, dev))
        if icfg.algo == "scaffold":
            zeros = tree_map(torch.zeros_like, g_params)
            c_global = zeros
            c_parties = [zeros] * len(party_indices)

        Xte = torch.as_tensor(data["X_test"].astype(np.float32)).to(dev)
        yte = np.asarray(data["y_test"])
        accs: List[float] = []
        for r in range(icfg.rounds):
            locals_, new_cs = [], []
            for i, (Xp, yp, mask) in enumerate(padded):
                key, kk = prng.split(key)
                if icfg.algo == "scaffold":
                    p_i, c_i = _local_scaffold(self.net, icfg, kk, g_params,
                                               Xp, yp, mask, c_global,
                                               c_parties[i])
                    new_cs.append(c_i)
                else:
                    p_i = _local_adam(self.net, icfg, kk, g_params, Xp, yp,
                                      mask)
                locals_.append(p_i)
            g_params = _wavg(locals_, sizes)
            if icfg.algo == "scaffold":
                delta = [tree_map(lambda a, b: a - b, cn, co)
                         for cn, co in zip(new_cs, c_parties)]
                c_parties = new_cs
                c_global = tree_map(
                    lambda cg, *ds: cg + sum(ds) / len(party_indices),
                    c_global, *delta)
            if (r + 1) % self.eval_every == 0:
                with torch.no_grad():
                    logits = self.net.apply(g_params, Xte)
                preds = torch.argmax(logits, -1).cpu().numpy()
                accs.append(float((preds == yte).mean()))
        return StrategyResult(self.name, accs[-1] if accs else float("nan"),
                              state=g_params,
                              meta={"acc_per_round": accs})
