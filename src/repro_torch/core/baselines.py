"""Iterative federated baselines the paper compares against
(``repro.core.baselines``): FedAvg, FedProx (proximal term), SCAFFOLD
(control variates, option II).

Local solvers follow the paper's setup: Adam(lr) for FedAvg/FedProx,
SGD for SCAFFOLD (control-variate correction assumes SGD steps).  Each
local step draws its batch with ``prng.choice`` under
``split(key, local_steps)``, as the reference does, so the batches are
the reference's row for row.

This module holds the local solvers; the round orchestration lives in
``repro_torch.federation.strategies.IterativeStrategy``
(``run_iterative`` below is a deprecated wrapper over it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import device as D
from repro_torch import prng
from repro_torch.core.learners import _ce, _draw_batches
from repro_torch.optim import adamw, prox_grads
from repro_torch.tree_util import tree_map


@dataclass(frozen=True)
class IterConfig:
    algo: str = "fedavg"          # fedavg | fedprox | scaffold
    rounds: int = 50
    local_steps: int = 100        # ~ local_epochs * n_batches
    lr: float = 1e-3
    batch_size: int = 32
    mu: float = 0.1               # fedprox proximal weight
    seed: int = 0


def _batches(icfg: IterConfig, key, mask, device):
    idx = _draw_batches(prng.split(key, icfg.local_steps), mask,
                        icfg.batch_size)
    return torch.from_numpy(idx).to(device)


def _grad(net, params, xb, yb):
    return torch.func.grad(lambda p: _ce(net, p, xb, yb))(params)


def _local_adam(net, icfg: IterConfig, key, global_params, X, y, mask):
    """``local_steps`` Adam steps from the global params on one party's
    padded rows (X, y tensors; ``mask`` numpy); FedProx adds its
    proximal term to each gradient."""
    opt = adamw()
    params, state = global_params, opt.init(global_params)
    for ix in _batches(icfg, key, mask, X.device):
        g = _grad(net, params, X[ix], y[ix])
        if icfg.algo == "fedprox":
            g = prox_grads(g, params, global_params, icfg.mu)
        params, state = opt.update(g, state, params, icfg.lr)
    return params


def _local_scaffold(net, icfg: IterConfig, key, global_params, X, y, mask,
                    c_global, c_i):
    """SGD steps corrected by the control variates, then the option II
    control-variate update.  Returns (params, c_i_new)."""
    params = global_params
    for ix in _batches(icfg, key, mask, X.device):
        g = _grad(net, params, X[ix], y[ix])
        params = tree_map(lambda p, gg, cg, ci: p - icfg.lr * (gg - ci + cg),
                          params, g, c_global, c_i)
    K_eta = icfg.local_steps * icfg.lr
    c_i_new = tree_map(lambda ci, cg, xg, yi: ci - cg + (xg - yi) / K_eta,
                       c_i, c_global, global_params, params)
    return params, c_i_new


def _wavg(trees: List[Any], weights: np.ndarray):
    """Weighted average of parameter trees, summed party by party in
    order with float32 weights."""
    w = (weights / weights.sum()).astype(np.float32)
    return tree_map(lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs)),
                    *trees)


def run_iterative(net, data: Dict[str, np.ndarray], icfg: IterConfig, *,
                  num_parties=10, beta=0.5, party_indices=None,
                  init_params=None, eval_every=1,
                  device=D.DEFAULT) -> Dict[str, Any]:
    """Deprecated wrapper over ``IterativeStrategy``.  Returns
    {"acc_per_round", "params"}."""
    import warnings

    from repro_torch.configs.base import FedKTConfig
    from repro_torch.federation.strategies import IterativeStrategy

    warnings.warn("run_iterative is deprecated; use "
                  "repro_torch.federation.IterativeStrategy instead",
                  DeprecationWarning, stacklevel=2)
    cfg = FedKTConfig(num_parties=num_parties, beta=beta, seed=icfg.seed)
    res = IterativeStrategy(net, icfg, init_params=init_params,
                            eval_every=eval_every, device=device).run(
        data, cfg, party_indices=party_indices)
    return {"acc_per_round": res.meta["acc_per_round"],
            "params": res.state}
