"""Optimizers as pure (init, update) pairs over parameter trees
(``repro.optim.optimizers``).

A parameter tree is a nested dict of tensors.  AdamW and SGD(+momentum)
are written out directly, plus the FedProx proximal term (adds
mu*(w - w_global) to gradients) that the paper's baselines use.  Moments
are float32 and the step count an int32 tensor on the parameters'
device, cast to float32 for the bias corrections, as in the reference;
every operation is elementwise, so a stack of models (a leading model
axis on every leaf) updates as one.

``Optimizer.update_`` applies the same per-leaf arithmetic leaf by leaf
and copies each result into the parameter and its moments: the LM
train step uses it on its float32 masters, since at phi4-mini's size a
functional update would hold a second copy of 46 GB of float32 state.
Its extra memory is one leaf's temporaries, and it gives the values
``update`` gives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree_util import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any          # first moment / momentum
    nu: Any          # second moment (adam) or an int32 zero (sgd)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    # (grads, state, params, lr) -> (params, state)
    update: Callable[..., tuple]
    # the same, in place: (grads, state, params, lr) -> (params, state)
    update_: Callable[..., tuple]


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _int_zero(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _unzip(like, out, n):
    """n trees shaped like ``like`` from ``out``, whose leaves are
    n-tuples."""
    return [tree_map(lambda _, o, i=i: o[i], like, out) for i in range(n)]


def _optimizer(init, rule, n_moments) -> Optimizer:
    """An Optimizer from its per-leaf arithmetic: ``rule(step, lr)`` is a
    function (g, p, *moments) -> (p, *moments), ``step`` the count after
    this update and ``moments`` the first ``n_moments`` of (mu, nu)."""
    def moments(state):
        return (state.mu, state.nu)[:n_moments]

    def update(grads, state, params, lr):
        step = state.step + 1
        out = tree_map(rule(step, lr), grads, params, *moments(state))
        new_p, *new_m = _unzip(grads, out, 1 + n_moments)
        nu = new_m[1] if n_moments == 2 else state.nu
        return new_p, OptState(step, new_m[0], nu)

    def update_(grads, state, params, lr):
        step = state.step + 1
        upd = rule(step, lr)
        with torch.no_grad():
            for leaves in zip(*map(tree_leaves, (grads, params,
                                                 *moments(state)))):
                for dst, src in zip(leaves[1:], upd(*leaves)):
                    dst.copy_(src)
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init, update, update_)


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        return OptState(_int_zero(params), _zeros(params), _zeros(params))

    def rule(step, lr):
        t = step.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t

        def upd(g, p, m, v):
            gf = g.to(torch.float32)
            pf = p.to(torch.float32)
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            d = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
            return (pf - lr * d).to(p.dtype), m, v

        return upd

    return _optimizer(init, rule, 2)


def sgd(momentum=0.0) -> Optimizer:
    def init(params):
        return OptState(_int_zero(params), _zeros(params),
                        _int_zero(params))

    def rule(step, lr):
        def upd(g, p, m):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m).to(p.dtype), m

        return upd

    return _optimizer(init, rule, 1)


def get(name: str, weight_decay=0.0) -> Optimizer:
    if name == "adamw":
        return adamw(weight_decay=weight_decay)
    if name == "sgd":
        return sgd()
    if name == "sgdm":
        return sgd(momentum=0.9)
    raise ValueError(name)


def clip_scale(grads, max_norm):
    """(the factor that scales ``grads`` to a global norm of at most
    ``max_norm``, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                        for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm):
    scale, gn = clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def prox_grads(grads, params, global_params, mu: float):
    """FedProx: g <- g + mu * (w - w_global)."""
    return tree_map(
        lambda g, p, gp: g + mu * (p.to(torch.float32)
                                   - gp.to(torch.float32)).to(g.dtype),
        grads, params, global_params)
