"""Mixture-of-experts FFN with capacity-based grouped dispatch
(``repro.models.moe``).

  1. router softmax -> top-k experts per token (gates renormalised);
  2. slot assignment: each (token, choice) pick's position within its
     expert, in token-major order; picks beyond the capacity C =
     ceil(T * k * cf / E) are dropped;
  3. the tokens gathered into a dense (E, C, D) block -> batched expert
     products over the stacked expert weights;
  4. combine: each token's kept picks, read back from their slots and
     weighted by their gates, summed in ascending expert order.

The reference combines by a scatter-add of every slot into a zero (T, D)
buffer, in slot order (expert-major).  The port gathers instead: a
float scatter-add on the card adds with atomics, whose order, and so
whose result, changes from run to run.  Reading each token's picks in
ascending expert order and summing them from zero in ``x.dtype`` is the
reference's sum term for term (an unfilled slot adds 0 to token 0 there;
a dropped pick adds nothing).  The top-k is the first k of a stable
descending sort, so that equal probabilities pick the lower expert, as
``jax.lax.top_k`` does.

DeepSeek-style shared experts run densely over all tokens and are added
to the routed output.  Plain PyTorch on both devices: the reference has
no Pallas kernel here (its dispatch is ``einsum``, ``cumsum`` and
``.at[]`` scatters).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class SharedExperts(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        D, Fs = cfg.d_model, cfg.moe.num_shared_experts * cfg.d_ff
        dt = L.dtype_of(cfg.dtype)
        self.w_up = L.dense((D, Fs), dt, device, generator)
        self.w_down = L.dense((Fs, D), dt, device, generator)
        if cfg.mlp in L.GATED_MLPS:
            self.w_gate = L.dense((D, Fs), dt, device, generator)


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves, names and orientation:
    router (D, E), w_up and w_gate (E, D, F), w_down (E, F, D), and
    ``shared`` when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        m = cfg.moe
        E, D, Fe = m.num_experts, cfg.d_model, cfg.d_ff
        dt = L.dtype_of(cfg.dtype)
        self.router = L.dense((D, E), dt, device, generator, scale=0.02)
        self.w_up = L.dense((E, D, Fe), dt, device, generator,
                            scale=D ** -0.5)
        self.w_down = L.dense((E, Fe, D), dt, device, generator,
                              scale=Fe ** -0.5)
        if cfg.mlp in L.GATED_MLPS:
            self.w_gate = L.dense((E, D, Fe), dt, device, generator,
                                  scale=D ** -0.5)
        if m.num_shared_experts:
            self.shared = SharedExperts(cfg, device, generator)


def _act(cfg: ModelConfig, g, up):
    if cfg.mlp == "swiglu":
        return F.silu(g) * up
    if cfg.mlp == "geglu":
        return L.gelu(g) * up
    raise ValueError(cfg.mlp)


def _ffn(cfg: ModelConfig, p, x, mm):
    """An (expert or shared) FFN of ``x`` through the product ``mm``."""
    up = mm(x, p.w_up)
    h = _act(cfg, mm(x, p.w_gate), up) if hasattr(p, "w_gate") \
        else L.gelu(up)
    return mm(h, p.w_down)


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots an expert holds for ``num_tokens`` tokens: the reference's
    float expression ``int(-(-T * K * cf // E))``, copied as it is."""
    m = cfg.moe
    return int(-(-num_tokens * m.top_k * m.capacity_factor
                 // m.num_experts))


class Routing(NamedTuple):
    """One dispatch's decisions.  ``idx``/``gate`` (T, K): each token's
    experts and renormalised float32 gates in the reference's top-k
    order; ``pos`` (T, K): each pick's slot in its expert, C where it is
    dropped; ``slot_tok``/``slot_gate`` (E, C): the token and gate each
    slot holds (token 0 and gate 0 where it is unfilled); ``probs`` (T,
    E) the float32 router softmax."""
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    slot_tok: torch.Tensor
    slot_gate: torch.Tensor
    probs: torch.Tensor


def _top_k(probs, k):
    """The k largest of each row, largest first, equal values in
    ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(cfg: ModelConfig, p: MoE, xf) -> Routing:
    """The router and the slot assignment of the tokens ``xf`` (T, D)."""
    m = cfg.moe
    T = xf.shape[0]
    E, K = m.num_experts, m.top_k
    logits = (xf @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, K)
    gate = gate / gate.sum(-1, keepdim=True)

    C = capacity(cfg, T)
    flat_e = idx.reshape(T * K)                       # token-major
    onehot = F.one_hot(flat_e, E)                     # (TK, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0), 1,
                       flat_e[:, None])[:, 0] - 1
    valid = pos < C
    pos = torch.where(valid, pos, torch.full_like(pos, C))  # spill slot C
    tok = torch.arange(T * K, device=xf.device) // K
    slot_tok = torch.zeros((E, C + 1), dtype=torch.long, device=xf.device)
    slot_tok[flat_e, pos] = tok        # duplicates land only in column C
    slot_gate = torch.zeros((E, C + 1), dtype=torch.float32,
                            device=xf.device)
    slot_gate[flat_e, pos] = torch.where(valid, gate.reshape(T * K), 0.0)
    return Routing(idx, gate, pos.reshape(T, K), slot_tok[:, :C],
                   slot_gate[:, :C], probs)


def aux_loss(cfg: ModelConfig, r: Routing):
    """The switch-style load-balance loss, float32:
    w * E * sum(mean(probs) * mean(onehot(top-1)))."""
    m = cfg.moe
    E = m.num_experts
    me = r.probs.mean(0)
    ce = F.one_hot(r.idx[:, 0], E).float().mean(0)
    return m.router_aux_weight * E * torch.sum(me * ce)


def moe_apply(cfg: ModelConfig, p: MoE, x):
    """x: (B, S, D).  Returns (y (B, S, D) in x's dtype, float32 aux
    loss)."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    r = route(cfg, p, xf)
    E, C = r.slot_tok.shape

    # ---- expert compute ----
    x_grp = xf[r.slot_tok.reshape(-1)].reshape(E, C, D)
    y_grp = _ffn(cfg, p, x_grp, torch.bmm)            # (E, C, D)

    # ---- combine: gather each token's picks, ascending expert order ----
    y_pad = torch.cat([y_grp, y_grp.new_zeros((E, 1, D))], dim=1)
    order = torch.argsort(r.idx, dim=-1, stable=True)
    e_s = torch.gather(r.idx, 1, order)
    pos_s = torch.gather(r.pos, 1, order)
    g_s = torch.gather(r.gate, 1, order)
    g_s = torch.where(pos_s < C, g_s, 0.0).to(x.dtype)
    picked = y_pad[e_s, pos_s] * g_s[..., None]       # (T, K, D)
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(r.idx.shape[1]):
        y = y + picked[:, j]

    if hasattr(p, "shared"):
        y = y + _ffn(cfg, p.shared, xf, torch.matmul)
    return y.reshape(B, S, D), aux_loss(cfg, r)


def moe_ref(cfg: ModelConfig, p: MoE, x):
    """Dense oracle: every expert on every token, the exact top-k
    combine in float32 (no capacity drops).  For tests only."""
    m = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    probs = torch.softmax((xf @ p.router).float(), dim=-1)
    gate, idx = _top_k(probs, m.top_k)
    gate = gate / gate.sum(-1, keepdim=True)

    def mm(a, w):       # "td,edf->tef"
        return torch.einsum("td,edf->tef", a, w) if a.dim() == 2 \
            else torch.einsum("tef,efd->ted", a, w)

    y_all = _ffn(cfg, p, xf, mm)                      # (T, E, D)
    w = torch.zeros(probs.shape, dtype=torch.float32, device=x.device)
    w.scatter_(1, idx, gate)
    y = torch.einsum("ted,te->td", y_all.float(), w).to(x.dtype)
    if hasattr(p, "shared"):
        y = y + _ffn(cfg, p.shared, xf, torch.matmul)
    return y.reshape(B, S, D)
