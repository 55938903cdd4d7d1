"""RecurrentGemma / Griffin recurrent block (RG-LRU)
(``repro.models.rglru``).

Block structure (Griffin, arXiv:2402.19427):
    x -> W_in -> causal conv1d(width 4) -> RG-LRU -> (* gelu-gate branch)
      -> W_out
RG-LRU:
    r_t = sigmoid(W_a y_t);  i_t = sigmoid(W_x y_t)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)
The scan runs through ``kernels.ops.rglru`` (the CUDA kernel for a
prefill on the card, the plain formula for a decode step and on the
CPU).  As in the reference, the gate projections W_a / W_x are dense,
not block-diagonal per head.

Parameter dtypes follow what the reference reads: W_a, W_x and Lambda
are used in float32 (``yf @ w_a.astype(float32)``) and are stored in
float32; the other matrices and the conv taps are cast to x's dtype at
each use in the reference and are stored in ``cfg.dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _param, dense, dtype_of


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        D, W = cfg.d_model, cfg.rglru_conv_width
        dt, f32 = dtype_of(cfg.dtype), torch.float32
        self.w_in = dense((D, D), dt, device, generator)
        self.w_gate = dense((D, D), dt, device, generator)
        self.conv_w = dense((W, D), dt, device, generator)
        self.conv_b = _param(torch.zeros((D,), dtype=dt, device=device))
        self.w_a = dense((D, D), f32, device, generator)
        self.w_x = dense((D, D), f32, device, generator)
        self.w_out = dense((D, D), dt, device, generator)
        lam = torch.empty((D,), dtype=f32, device=device)
        if generator is not None:
            # Lambda such that a = exp(-c softplus(Lambda)) starts in
            # [0.9, 0.999], as the reference draws it
            a0 = torch.rand((D,), generator=generator, device=device)
            z = -torch.log(0.9 + 0.099 * a0) / cfg.rglru_c
            lam = torch.log(torch.expm1(z))
        self.lam = _param(lam)


def init_rglru_state(cfg: ModelConfig, batch, dtype, device):
    D, W = cfg.d_model, cfg.rglru_conv_width
    return {"h": torch.zeros((batch, D), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, W - 1, D), dtype=dtype,
                                device=device)}


def _conv1d(p: RGLRU, x, state=None):
    """Causal depthwise conv of width W, its taps summed left to right
    in x's dtype.  x: (B, S, D); state: (B, W - 1, D) or None (zeros).
    Returns (y, the new state: the last W - 1 inputs)."""
    W = p.conv_w.shape[0]
    B, S, D = x.shape
    pad = (torch.zeros((B, W - 1, D), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                     # (B, S + W - 1, D)
    w = p.conv_w.to(x.dtype)
    y = 0
    for i in range(W):
        y = y + xp[:, i:i + S] * w[i]
    return y + p.conv_b.to(x.dtype), xp[:, -(W - 1):]


def rglru_apply(cfg: ModelConfig, p: RGLRU, x, *, mode="train", state=None):
    """x: (B, S, D).  Returns (y, new_state); the state ({"h", "conv"})
    is returned in modes "prefill" and "decode", None in "train"."""
    gate_branch = F.gelu(x @ p.w_gate, approximate="tanh")

    y = x @ p.w_in
    y, new_conv = _conv1d(p, y, state["conv"] if state is not None
                          else None)

    yf = y.float()
    r = torch.sigmoid(yf @ p.w_a)
    i = torch.sigmoid(yf @ p.w_x)
    log_a = -cfg.rglru_c * F.softplus(p.lam) * r             # (B, S, D) < 0
    beta = torch.sqrt(1.0 - torch.exp(2.0 * log_a))
    gated_in = (beta * i * yf).to(x.dtype)

    h0 = state["h"] if state is not None else None
    h, h_last = ops.rglru(gated_in, log_a.to(x.dtype), h0)

    out = (h.to(x.dtype) * gate_branch) @ p.w_out
    new_state = None
    if mode in ("prefill", "decode"):
        new_state = {"h": h_last.float(), "conv": new_conv}
    return out, new_state
