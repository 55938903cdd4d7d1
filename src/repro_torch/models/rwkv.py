"""RWKV-6 (Finch) block: time-mix (the WKV recurrence) and channel-mix
(``repro.models.rwkv``).

As in the reference, token-shift interpolation uses static per-channel
mix vectors (RWKV-5 style) in place of the data-dependent ddlerp LoRA,
while the decay keeps its data-dependent LoRA, w = exp(-exp(w0 +
tanh(x W1) W2)).  The reference's sharding constraints do nothing on one
device and are left out.  The recurrence runs through ``kernels.ops.wkv``
(the CUDA kernel for a prefill on the card, the plain formula for a
decode step and on the CPU).

Parameter dtypes follow what the reference reads: w0 and u are float32,
and ln_scale is applied in float32, so the three are stored in float32;
the matrices and the mix vectors are cast to x's dtype at each use in the
reference and are stored in ``cfg.dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _param, dense, dtype_of

_W_LORA = 64
GROUPNORM_EPS = 64e-5


class RWKV(nn.Module):
    """Time-mix and channel-mix parameters of one layer (the reference's
    ``tm`` subtree holds both)."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        D, H, dh = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
        if H * dh != D:
            raise ValueError(f"rwkv: {H} heads x {dh} != d_model {D}")
        dt, f32 = dtype_of(cfg.dtype), torch.float32

        def mix():
            if generator is None:
                return _param(torch.empty((D,), dtype=dt, device=device))
            return _param(torch.rand((D,), generator=generator,
                                     device=device).to(dt))

        def mat(shape, scale=None):
            return dense(shape, dt, device, generator, scale)

        # time-mix
        self.mu_r, self.mu_k, self.mu_v, self.mu_w, self.mu_g = (
            mix() for _ in range(5))
        self.w_r, self.w_k, self.w_v, self.w_g, self.w_o = (
            mat((D, D)) for _ in range(5))
        self.w0 = _param(torch.full((D,), -0.6, dtype=f32, device=device))
        self.w_lora_a = mat((D, _W_LORA), 0.01)
        self.w_lora_b = mat((_W_LORA, D), 0.01)
        u = torch.empty((H, dh), dtype=f32, device=device)
        if generator is not None:
            u = torch.randn((H, dh), generator=generator, device=device) * 0.1
        self.u = _param(u)
        self.ln_scale = _param(torch.ones((H, dh), dtype=f32, device=device))
        # channel-mix
        self.cm_mu_k, self.cm_mu_r = mix(), mix()
        self.cm_w_r = mat((D, D))
        self.cm_w_up = mat((D, cfg.d_ff))
        self.cm_w_down = mat((cfg.d_ff, D))


def init_rwkv_state(cfg: ModelConfig, batch, dtype, device):
    D, H, dh = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    return {"wkv": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                               device=device),
            "shift_t": torch.zeros((batch, D), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, D), dtype=dtype, device=device)}


def _token_shift(x, last):
    """x_{t-1}, with ``last`` (B, D) filling position 0, and the new
    last (x's final position)."""
    prev = torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1]


def _lerp(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def rwkv_time_mix(cfg: ModelConfig, p: RWKV, x, *, state=None):
    """x: (B, S, D).  Returns (y, new_state): {"wkv", "shift_t"} when a
    state ({"wkv", "shift_t", ...}) is given, else None."""
    B, S, D = x.shape
    H, dh = cfg.num_heads, cfg.rwkv_head_dim
    last = (state["shift_t"] if state is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    prev, new_last = _token_shift(x, last)

    r = _lerp(x, prev, p.mu_r) @ p.w_r
    k = _lerp(x, prev, p.mu_k) @ p.w_k
    v = _lerp(x, prev, p.mu_v) @ p.w_v
    g = _lerp(x, prev, p.mu_g) @ p.w_g
    xw = _lerp(x, prev, p.mu_w)

    # data-dependent decay (Finch): the matmuls in x's dtype, the double
    # exponential in float32
    dd = torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b
    w = torch.exp(-torch.exp(p.w0 + dd.float()))             # (B, S, D)

    shp = (B, S, H, dh)
    s0 = state["wkv"] if state is not None else None
    o, s_last = ops.wkv(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                        w.to(x.dtype).reshape(shp), p.u, s0)
    # per-head group norm
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = ((of - mu) ** 2).mean(-1, keepdim=True)
    of = (of - mu) * torch.rsqrt(var + GROUPNORM_EPS)
    o = (of * p.ln_scale.float()).to(x.dtype)

    out = (o.reshape(B, S, D) * F.silu(g)) @ p.w_o
    new_state = None if state is None else {
        "wkv": s_last, "shift_t": new_last.to(x.dtype)}
    return out, new_state


def rwkv_channel_mix(cfg: ModelConfig, p: RWKV, x, *, state=None):
    """x: (B, S, D).  Returns (y, the new channel-mix shift (B, D), or
    None without a state)."""
    B, S, D = x.shape
    last = (state["shift_c"] if state is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    prev, new_last = _token_shift(x, last)
    k = _lerp(x, prev, p.cm_mu_k) @ p.cm_w_up
    r = torch.sigmoid(_lerp(x, prev, p.cm_mu_r) @ p.cm_w_r)
    y = (F.relu(k) ** 2) @ p.cm_w_down
    return r * y, (None if state is None else new_last.to(x.dtype))
