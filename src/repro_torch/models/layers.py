"""Shared transformer layers: RMS and layer norms, RoPE (with
stablelm's partial rotary), GQA attention and the four MLPs
(``repro.models.layers``).  The reference's cross attention waits for
the encoder-decoder arch (``transformer._check_ported`` refuses it).

Parameters live in small ``nn.Module``s whose attribute names are the
reference's dict keys (``attn.wq``, ``ffn.w_up``, ``norm1.scale``...),
with the same orientation: a matrix is (in, out) and is applied as
``x @ W``.  The reference keeps parameters in ``cfg.param_dtype`` and
casts every matrix (and the embedding table) to ``cfg.dtype`` at each
use, while norm scales stay float32 at use; the port stores matrices
in ``cfg.dtype`` once, which gives the same values and halves the
weight bytes each bf16 decode step reads.  Norm parameters stay in
``cfg.param_dtype``.  Compute runs in ``cfg.dtype`` with float32 norms,
RoPE and softmax.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig
from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def dense(shape, dtype, device, generator=None, scale=None):
    """A (fan_in, fan_out) matrix, normal with std fan_in^-0.5 (or
    ``scale``), drawn in float32 and stored in ``dtype``; uninitialised
    when there is no generator (a conversion fills it)."""
    if generator is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    scale = shape[0] ** -0.5 if scale is None else scale
    w = torch.randn(shape, generator=generator, device=device) * scale
    return _param(w.to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        self.scale = _param(torch.ones(cfg.d_model, dtype=pd, device=device))
        if cfg.norm == "layernorm":
            self.bias = _param(torch.zeros(cfg.d_model, dtype=pd,
                                           device=device))


def apply_norm(cfg: ModelConfig, p: Norm, x):
    """RMS norm, or layer norm with scale and bias (``cfg.norm``), in
    float32, back in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def apply_rope(x, positions, theta: float, pct: float = 1.0):
    """x: (B, S, N, dh); positions: (S,) shared across the batch, or
    (B, S) per-row absolute positions (continuous-batching decode, where
    every cache slot sits at its own position).  ``pct`` < 1 rotates
    only the first ``int(dh * pct)`` (rounded down to even) channels of
    each head and passes the rest through, as stablelm does."""
    rot = int(x.shape[-1] * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 2:                     # (B, S) per-row
        ang = positions[..., None].float() * freqs
        cos = torch.cos(ang)[:, :, None, :]      # (B, S, 1, half)
        sin = torch.sin(ang)[:, :, None, :]
    else:
        ang = positions.reshape(-1, 1).float() * freqs
        cos = torch.cos(ang)[None, :, None, :]   # (1, S, 1, half)
        sin = torch.sin(ang)[None, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:rot].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    if rot == x.shape[-1]:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention block (GQA / MQA / local / softcap), causal
# ---------------------------------------------------------------------------
class Attn(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        dh, dt = cfg.head_dim_, dtype_of(cfg.dtype)
        D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.wq = dense((D, H * dh), dt, device, generator)
        self.wk = dense((D, KV * dh), dt, device, generator)
        self.wv = dense((D, KV * dh), dt, device, generator)
        self.wo = dense((H * dh, D), dt, device, generator)


# A layer's KV cache is {"k", "v"}, each (B, L, KV, dh): the length axis
# is axis 1 (the reference tags it as axis -3 from the end).
ATTN_CACHE_LEN_AXIS = 1


def init_attn_cache(cfg: ModelConfig, batch, cache_len, dtype, device):
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def grow_attn_cache(cache, target_len):
    """Pads one {"k","v"} cache with zeros to ``target_len`` along the
    length axis (no-op if already that long)."""
    def pad(t):
        cur = t.shape[ATTN_CACHE_LEN_AXIS]
        if cur >= target_len:
            return t
        return F.pad(t, (0, 0, 0, 0, 0, target_len - cur))
    return {n: pad(t) for n, t in cache.items()}


def ring_attn_cache(cache, window, cur):
    """Converts a linear prefill cache holding positions [0, cur) with
    ``cur > window`` into a ``window``-slot ring: keeps the last
    ``window`` keys, rolled so the key for position p sits at slot
    p % window."""
    shift = cur % window
    return {n: torch.roll(t[:, cur - window:cur], shift, dims=1)
            for n, t in cache.items()}


def attn_apply(cfg: ModelConfig, p: Attn, x, *, kind=ATTN, mode="train",
               cache=None, pos=None):
    """Self-attention.  Returns (y, new_cache).

    mode: "train" (no cache) | "prefill" (returns the populated linear
    cache) | "decode" (x is (B, 1, D); ``cache`` holds cache_len
    entries; ``pos`` is the absolute position of the new token — an int
    shared by the batch, or a (B,) integer tensor of PER-ROW positions).
    Decode writes the new key and value into ``cache`` in place and
    returns it (the reference returns an updated copy).
    """
    B, S, D = x.shape
    dh = cfg.head_dim_
    window = cfg.window if kind == ATTN_LOCAL else 0
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, dh)
    k = (x @ p.wk).reshape(B, S, cfg.num_kv_heads, dh)
    v = (x @ p.wv).reshape(B, S, cfg.num_kv_heads, dh)

    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        o = ops.attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    else:  # decode
        per_row = torch.is_tensor(pos) and pos.dim() == 1
        positions = (pos[:, None] if per_row else
                     torch.full((1,), int(pos), device=x.device))
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
        ck, cv = cache["k"], cache["v"]
        Lc = ck.shape[1]
        ring = window > 0 and Lc <= window
        if per_row:
            # dynamic_update_slice clamps an out-of-range start
            slot = pos % Lc if ring else pos.clamp(0, Lc - 1)
            rows = torch.arange(B, device=x.device)
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
        else:
            slot = int(pos) % Lc if ring else min(max(int(pos), 0), Lc - 1)
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
        # Ring mode: every live slot is inside the window by
        # construction, so no window mask (it would mask wrapped slots);
        # the causal mask with q_offset=pos is exact for pos < Lc.
        o = ops.attention(q, ck.to(x.dtype), cv.to(x.dtype), causal=True,
                          window=0 if ring else window,
                          softcap=cfg.attn_softcap, q_offset=pos)
        new_cache = cache

    y = o.reshape(B, S, cfg.num_heads * dh) @ p.wo
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
GATED_MLPS = ("swiglu", "geglu")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg.dtype)
        self.w_up = dense((cfg.d_model, d_ff), dt, device, generator)
        self.w_down = dense((d_ff, cfg.d_model), dt, device, generator)
        if cfg.mlp in GATED_MLPS:
            self.w_gate = dense((cfg.d_model, d_ff), dt, device, generator)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: MLP, x):
    """swiglu, geglu (gated), gelu or relu2, by ``cfg.mlp``."""
    up = x @ p.w_up
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p.w_gate) * up
    elif cfg.mlp == "geglu":
        h = gelu(x @ p.w_gate) * up
    elif cfg.mlp == "gelu":
        h = gelu(up)
    elif cfg.mlp == "relu2":
        h = F.relu(up) ** 2
    else:
        raise ValueError(cfg.mlp)
    return h @ p.w_down
