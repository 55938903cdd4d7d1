"""The kernels on the meta device: outputs of the right shape and dtype,
and the work each call would do on the card, for the dry-run.

``ops.py`` sends a meta tensor here wherever a CUDA tensor would launch
a kernel (a prefill of attention or of a recurrence); a decode step
takes the plain path on meta as it does on the card, and the dry-run's
operator counters price it like any other PyTorch op.  Nothing here
computes: a call returns empty meta tensors, so a trace costs the same
at any sequence length, where the plain versions would loop over S or
build the S x S scores.

Each call adds its work to the active ``Work`` tally (``counting``), by
the formulas of the kernels' bounds (PERF.md §6), with B the batch, H
the query heads, dh the true head dim (K3 and N1 run every head dim of
the configs natively in both dtypes, stablelm's 80 and recurrentgemma's
256 included: no pad copies), S the steps and D the channels:

  K3 attention forward     4·B·H·pairs·dh FLOPs, pairs = the (query,
                           key) pairs the mask lets through; bytes: q,
                           k, v read, o written (and the float32 row LSE
                           when a backward will read it)
  N1 attention backward    10·B·H·pairs·dh FLOPs; q, k, v, o, dO and
                           the LSE read, dq, dk, dv written
  K4 RG-LRU scan           3 FLOPs an element; x, log_a, h0 read, h,
                           h_last written, and under grad the float32
                           checkpoints its backward starts from (B,
                           ceil(S / CH), D), CH = CHECKPOINT_STEPS
  K5 WKV                   6 FLOPs a state element a step; r, k, v, w,
                           u, s0 read, o, s_last written

The recurrences' backward kernels (N2) are priced as built, recompute
and checkpoint workspace included (``csrc/rglru_scan_bwd.cu``,
``csrc/wkv6_bwd.cu``):

  N2a RG-LRU backward      7 FLOPs an element: the chunk rebuild's 3
                           (exp, a·h, + x) and the reverse walk's 4 (+
                           dh, g·a, its product with h_{t-1}, a·g); x,
                           log_a and dh read once, dx and dlog_a
                           written, dh_last read, dh0 written, and K4's
                           checkpoints read once (``RGLRUScan``, the
                           only caller under grad)
  N2b WKV backward         chunks of C = BWD_CHUNK steps, NC = ceil(S /
                           C) a (b, h), P = NC·C padded steps: 10·dh²
                           FLOPs a padded step for the five state-sized
                           products (the two chains', X1, X2, X3), 2·C·dh
                           a padded step for A = dO vᵀ, 9·(C - 1)·dh a
                           padded step for the intra-chunk terms (dr's
                           and dk's Horner walks 3 each, dw's pairs 6,
                           M 4, dv 2, a (step, later step, channel)),
                           and 2·dh² a chunk for rowsum(G_c ∘ S_c); k, v,
                           w read by the state chain, r, w, dO by the
                           gradient chain, r, k, v, w, dO by the chunks
                           (11 reads of r's size), dr, dk, dv, dw
                           written; u, s0, ds_last read, du, ds0
                           written; the checkpoints (2, B, H, NC, dh,
                           dh) and du's partials (B, H, NC, dh) written
                           once and read once

A call is one ``calls``; N2b launches three kernels a call (the chains,
the chunks, du's sum), as N1 launches three.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import wkv6 as _wk


@dataclass
class Work:
    """FLOPs and bytes that kernel calls would have cost, in total and
    by kernel name ({name: {"calls", "flops", "bytes"}})."""
    flops: int = 0
    bytes: int = 0
    by_kernel: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def add(self, name, flops, nbytes):
        self.flops += int(flops)
        self.bytes += int(nbytes)
        k = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("meta_work",
                                                         default=None)


@contextlib.contextmanager
def counting(work: Work):
    """Within the block, meta kernel calls add their work to ``work``."""
    token = _ACTIVE.set(work)
    try:
        yield work
    finally:
        _ACTIVE.reset(token)


def _add(name, flops, nbytes):
    work = _ACTIVE.get()
    if work is not None:
        work.add(name, flops, nbytes)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def valid_pairs(Sq, Skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs the mask lets through: the work this call
    needs (the bound's count, also ``chip_smoke.py``'s)."""
    q = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(q + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# K3 / N1
# ---------------------------------------------------------------------------
def _attn_flops(q, k, causal, window, q_offset, per_pair):
    B, Sq, H, dh = q.shape
    return per_pair * B * H * dh * valid_pairs(Sq, k.shape[1], causal,
                                               window, q_offset)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, Sq, H, _ = q.shape
        o = q.new_empty(q.shape)
        lse = q.new_empty((B, H, Sq), dtype=torch.float32)
        _add("flash_attention", _attn_flops(q, k, causal, window, 0, 4),
             _nbytes(q, k, v, o, lse))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), \
            v.new_empty(v.shape)
        _add("flash_attention_backward",
             _attn_flops(q, k, ctx.causal, ctx.window, 0, 10),
             _nbytes(q, k, v, o, do, lse, dq, dk, dv))
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """K3 on meta tensors (a prefill: Sq > 1, an int offset): an empty
    (B, Sq, H, dh) output in q's dtype; differentiable (N1) when a
    gradient is asked for, at q_offset 0 as on the card."""
    if _needs_grad(q, k, v):
        if q_offset:
            raise NotImplementedError("attention backward covers q_offset "
                                      "0 only, as on the card")
        return _Attention.apply(q, k, v, bool(causal), int(window))
    o = q.new_empty(q.shape)
    _add("flash_attention", _attn_flops(q, k, causal, window, q_offset, 4),
         _nbytes(q, k, v, o))
    return o


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------
def _opt_bytes(t):
    return 0 if t is None else _nbytes(t)


def _ckpt_bytes(x):
    return 4 * math.prod(_rg.checkpoint_shape(*x.shape, x.dtype))


class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_a, h0, checkpoints):
        ctx.set_materialize_grads(False)
        h = x.new_empty(x.shape)
        h_last = h0.new_empty(h0.shape, dtype=torch.float32)
        _add("rglru_scan", 3 * x.numel(), _nbytes(x, log_a, h0, h, h_last)
             + (_ckpt_bytes(x) if checkpoints else 0))
        ctx.save_for_backward(x, log_a, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, log_a, h0 = ctx.saved_tensors
        dx, dlog_a, dh0 = x.new_empty(x.shape), \
            log_a.new_empty(log_a.shape), h0.new_empty(h0.shape)
        dh_bytes = _nbytes(x)                    # dh: x's shape and dtype
        _add("rglru_scan_backward", 7 * x.numel(),
             _nbytes(x, log_a, dx, dlog_a, dh0) + dh_bytes
             + _opt_bytes(dh_last) + _ckpt_bytes(x))
        return dx, dlog_a, dh0, None


def rglru(x, log_a, h0, checkpoints=False):
    """K4 on meta tensors (S > 1): (h in x's dtype, h_last float32);
    differentiable.  ``checkpoints``: the call is under grad, so K4
    also writes its backward's checkpoints (as ``RGLRUScan`` does on the
    card)."""
    return _RGLRU.apply(x, log_a, h0, checkpoints)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
def _wkv_state_steps(r):
    B, S, H, dh = r.shape
    return B * S * H * dh * dh


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        o = r.new_empty(r.shape)
        s_last = s0.new_empty(s0.shape, dtype=torch.float32)
        _add("wkv6", 6 * _wkv_state_steps(r),
             _nbytes(r, k, v, w, u, s0, o, s_last))
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, s_last

    @staticmethod
    def backward(ctx, do, ds_last):
        r, k, v, w, u, s0 = ctx.saved_tensors
        B, S, H, dh = r.shape
        grads = tuple(t.new_empty(t.shape) for t in (r, k, v, w, u, s0))
        C = _wk.BWD_CHUNK
        ck_shape, part_shape = _wk.bwd_workspace(B, S, H, dh)
        nc = part_shape[2]
        steps = B * H * nc * C                     # padded steps
        work = 4 * (int(np.prod(ck_shape)) + int(np.prod(part_shape)))
        _add("wkv6_backward",
             (10 * dh * dh + 2 * C * dh + 9 * (C - 1) * dh) * steps
             + 2 * dh * dh * B * H * nc,
             11 * _nbytes(r) + _nbytes(u, s0) + _opt_bytes(ds_last)
             + _nbytes(*grads) + 2 * work)
        return grads


def wkv(r, k, v, w, u, s0):
    """K5 on meta tensors (S > 1): (o in r's dtype, s_last float32);
    differentiable."""
    return _WKV.apply(r, k, v, w, u, s0)
