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
the query heads, dh the true head dim (stablelm's 80, which K3 runs
natively and N1 padded to 128), S the steps and D the channels:

  K3 attention forward     4·B·H·pairs·dh FLOPs, pairs = the (query,
                           key) pairs the mask lets through; bytes: q,
                           k, v read, o written (and the float32 row LSE
                           when a backward will read it)
  N1 attention backward    10·B·H·pairs·dh FLOPs; q, k, v, o, dO and
                           the LSE read, dq, dk, dv written
  K4 RG-LRU scan           3 FLOPs an element; x, log_a, h0 read, h,
                           h_last written
  K5 WKV                   6 FLOPs a state element a step; r, k, v, w,
                           u, s0 read, o, s_last written

The recurrences' backward kernels do not exist yet (ROADMAP §2, N2):
on the card a training call of ``rglru`` or ``wkv`` raises, but the
reference trains these archs, so their dry-run prices a first-order
backward: a reverse scan of 5 FLOPs an element for K4 (the carried
gradient's multiply-add, exp(log_a), and dlog_a's two multiplies), and
12 FLOPs a state element a step for K5 (the forward's 6 again for the
recomputed state, 6 for the state gradient and dr, dk, dv, dw); bytes
again each input read and each output written once.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch


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
class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_a, h0):
        h = x.new_empty(x.shape)
        h_last = h0.new_empty(h0.shape, dtype=torch.float32)
        _add("rglru_scan", 3 * x.numel(), _nbytes(x, log_a, h0, h, h_last))
        ctx.save_for_backward(log_a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, h, h0 = ctx.saved_tensors
        dx, dlog_a, dh0 = h.new_empty(h.shape), \
            log_a.new_empty(log_a.shape), h0.new_empty(h0.shape)
        _add("rglru_scan_backward", 5 * h.numel(),
             _nbytes(dh, dh_last, log_a, h, h0, dx, dlog_a, dh0))
        return dx, dlog_a, dh0


def rglru(x, log_a, h0):
    """K4 on meta tensors (S > 1): (h in x's dtype, h_last float32);
    differentiable."""
    return _RGLRU.apply(x, log_a, h0)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
def _wkv_state_steps(r):
    B, S, H, dh = r.shape
    return B * S * H * dh * dh


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        o = r.new_empty(r.shape)
        s_last = s0.new_empty(s0.shape, dtype=torch.float32)
        _add("wkv6", 6 * _wkv_state_steps(r),
             _nbytes(r, k, v, w, u, s0, o, s_last))
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, s_last

    @staticmethod
    def backward(ctx, do, ds_last):
        r, k, v, w, u, s0 = ctx.saved_tensors
        grads = tuple(t.new_empty(t.shape) for t in (r, k, v, w, u, s0))
        _add("wkv6_backward", 12 * _wkv_state_steps(r),
             _nbytes(r, k, v, w, u, s0, do, ds_last, *grads))
        return grads


def wkv(r, k, v, w, u, s0):
    """K5 on meta tensors (S > 1): (o in r's dtype, s_last float32);
    differentiable."""
    return _WKV.apply(r, k, v, w, u, s0)
