"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The counterpart of ``repro.kernels.flash_attention.flash_attention``:
blocked online-softmax attention with GQA, a causal mask, a sliding
window, a tanh logit soft-cap and a scalar ``q_offset``; bfloat16
inputs run on the tensor cores, wgmma with TMA tile loads at every
head dim (P rounded to bf16 before P·V); float32 inputs on FMAs in full
float32.  It takes the model layout, q (B, Sq, H, dh) and k/v (B, Skv,
KV, dh), where the reference's kernel takes (B, H, S, dh) after a
transpose and padding in ``ops.attention``: the CUDA kernel reads heads
by stride (or through TMA tensor maps over the same layout, made by its
launcher) and masks its ragged edges.  CUDA tensors only; ``ops.attention`` runs
the plain version (``ref.attention_plain``) for CPU tensors.

``launches`` counts the kernel launches this process made, so a run
can show that its prefills went through the kernel.  ``plan`` is the
launch's plan, which the CUDA launcher checks against its own.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

launches = 0

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
BQ = BK = 64       # query rows a CTA, keys a tile
STAGES = 2         # the wgmma path's K / V ring
WG_THREADS = 128 + 32  # the wgmma path: a consumer warpgroup + a producer warp
FMA_THREADS = 256  # the float32 path's 16 x 16 thread grid
SMEM_MAX = 232_448  # shared memory one CTA may opt into on the H100


class Plan(NamedTuple):
    path: str     # "wgmma" (bfloat16) or "fma" (float32)
    rows: int     # query rows a CTA
    keys: int     # keys a tile
    threads: int
    smem: int     # bytes of dynamic shared memory


def plan(dh, dtype):
    """The launch plan at head dim ``dh`` and ``dtype``.  bfloat16 takes
    the wgmma path: a consumer warpgroup of 64 query rows and a producer
    warp a CTA, a Q tile and a ring of STAGES K and V tiles (64 x dh bf16
    each), 9 barriers, and 1 KB of slack to align the tiles to the
    128-byte swizzle's 1024-byte period (two CTAs an SM at dh <= 128,
    one at dh 256).  float32 takes the FMA path: Q, the K tile (reused
    as P) and the V tile in shared memory, rows padded by one float."""
    if dtype == torch.bfloat16:
        smem = 1024 + BK * dh * 2 * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES)
        return Plan("wgmma", BQ, BK, WG_THREADS, smem)
    ld, pld = dh + 1, BK + 1
    smem = 4 * (BQ * ld + max(BK * ld, BQ * pld) + BK * dh)
    return Plan("fma", BQ, BK, FMA_THREADS, smem)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 9 + [_F, _F] + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def _check(t, name, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"flash_attention: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} must be {dtype} like q, "
                        f"got {t.dtype}")
    if t.dim() != 4 or tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous in the "
                         f"(B, S, heads, dh) layout")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must start on a 16-byte "
                         f"boundary (TMA and 16-byte loads need it)")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh); CUDA tensors of one
    dtype (float32 or bfloat16), contiguous, H % KV == 0, dh in
    HEAD_DIMS.  ``q_offset`` is an int.  Returns (B, Sq, H, dh) in q's
    dtype."""
    global launches
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads do not split over "
                         f"{KV} kv heads")
    if not isinstance(q_offset, int):
        raise TypeError("flash_attention: q_offset must be an int (per-row "
                        "offsets take the plain decode path)")
    dev = q.device
    _check(q, "q", (B, Sq, H, dh), q.dtype, dev)
    _check(k, "k", (B, Skv, KV, dh), q.dtype, dev)
    _check(v, "v", (B, Skv, KV, dh), q.dtype, dev)
    p = plan(dh, q.dtype)
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, KV, dh, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), int(window), float(softcap),
                 dh ** -0.5, q_offset, p.threads, p.smem, stream)
    build.check(err, "flash_attention")
    with build.COUNT_LOCK:
        launches += 1
    return out
