"""Wrapper of the CUDA RWKV-6 WKV kernel (``csrc/wkv6.cu``).

The counterpart of ``repro.kernels.wkv6.wkv6``: per (batch, head), the
recurrence o_t = r_t . (S + (u * k_t) v_t^T), S <- diag(w_t) S + k_t
v_t^T with a (dh x dh) float32 state, one CTA per (batch, head), each
thread holding a ``ROWS`` x ``COLS`` block of the state, time staged in
chunks of ``CHUNK`` steps.  It reads the model layout (B, S, H, dh) by
stride, where the reference transposes to (B, H, S, dh) in
``ops.wkv``.  dh must be 64 (``rwkv_head_dim`` of the supported
configs).  CUDA tensors only; ``ops.wkv`` runs the plain version
(``ref.wkv6_ref``) for CPU tensors and for the decode step.

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

HEAD_DIM = 64
DTYPES = (torch.float32, torch.bfloat16)
ROWS, COLS = 8, 4   # the state block a thread holds: 128 threads
CHUNK = 16          # steps of r, k, w, v staged in shared memory at once


class Plan(NamedTuple):
    rows: int     # state rows a thread holds
    cols: int     # state columns a thread holds
    lanes: int    # threads sharing a column block, adjacent in one warp
    threads: int  # a (batch, head)'s CTA
    chunk: int    # steps staged at once
    chunks: int   # chunks covering S; the last may be partial
    smem: int     # bytes of dynamic shared memory


def plan(S):
    """The launch plan for S steps: an 8 x 4 state block a thread, 64 /
    8 lanes sharing a column block, 64 / 4 column blocks (128 threads a
    (batch, head)).  A step's 3 x 8 + 4 floats from shared memory feed 96
    instructions; a column over 4 lanes needs 49 for 48, and that
    delivery, not the arithmetic, bounds it.  In shared memory: float32
    r, k, w, v of a chunk, rows padded to 72, double-buffered, the
    chunk's per-thread partial sums of o, (chunk, lanes, 64 + 4), u, and
    the chunk's beta_t = sum_i r_t[i] u[i] k_t[i], double-buffered."""
    lanes = HEAD_DIM // ROWS
    smem = 4 * (CHUNK * (2 * 4 * (HEAD_DIM + 8) + lanes * (HEAD_DIM + 4))
                + HEAD_DIM + 2 * CHUNK)
    return Plan(ROWS, COLS, lanes, lanes * (HEAD_DIM // COLS), CHUNK,
                -(-S // CHUNK), smem)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = build.load("wkv6").wkv6_launch
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def _check(t, name, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"wkv6: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"wkv6: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"wkv6: {name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wkv6: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"wkv6: {name} must start on a 16-byte boundary "
                         f"(the kernel's loads are 16 bytes wide)")


def wkv6(r, k, v, w, u, s0):
    """r, k, v, w: (B, S, H, dh) CUDA tensors of one dtype (float32 or
    bfloat16), contiguous, dh == 64; u: (H, dh) float32; s0: (B, H, dh,
    dh) float32.  Returns (o (B, S, H, dh) in r's dtype, s_last (B, H,
    dh, dh) float32)."""
    global launches
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, dh), got "
                         f"{tuple(r.shape)}")
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv6: dtype {r.dtype} not in {DTYPES}")
    B, S, H, dh = r.shape
    if dh != HEAD_DIM:
        raise ValueError(f"wkv6: head dim {dh} != {HEAD_DIM}")
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(t, name, (B, S, H, dh), r.dtype, dev)
    _check(u, "u", (H, dh), torch.float32, dev)
    _check(s0, "s0", (B, H, dh, dh), torch.float32, dev)
    p = plan(S)
    o = torch.empty_like(r)
    s_last = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), o.data_ptr(),
                 s_last.data_ptr(), B, S, H, dh,
                 int(r.dtype == torch.bfloat16), p.threads, p.smem, stream)
    build.check(err, "wkv6")
    launches += 1
    return o, s_last
