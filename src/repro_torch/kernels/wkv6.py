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

Training: ``wkv6_backward`` runs the hand-written backward
(``csrc/wkv6_bwd.cu``, N2b) in the chunked form that
``ref.wkv6_backward_chunked_plain`` states: two sequential chains a
(batch, head) write the float32 state before each chunk of
``BWD_CHUNK`` steps and the state gradient at its end into a workspace
the wrapper allocates, then a CTA a (batch, head, chunk) takes the
chunk's gradients from those two on the tensor cores (TF32 in
bfloat16; FMAs in float32), and du's partials are summed over the batch
and the chunks in order.  ``BWD_CHUNK`` is the chunk's one owner: the
launcher takes it as an argument.  Its gradients are held to
``ref.wkv6_backward_plain``.  ``bwd_launches`` counts its kernel
launches (``BWD_KERNELS`` a call).
``WKV6`` is the ``torch.autograd.Function`` that joins forward and
backward; ``ops.wkv`` takes it for a CUDA prefill that needs a
gradient.  The reference has no backward kernel: off the TPU it
differentiates its xla recurrence.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

launches = 0
bwd_launches = 0
BWD_KERNELS = 3     # a backward call: the chains, the chunks, du's sum

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


BWD_CHUNK = 16  # the backward's chunk: steps between float32 checkpoints


def bwd_workspace(B, S, H, dh=HEAD_DIM, chunk=BWD_CHUNK):
    """The float32 workspaces of a backward call: the checkpoints (2, B,
    H, NC, dh, dh), the state before each of the NC = ceil(S / chunk)
    chunks and the state gradient at its end, and du's partials (B, H,
    NC, dh), a (batch, head, chunk) each."""
    nc = -(-S // chunk)
    return (2, B, H, nc, dh, dh), (B, H, nc, dh)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _bwd_lib():
    fn = build.load("wkv6_bwd").wkv6_bwd_launch
    fn.argtypes = [_P] * 16 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


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
    with build.COUNT_LOCK:
        launches += 1
    return o, s_last


def wkv6_backward(r, k, v, w, u, s0, do, ds_last=None):
    """The gradients (dr, dk, dv, dw, du, ds0) of ``wkv6(r, k, v, w, u,
    s0)`` given ``do`` (B, S, H, dh) in r's dtype, the gradient of o,
    and ``ds_last`` (B, H, dh, dh) float32 or None (zeros), the gradient
    of s_last.  CUDA tensors as ``wkv6`` takes them, S >= 1.  dr, dk,
    dv, dw come in r's dtype, du and ds0 float32."""
    global bwd_launches
    if r.dim() != 4:
        raise ValueError(f"wkv6_backward: r must be (B, S, H, dh), got "
                         f"{tuple(r.shape)}")
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv6_backward: dtype {r.dtype} not in {DTYPES}")
    B, S, H, dh = r.shape
    if dh != HEAD_DIM:
        raise ValueError(f"wkv6_backward: head dim {dh} != {HEAD_DIM}")
    if S < 1:
        raise ValueError("wkv6_backward: S must be at least 1")
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("do", do)):
        _check(t, name, (B, S, H, dh), r.dtype, dev)
    _check(u, "u", (H, dh), torch.float32, dev)
    _check(s0, "s0", (B, H, dh, dh), torch.float32, dev)
    if ds_last is not None:
        _check(ds_last, "ds_last", (B, H, dh, dh), torch.float32, dev)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, dh), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    ck_shape, part_shape = bwd_workspace(B, S, H, dh)
    ckpt = torch.empty(ck_shape, dtype=torch.float32, device=dev)
    du_part = torch.empty(part_shape, dtype=torch.float32, device=dev)
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), do.data_ptr(),
                 None if ds_last is None else ds_last.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), ds0.data_ptr(), du_part.data_ptr(),
                 ckpt.data_ptr(), B, S, H, dh,
                 int(r.dtype == torch.bfloat16), BWD_CHUNK, stream)
    build.check(err, "wkv6_backward")
    with build.COUNT_LOCK:
        bwd_launches += BWD_KERNELS
    return dr, dk, dv, dw, du, ds0


class WKV6(torch.autograd.Function):
    """The WKV recurrence with a gradient: the forward kernel, then
    ``wkv6_backward``, which rebuilds the states from the saved inputs
    (nothing of the forward's outputs is kept).  Only the gradients
    ``ctx.needs_input_grad`` asks for are returned; the backward runs
    when any is asked."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return wkv6(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, do, ds_last):
        if not any(ctx.needs_input_grad):
            return (None,) * 6
        r, k, v, w, u, s0 = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.contiguous()
        grads = wkv6_backward(
            r, k, v, w, u, s0, do,
            None if ds_last is None else ds_last.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
