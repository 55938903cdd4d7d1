"""Wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The counterpart of ``repro.kernels.rglru_scan.rglru_scan``: the linear
recurrence h_t = exp(log_a_t) * h_{t-1} + x_t along the sequence axis
with a float32 carry, each (batch, channel) walked in order, so h and
h_last equal the plain version bit for bit.  Any S and D: the C
launcher stages time through TMA where the layout allows (rows of D
elements a multiple of 16 bytes) and loads element by element where it
does not; the ring and shared memory live in the .cu, the box's steps
are ``CHECKPOINT_STEPS``, which the launcher checks.
h_last is float32, as the reference's off-TPU paths (its xla scan, its
decode step and ``ref.rglru_scan_ref``) return it and its model state
carries it; the TPU kernel rounds it to x's dtype (ROADMAP §3).  CUDA
tensors only; ``ops.rglru`` runs the plain version
(``ref.rglru_scan_ref``) for CPU tensors and for the decode step.

``launches`` counts the kernel launches this process made, so a run
can show that its prefills went through the kernel.

Training: ``rglru_scan(..., checkpoints=True)`` also writes the
float32 carry before each chunk of ``CHECKPOINT_STEPS`` steps, and
``rglru_scan_backward`` runs the hand-written backward
(``csrc/rglru_scan_bwd.cu``, N2a) from those checkpoints: it walks the
gradient back chunk by chunk, each chunk's carries rebuilt from the one
before it, reading x, log_a and dh once, and equals
``ref.rglru_scan_backward_plain`` bit for bit; ``bwd_launches`` counts
its launches.  ``CHECKPOINT_STEPS`` is the chunk's one owner (both
launchers take it and refuse any other): the steps of the forward
kernel's TMA box.  ``RGLRUScan`` is the ``torch.autograd.Function``
that joins the two kernels; ``ops.rglru`` takes it for a CUDA prefill
that needs a gradient.  The reference has no backward kernel: off the
TPU it differentiates its xla scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
bwd_launches = 0
BWD_KERNELS = 1         # a backward call launches one kernel
# steps between the float32 carries the backward starts its chunks from:
# one 4 KB TMA box of 32 channels (csrc/rglru_scan.cu: Tile)
CHECKPOINT_STEPS = {torch.bfloat16: 64, torch.float32: 32}

DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def _bwd_lib():
    fn = build.load("rglru_scan_bwd").rglru_scan_bwd_launch
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def _check(t, name, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"rglru_scan: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"rglru_scan: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"rglru_scan: {name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rglru_scan: {name} must be contiguous")


def checkpoint_shape(B, S, D, dtype):
    """The float32 checkpoints' shape: the carry before each chunk of
    ``CHECKPOINT_STEPS[dtype]`` steps."""
    return (B, -(-S // CHECKPOINT_STEPS[dtype]), D)


def rglru_scan(x, log_a, h0, checkpoints=False):
    """x, log_a: (B, S, D) CUDA tensors of one dtype (float32 or
    bfloat16), contiguous; h0: (B, D) float32.  Returns (h (B, S, D) in
    x's dtype, h_last (B, D) float32), and with ``checkpoints`` also the
    float32 carry before each chunk (``checkpoint_shape``), which
    ``rglru_scan_backward`` takes."""
    global launches
    if x.dim() != 3:
        raise ValueError(f"rglru_scan: x must be (B, S, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"rglru_scan: dtype {x.dtype} not in {DTYPES}")
    B, S, D = x.shape
    dev = x.device
    _check(x, "x", (B, S, D), x.dtype, dev)
    _check(log_a, "log_a", (B, S, D), x.dtype, dev)
    _check(h0, "h0", (B, D), torch.float32, dev)
    h = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=torch.float32, device=dev)
    ckpt = (torch.empty(checkpoint_shape(B, S, D, x.dtype),
                        dtype=torch.float32, device=dev)
            if checkpoints else None)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), log_a.data_ptr(), h0.data_ptr(),
                 h.data_ptr(), h_last.data_ptr(),
                 None if ckpt is None else ckpt.data_ptr(), B, S, D,
                 int(x.dtype == torch.bfloat16), CHECKPOINT_STEPS[x.dtype],
                 stream)
    build.check(err, "rglru_scan")
    with build.COUNT_LOCK:
        launches += 1
    return (h, h_last, ckpt) if checkpoints else (h, h_last)


def rglru_scan_backward(x, log_a, ckpt, dh, dh_last=None):
    """The gradients (dx, dlog_a, dh0) of ``rglru_scan(x, log_a, h0)``
    from ``ckpt``, the checkpoints ``rglru_scan(x, log_a, h0,
    checkpoints=True)`` wrote, given ``dh`` (B, S, D) in x's dtype, the
    gradient of h, and ``dh_last`` (B, D) float32 or None (zeros), the
    gradient of h_last.  CUDA tensors, contiguous, S >= 1.  dx and
    dlog_a come in x's dtype, dh0 float32."""
    global bwd_launches
    if x.dim() != 3:
        raise ValueError(f"rglru_scan_backward: x must be (B, S, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"rglru_scan_backward: dtype {x.dtype} not in "
                        f"{DTYPES}")
    B, S, D = x.shape
    if S < 1:
        raise ValueError("rglru_scan_backward: S must be at least 1")
    dev = x.device
    _check(x, "x", (B, S, D), x.dtype, dev)
    _check(log_a, "log_a", (B, S, D), x.dtype, dev)
    _check(ckpt, "ckpt", checkpoint_shape(B, S, D, x.dtype), torch.float32,
           dev)
    _check(dh, "dh", (B, S, D), x.dtype, dev)
    if dh_last is not None:
        _check(dh_last, "dh_last", (B, D), torch.float32, dev)
    dx, dla = torch.empty_like(x), torch.empty_like(log_a)
    dh0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), log_a.data_ptr(), ckpt.data_ptr(),
                 dh.data_ptr(), None if dh_last is None else
                 dh_last.data_ptr(), dx.data_ptr(), dla.data_ptr(),
                 dh0.data_ptr(), B, S, D, int(x.dtype == torch.bfloat16),
                 CHECKPOINT_STEPS[x.dtype], stream)
    build.check(err, "rglru_scan_backward")
    with build.COUNT_LOCK:
        bwd_launches += BWD_KERNELS
    return dx, dla, dh0


class RGLRUScan(torch.autograd.Function):
    """The scan with a gradient: the forward kernel, which also writes
    the float32 checkpoints (B x ceil(S / CHECKPOINT_STEPS) x D, 1/32
    of x's bytes in bfloat16), then ``rglru_scan_backward`` from them,
    which rebuilds each chunk's carries from the saved inputs (h itself
    is not kept)."""

    @staticmethod
    def forward(ctx, x, log_a, h0):
        ctx.set_materialize_grads(False)
        h, h_last, ckpt = rglru_scan(x, log_a, h0, checkpoints=True)
        ctx.save_for_backward(x, log_a, ckpt)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        if not any(ctx.needs_input_grad):
            return None, None, None
        x, log_a, ckpt = ctx.saved_tensors
        dh = torch.zeros_like(x) if dh is None else dh.contiguous()
        dx, dla, dh0 = rglru_scan_backward(
            x, log_a, ckpt, dh,
            None if dh_last is None else dh_last.contiguous())
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dla if need[1] else None,
                dh0 if need[2] else None)
