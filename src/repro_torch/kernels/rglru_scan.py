"""Wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The counterpart of ``repro.kernels.rglru_scan.rglru_scan``: the linear
recurrence h_t = exp(log_a_t) * h_{t-1} + x_t along the sequence axis
with a float32 carry, each (batch, channel) walked in order, so h and
h_last equal the plain version bit for bit.  Any S and D: the C
launcher stages time through TMA where the layout allows (rows of D
elements a multiple of 16 bytes) and loads element by element where it
does not; the plan (tile, ring, shared memory) lives in the .cu alone.
h_last is float32, as the reference's off-TPU paths (its xla scan, its
decode step and ``ref.rglru_scan_ref``) return it and its model state
carries it; the TPU kernel rounds it to x's dtype (ROADMAP §3).  CUDA
tensors only; ``ops.rglru`` runs the plain version
(``ref.rglru_scan_ref``) for CPU tensors and for the decode step.

``launches`` counts the kernel launches this process made, so a run
can show that its prefills went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
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


def rglru_scan(x, log_a, h0):
    """x, log_a: (B, S, D) CUDA tensors of one dtype (float32 or
    bfloat16), contiguous; h0: (B, D) float32.  Returns (h (B, S, D) in
    x's dtype, h_last (B, D) float32)."""
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
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), log_a.data_ptr(), h0.data_ptr(),
                 h.data_ptr(), h_last.data_ptr(), B, S, D,
                 int(x.dtype == torch.bfloat16), stream)
    build.check(err, "rglru_scan")
    launches += 1
    return h, h_last
