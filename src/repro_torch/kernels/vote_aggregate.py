"""Wrapper of the CUDA vote-aggregation kernel (``csrc/vote_aggregate.cu``).

The counterpart of ``repro.kernels.vote_aggregate.vote_aggregate``:
per query, the noisy max-vote label with its top-2 scores and the clean
top-2 of the same counts, from one pass that never materialises the
(T, U) histogram, bit for bit the plain version's.  The C launcher
picks the layout: a thread per query for a few classes (the round's
U = 2), a CTA per query streaming the noise row for a vocabulary-sized
U (the token vote).  CUDA tensors only; ``ops.votes`` runs the plain
version (``ref.vote_aggregate_plain``) for CPU tensors.

``launches`` counts the kernel launches this process made, so a run
can show that its votes went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("vote_aggregate")
    fn = lib.vote_aggregate_launch
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def _check(t, name, dtype, shape, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"vote_aggregate: {name} must be on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"vote_aggregate: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"vote_aggregate: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"vote_aggregate: {name} must be contiguous")


def vote_aggregate(preds, noise, *, num_classes):
    """preds: (M, T) int32 CUDA tensor; noise: (T, U) float32 or None
    (adds 0.0).  Returns (labels (T,) int32, top1, top2, clean_top1,
    clean_top2 (T,) float32)."""
    global launches
    if preds.dim() != 2:
        raise ValueError(f"vote_aggregate: preds must be (M, T), got "
                         f"{tuple(preds.shape)}")
    M, T = preds.shape
    U = int(num_classes)
    dev = preds.device
    _check(preds, "preds", torch.int32, (M, T), dev)
    if noise is not None:
        _check(noise, "noise", torch.float32, (T, U), dev)
    labels = torch.empty((T,), dtype=torch.int32, device=dev)
    outs = [torch.empty((T,), dtype=torch.float32, device=dev)
            for _ in range(4)]
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(preds.data_ptr(),
                 noise.data_ptr() if noise is not None else None,
                 labels.data_ptr(), *(o.data_ptr() for o in outs),
                 M, T, U, stream)
    build.check(err, "vote_aggregate")
    launches += 1
    return (labels, *outs)
