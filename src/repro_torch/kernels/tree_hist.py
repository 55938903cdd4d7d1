"""Wrapper of the CUDA tree-histogram kernel (``csrc/tree_hist.cu``).

The counterpart of ``repro.kernels.tree_hist.tree_hist``, with a
leading batch axis in place of the reference's ``vmap``: one launch
builds the histograms of every tree of a stacked level.  CUDA tensors
only; ``ops.tree_hist`` runs the plain version (``ref.tree_hist_ref``)
for CPU tensors.

``launches`` counts the kernel launches this process made, so a run
can show that its fits went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

MAX_GRID_Y = 65535

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("tree_hist")
    fn = lib.tree_hist_launch
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    fn.restype = _I
    lib.tree_hist_max_channels.restype = _I
    return fn, int(lib.tree_hist_max_channels())


def _check(t, name, dtype, ndim, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"tree_hist: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"tree_hist: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"tree_hist: {name} must have {ndim} dims, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"tree_hist: {name} must be contiguous")


def tree_hist(xb, node, w, *, num_nodes, num_bins):
    """xb: (Gf, N, F) int32 bins in [0, num_bins); node: (G, N) int32
    in [0, num_nodes); w: (G, K, N) float32, G a multiple of Gf.
    Returns (G, K, num_nodes, F, num_bins) float32."""
    global launches
    dev = xb.device
    _check(xb, "xb", torch.int32, 3, dev)
    _check(node, "node", torch.int32, 2, dev)
    _check(w, "w", torch.float32, 3, dev)
    Gf, N, F = xb.shape
    G, K, Nw = w.shape
    if tuple(node.shape) != (G, N) or Nw != N:
        raise ValueError(f"tree_hist: shapes disagree: xb {tuple(xb.shape)}, "
                         f"node {tuple(node.shape)}, w {tuple(w.shape)}")
    if Gf == 0 or G % Gf:
        raise ValueError(f"tree_hist: {G} trees do not split evenly over "
                         f"{Gf} feature sets")
    if G > MAX_GRID_Y:
        raise ValueError(f"tree_hist: {G} trees exceed one launch's "
                         f"{MAX_GRID_Y}")
    fn, max_k = _lib()
    if K > max_k:
        raise ValueError(f"tree_hist: {K} weight channels exceed the "
                         f"kernel's {max_k}")
    out = torch.empty((G, K, num_nodes, F, num_bins), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xb.data_ptr(), node.data_ptr(), w.data_ptr(),
                 out.data_ptr(), Gf, G, N, F, K, int(num_nodes),
                 int(num_bins), stream)
    build.check(err, "tree_hist")
    launches += 1
    return out
