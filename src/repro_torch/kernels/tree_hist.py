"""Wrapper of the CUDA tree-histogram kernel (``csrc/tree_hist.cu``).

The counterpart of ``repro.kernels.tree_hist.tree_hist``, with a
leading batch axis in place of the reference's ``vmap``: one launch
builds the histograms of every tree of a stacked level.  CUDA tensors
only; ``ops.tree_hist`` runs the plain version (``ref.tree_hist_ref``)
for CPU tensors.

``launches`` counts the kernel launches this process made, so a run
can show that its fits went through the kernel; one call is one launch,
though the CUDA launcher runs two kernels (the per-chunk partial
histograms, then their combine) when a tree's rows span several chunks.
``plan`` is the launch's plan, computed here so that the scratch for
the partials is allocated by the wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

CHUNK_MIN, CHUNK_MAX = 256, 2048  # rows a chunk: 2 n B, a power of 2
WARP_HIST = 12288    # floats of one warp's histogram window: 48 KB
CTA_HIST = 24576     # floats of a CTA's histograms: 96 KB, two CTAs an SM
MAX_WARPS = 8        # features (warps) a CTA
MAX_GRID_X = 2 ** 31 - 1   # trees x chunks
MAX_GRID_Y = 65535         # feature groups

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("tree_hist")
    fn = lib.tree_hist_launch
    fn.argtypes = [_P] * 5 + [_I] * 11 + [_P]
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


def _pow2(x):
    return 1 << max(0, int(x) - 1).bit_length()


def plan(N, F, K, num_nodes, num_bins):
    """The launch plan: (chunk, chunks, window, warps, groups).

    A tree's N rows are cut into ``chunks`` chunks of ``chunk`` rows at
    fixed row indices from 0; the chunk size depends on the key space
    n * B only (never on N or the number of trees), so a serial fit and
    a stacked fit sum each cell in the same order.  Each warp keeps a
    histogram of ``window`` fused keys (node * B + bin) for all K
    channels in shared memory; ``warps`` features share a CTA, and
    ``groups`` CTAs cover the F features."""
    keys = num_nodes * num_bins
    chunk = min(CHUNK_MAX, max(CHUNK_MIN, 2 * _pow2(keys)))
    chunks = -(-N // chunk)
    window = max(1, min(keys, WARP_HIST // max(K, 1)))
    most = max(1, min(MAX_WARPS, CTA_HIST // (max(K, 1) * window)))
    groups = -(-F // most) if F else 0
    warps = -(-F // groups) if F else 1
    return chunk, chunks, window, warps, groups


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
    n, B = int(num_nodes), int(num_bins)
    fn, max_k = _lib()
    if K > max_k:
        raise ValueError(f"tree_hist: {K} weight channels exceed the "
                         f"kernel's {max_k}")
    chunk, chunks, window, warps, groups = plan(N, F, K, n, B)
    if G * chunks > MAX_GRID_X or groups > MAX_GRID_Y:
        raise ValueError(f"tree_hist: {G} trees x {chunks} chunks of "
                         f"{chunk} rows exceed one launch's {MAX_GRID_X}, "
                         f"or {groups} feature groups its {MAX_GRID_Y}")
    out = torch.empty((G, K, n, F, B), dtype=torch.float32, device=dev)
    part = (torch.empty((G, chunks, K, n, F, B), dtype=torch.float32,
                        device=dev) if chunks > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xb.data_ptr(), node.data_ptr(), w.data_ptr(),
                 out.data_ptr(), 0 if part is None else part.data_ptr(),
                 Gf, G, N, F, K, n, B, chunk, chunks, window, warps,
                 stream)
    build.check(err, "tree_hist")
    launches += 1
    return out
