"""The vote and tree-histogram ops, dispatched on the tensors' device.

The counterpart of the vote and tree parts of ``repro.kernels.ops``.
Where the reference picks a backend by ``jax.default_backend()``, the
port dispatches on where the data lies:

  - a CUDA tensor goes to the hand-written kernel (or the kernel
    raises: there is no fallback when a build or launch fails);
  - a CPU tensor goes to the plain PyTorch version (``ref.py``).

To compare a kernel with its plain version on the card, call ``ref``
directly: nothing here runs a plain version on a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import tree_hist as _th
from repro_torch.kernels import vote_aggregate as _va


# ---------------------------------------------------------------------------
# Vote aggregation
# ---------------------------------------------------------------------------
def votes(preds, num_classes, noise=None):
    """Max-vote labels + top-2 vote scores.

    preds: (M, T) int32; noise: optional (T, U) f32.
    Returns (labels (T,) i32, top1 (T,) f32, top2 (T,) f32)."""
    if noise is None and num_classes > 2048:
        # vocabulary-scale noise-free voting: no U-sized tensors
        return votes_sort(preds)
    if preds.is_cuda:
        labels, top1, top2, _, _ = _va.vote_aggregate(
            preds, noise, num_classes=num_classes)
    else:
        labels, top1, top2, _, _ = ref.vote_aggregate_plain(
            preds, num_classes, noise)
    return labels, top1, top2


def votes_with_clean(preds, num_classes, noise=None):
    """Noisy max-vote labels + CLEAN top-2 from ONE histogram build.

    Returns (labels, counts, clean_top1, clean_top2) where ``counts`` is
    the clean histogram on the plain path and None on the kernel path
    (which never materialises it) and on the sort path."""
    if noise is None and num_classes > 2048:
        labels, top1, top2 = votes_sort(preds)
        return labels, None, top1, top2
    if preds.is_cuda:
        labels, _, _, c1, c2 = _va.vote_aggregate(
            preds, noise, num_classes=num_classes)
        return labels, None, c1, c2
    clean_labels, counts = ref.vote_aggregate_ref(preds, num_classes)
    cf = counts.to(torch.float32)
    c1, c2 = ref.top2_of(cf, clean_labels)
    if noise is None:
        return clean_labels, counts, c1, c2
    labels = torch.argmax(cf + noise, dim=-1).to(torch.int32)
    return labels, counts, c1, c2


def votes_sort(preds):
    """Vocabulary-free max voting: mode along the teacher axis via sort.

    preds: (M, T) int32.  Returns (labels, top1, top2) like ``votes``,
    at O(M log M) per query with no U-sized tensor.  Ties resolve to
    the smallest class id.  Plain PyTorch on any device: the reference
    has no Pallas kernel for it."""
    M, T = preds.shape
    s = torch.sort(preds, dim=0).values                # (M, T)
    rls = torch.empty_like(s)
    prev = torch.full((T,), -1, dtype=preds.dtype, device=preds.device)
    rl = torch.zeros((T,), dtype=s.dtype, device=preds.device)
    for m in range(M):
        # run length ending at m
        rl = torch.where(s[m] == prev, rl + 1, torch.ones_like(rl))
        rls[m] = rl
        prev = s[m]
    best = torch.argmax(rls, dim=0)                   # last index of run
    labels = torch.gather(s, 0, best[None])[0]
    top1 = rls.max(dim=0).values.to(torch.float32)
    masked = torch.where(s == labels[None], torch.zeros_like(rls), rls)
    top2 = masked.max(dim=0).values.to(torch.float32)
    return labels.to(torch.int32), top1, top2


# ---------------------------------------------------------------------------
# Tree-fit histogram
# ---------------------------------------------------------------------------
def tree_hist(xb, node, w, *, num_nodes, num_bins):
    """Weighted (channel, node, feature, bin) histograms of a stacked
    level of G trees — the per-level build inside the tree fits.

    xb: (Gf, N, F) int32 bins shared by the G // Gf trees of each forest;
    node: (G, N) int32; w: (G, K, N) f32.  Returns
    (G, K, num_nodes, F, num_bins) f32; rows at w == 0 contribute exact
    zeros (the stacked-fit padding invariant)."""
    if xb.is_cuda:
        return _th.tree_hist(xb, node, w, num_nodes=num_nodes,
                             num_bins=num_bins)
    return ref.tree_hist_ref(xb, node, w, num_nodes, num_bins)


def node_hist(node, w, *, num_nodes):
    """Weighted per-node histograms — the leaf builds of the tree fits.

    node: (G, N) int32; w: (G, K, N) f32.  Returns (G, K, num_nodes)
    f32.  The leaf build IS a tree_hist with the node id as the single
    feature and the leaves as its bins."""
    out = tree_hist(node[:, :, None].contiguous(), torch.zeros_like(node),
                    w, num_nodes=1, num_bins=num_nodes)
    return out[:, :, 0, 0, :]
