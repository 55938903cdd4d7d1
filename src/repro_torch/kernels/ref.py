"""Plain PyTorch versions of the round's two kernels.

These are the semantic ground truth beside each hand-written kernel:
small, obviously correct, memory-naive.  ``ops.py`` runs them for
tensors on the CPU; on the card the kernels run, and ``chip_smoke.py``
and the card-only tests hold each kernel against its plain version on
the same inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def vote_aggregate_ref(preds, num_classes, noise=None):
    """Teacher-ensemble max voting (``repro.kernels.ref``).

    preds: (M, T) int32 class prediction of each of M teachers for each
    of T queries.  noise: optional (T, U) float32 noise added to the
    vote histogram before the argmax.  Returns (labels (T,) int32,
    counts (T, U) int32); ties go to the first class, as jnp.argmax.
    """
    onehot = F.one_hot(preds.long(), num_classes).to(torch.int32)
    counts = onehot.sum(0, dtype=torch.int32)                   # (T, U)
    scores = counts.to(torch.float32)
    if noise is not None:
        scores = scores + noise.to(torch.float32)
    labels = torch.argmax(scores, dim=-1).to(torch.int32)
    return labels, counts


def top2_of(scores, argmax_labels):
    """(top1, top2) with only the argmax POSITION masked, so exact ties
    give top2 == top1 (top_k semantics; ``_top2_of`` in the
    reference's ops.py)."""
    top1 = scores.max(dim=-1).values
    pos = F.one_hot(argmax_labels.long(), scores.shape[-1]).bool()
    masked = scores.masked_fill(pos, NEG_INF)
    return top1, masked.max(dim=-1).values


def vote_aggregate_plain(preds, num_classes, noise=None):
    """The five outputs of the vote kernel, computed plainly: one-hot
    sum, argmax, then the top-2 masking.  Returns (labels, top1, top2,
    clean_top1, clean_top2) — the noisy argmax and its top-2 plus the
    pre-noise top-2 of the same histogram."""
    clean_labels, counts = vote_aggregate_ref(preds, num_classes)
    cf = counts.to(torch.float32)
    c1, c2 = top2_of(cf, clean_labels)
    if noise is None:
        return clean_labels, c1, c2, c1, c2
    scores = cf + noise.to(torch.float32)
    labels = torch.argmax(scores, dim=-1).to(torch.int32)
    top1, top2 = top2_of(scores, labels)
    return labels, top1, top2, c1, c2


def _hist64(xb, node, w, num_nodes, num_bins):
    """The one-hot contraction of ``tree_hist_ref`` in float64."""
    Gf, N, Fn = xb.shape
    G, K, _ = w.shape
    per = G // Gf
    onehot_n = F.one_hot(node.long(), num_nodes).to(torch.float64)
    ncw = w.to(torch.float64)[:, :, None, :] \
        * onehot_n.transpose(1, 2)[:, None]                 # (G, K, n, N)
    onehot_b = F.one_hot(xb.long(), num_bins).to(torch.float64)
    h = torch.bmm(ncw.reshape(Gf, per * K * num_nodes, N),
                  onehot_b.reshape(Gf, N, Fn * num_bins))
    return h.reshape(G, K, num_nodes, Fn, num_bins)


def tree_hist_ref(xb, node, w, num_nodes, num_bins):
    """Weighted (channel, node, feature, bin) histograms of G trees.

    xb: (Gf, N, F) int32 binned features, shared by the G // Gf trees of
    each forest (Gf == G when every tree has its own rows); node: (G, N)
    int32 tree position of each sample; w: (G, K, N) float32 channel
    weights.  Returns (G, K, num_nodes, F, num_bins) float32:

        hist[g, k, n, f, b] = sum_i w[g, k, i] [node[g, i] == n]
                                               [xb[g // (G/Gf), i, f] == b]

    — the einsum "gki,gin,gifb->gknfb" of one-hots, contracted as one
    batched matmul per forest.  It accumulates in float64 and rounds
    once to float32, so a cell's value does not depend on the matmul's
    summation order, and so not on the zero-weight padding a stacked
    fit adds: stacked fits equal serial fits on this path too.
    """
    return _hist64(xb, node, w, num_nodes, num_bins).to(torch.float32)


def node_hist_ref(node, w, num_nodes):
    """Weighted per-node histograms (G, K, num_nodes): ``tree_hist_ref``
    with the node id as the single feature and the nodes as its bins."""
    return tree_hist_ref(node[:, :, None], torch.zeros_like(node), w, 1,
                         num_nodes)[:, :, 0, 0, :]


def tree_hist_f32_error(got, xb, node, w, num_nodes, num_bins):
    """How far a float32 histogram ``got`` is from the exact sums, in
    units of what float32 summation can explain.

    A float32 sum of a cell's m nonzero terms, in any order, is within
    gamma(m - 1) * sum |w| of the exact sum, gamma(j) = j*u / (1 - j*u)
    with u = 2^-24 (plus 2^-52 for the float64 yardstick's own
    rounding): zero for a cell of one term.  Returns (max |got - exact|,
    the largest ratio of a cell's error to its limit) — the ratio is at
    most 1 for any float32 accumulation and far above it for one held in
    bfloat16 or float16 (0/0 counts as 0, x/0 as inf)."""
    exact = _hist64(xb, node, w, num_nodes, num_bins)
    mass = _hist64(xb, node, w.abs(), num_nodes, num_bins)
    terms = _hist64(xb, node, (w != 0).to(w.dtype), num_nodes, num_bins)
    ju = (terms - 1).clamp_min(0) * (2.0 ** -24 + 2.0 ** -52)
    limit = ju / (1 - ju) * mass
    err = (got.to(torch.float64) - exact).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    return float(err.max()), float(ratio.max())
