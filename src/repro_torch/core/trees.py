"""Histogram tree learners on tensors: random forest and GBDT.

The counterpart of ``repro.core.trees``.  Trees are complete binary
trees in heap layout:

  split_feat/split_bin : (2^depth - 1,)  internal nodes
  leaf                 : (2^depth, C)    class scores / regression values

Where the reference ``vmap``s a single-tree fit over trees and forests,
every fit here is batched on a leading axis: G trees over Gf feature
sets (a forest's T trees share its binned rows).  Each depth level
builds the histograms of all G trees in ONE ``ops.tree_hist`` call —
one CUDA launch on the card — and each leaf build is one more.  A
serial fit is the batch of one, so stacked and serial fits run the same
code.  The ``lax.scan`` over boosting rounds is a Python loop.

Split scores keep the reference's layout, (node, feature, bin)
flattened, and ``torch.argmax`` returns the first maximum as
``jnp.argmax`` does, so gini ties resolve the same way.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops

NUM_BINS = 32
NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------
def make_bins(X: np.ndarray, num_bins: int = NUM_BINS) -> np.ndarray:
    """Per-feature quantile bin edges: (F, num_bins - 1)."""
    qs = np.linspace(0, 100, num_bins + 1)[1:-1]
    return np.percentile(X, qs, axis=0).T.astype(np.float32)


def binize(X, edges) -> torch.Tensor:
    """X: (..., N, F) -> int32 bins (..., N, F) in [0, num_bins).

    bin = #{edges e : x >= e}: a per-feature searchsorted of the values,
    transposed to (..., F, N), against the sorted edges (..., F, B-1)."""
    xt = X.transpose(-1, -2).contiguous()
    b = torch.searchsorted(edges.contiguous(), xt, right=True,
                           out_int32=True)
    return b.transpose(-1, -2).contiguous()


def _rows_of(xb, per):
    """Index that maps each of G = Gf * per trees to its forest's rows."""
    return torch.arange(xb.shape[0] * per, device=xb.device) // per


def _descend(xb, node, bf, bb, forest):
    """One level of routing: node -> 2 * node + (x[f_node] > b_node).
    xb (Gf, N, F); node, bf/bb gathered per sample, (G, N)."""
    f_n = torch.gather(bf, 1, node.long())
    b_n = torch.gather(bb, 1, node.long())
    N = xb.shape[1]
    x = xb[forest[:, None], torch.arange(N, device=xb.device)[None],
           f_n.long()]
    return 2 * node + (x > b_n).to(torch.int32)


def _best_split(score, num_bins):
    """Flat (feature, bin) argmax per node: score (G, n, F, B)."""
    G, n = score.shape[:2]
    flat = torch.argmax(score.reshape(G, n, -1), dim=2)
    return ((flat // num_bins).to(torch.int32),
            (flat % num_bins).to(torch.int32))


# ---------------------------------------------------------------------------
# Classification trees (gini)
# ---------------------------------------------------------------------------
def fit_trees_gini(xb, y, w, feat_mask, *, depth, num_classes,
                   num_bins=NUM_BINS):
    """G gini trees, batched.  xb: (Gf, N, F) int32 bins; y: (Gf, N)
    labels; w: (G, N) f32 sample weights (bootstrap counts, zero on
    padding rows); feat_mask: (G, F) f32 in {0, 1}.  Tree g fits on the
    rows of forest g // (G // Gf).  Returns (split_feat, split_bin,
    leaf) with a leading G axis."""
    Gf, N, Fn = xb.shape
    G = w.shape[0]
    per = G // Gf
    C = num_classes
    dev = xb.device
    forest = _rows_of(xb, per)
    n_internal = 2 ** depth - 1
    split_feat = torch.zeros((G, n_internal), dtype=torch.int32, device=dev)
    split_bin = torch.zeros((G, n_internal), dtype=torch.int32, device=dev)
    node = torch.zeros((G, N), dtype=torch.int32, device=dev)
    # class-masked sample weights: channel c holds w where y == c, so a
    # single tree_hist emits the (node, feature, bin, class) counts
    onehot = F.one_hot(y.long(), C).to(torch.float32).transpose(1, 2)
    wc = (onehot[forest] * w[:, None, :]).contiguous()      # (G, C, N)

    for level in range(depth):
        n_nodes = 2 ** level
        base = n_nodes - 1
        hist = ops.tree_hist(xb, node, wc, num_nodes=n_nodes,
                             num_bins=num_bins)
        hist = hist.permute(0, 2, 3, 4, 1)                  # (G,n,F,B,C)
        left = torch.cumsum(hist, dim=3)                    # bin <= b
        total = left[:, :, :, -1:, :]
        right = total - left
        ln = left.sum(-1)
        rn = right.sum(-1)
        gini_l = ln - (left ** 2).sum(-1) / torch.clamp_min(ln, 1e-9)
        gini_r = rn - (right ** 2).sum(-1) / torch.clamp_min(rn, 1e-9)
        score = -(gini_l + gini_r)                          # maximize
        # last bin => empty right split; mask it and masked features
        score[:, :, :, -1] = NEG_INF
        score = torch.where(feat_mask[:, None, :, None] > 0, score,
                            torch.full_like(score, NEG_INF))
        bf, bb = _best_split(score, num_bins)
        split_feat[:, base:base + n_nodes] = bf
        split_bin[:, base:base + n_nodes] = bb
        node = _descend(xb, node, bf, bb, forest)

    # leaves: class histograms
    leaf = ops.node_hist(node, wc,
                         num_nodes=2 ** depth).transpose(1, 2)  # (G, L, C)
    leaf = leaf / torch.clamp_min(leaf.sum(-1, keepdim=True), 1e-9)
    return split_feat, split_bin, leaf


def fit_tree_gini(xb, y, w, feat_mask, *, depth, num_classes,
                  num_bins=NUM_BINS):
    """One gini tree (the reference's single fit): xb (N, F) int32
    bins; y (N,) labels; w (N,) f32 sample weights; feat_mask (F,) f32
    in {0, 1}.  Returns (split_feat, split_bin, leaf), the batched fit
    at a stack of one."""
    tree = fit_trees_gini(xb[None], y[None], w[None], feat_mask[None],
                          depth=depth, num_classes=num_classes,
                          num_bins=num_bins)
    return tuple(a[0] for a in tree)


def tree_apply(tree, xb):
    """Leaf rows of every sample under every tree.  tree: (split_feat
    (G, I), split_bin (G, I), leaf (G, L, C)); xb: (Gf, N, F) with G a
    multiple of Gf.  Returns (G, N, C)."""
    split_feat, split_bin, leaf = tree
    G = leaf.shape[0]
    N = xb.shape[1]
    depth = int(np.log2(leaf.shape[1]))
    forest = _rows_of(xb, G // xb.shape[0])
    node = torch.zeros((G, N), dtype=torch.int32, device=xb.device)
    for level in range(depth):
        base = 2 ** level - 1
        bf = split_feat[:, base:base + 2 ** level]
        bb = split_bin[:, base:base + 2 ** level]
        node = _descend(xb, node, bf, bb, forest)
    idx = node.long()[:, :, None].expand(G, N, leaf.shape[2])
    return torch.gather(leaf, 1, idx)


# ---------------------------------------------------------------------------
# Random forest
# ---------------------------------------------------------------------------
def fit_forest(xb, y, w, fm, *, depth, num_classes, num_bins=NUM_BINS):
    """One forest (the reference's ``vmap`` of ``fit_tree_gini``): xb
    (N, F) bins shared by its T trees; w (T, N) per-tree sample weights;
    fm (T, F) feature masks.  Returns (split_feat, split_bin, leaf) with
    a leading T axis."""
    return fit_trees_gini(xb[None], y[None], w, fm, depth=depth,
                          num_classes=num_classes, num_bins=num_bins)


def fit_forest_stacked(X, edges, y, w, fm, *, depth, num_classes,
                       num_bins=NUM_BINS):
    """k forests of T trees as one batched fit.  X: (k, M, F) f32 rows
    padded to a shared bucket M; edges: (k, F, num_bins-1); y: (k, M);
    w: (k, T, M); fm: (k, T, F).  Padding rows ride at w == 0 and add
    exact zeros to every histogram and leaf.  Returns (split_feat,
    split_bin, leaf) shaped (k, T, ...)."""
    k, T = w.shape[:2]
    xb = binize(X, edges)
    sf, sb, leaf = fit_trees_gini(
        xb, y, w.reshape(k * T, -1), fm.reshape(k * T, -1), depth=depth,
        num_classes=num_classes, num_bins=num_bins)
    return (sf.reshape(k, T, -1), sb.reshape(k, T, -1),
            leaf.reshape(k, T, *leaf.shape[1:]))


def _forest_probs(forests, xb):
    """Mean leaf rows of k forests: forests shaped (k, T, ...), xb
    (k, N, F).  Trees are summed one after another, in tree order, so
    every device adds in the same order."""
    k, T = forests[2].shape[:2]
    flat = tuple(a.reshape(k * T, *a.shape[2:]) for a in forests)
    probs = tree_apply(flat, xb).reshape(k, T, xb.shape[1], -1)
    acc = probs[:, 0]
    for t in range(1, T):
        acc = acc + probs[:, t]
    return acc / T


def predict_forest_stacked(forests, X, edges):
    """(k,) stacked forests on one shared X (N, F) -> (k, N) int32."""
    k = edges.shape[0]
    xb = binize(X.expand(k, *X.shape), edges)
    return torch.argmax(_forest_probs(forests, xb), dim=-1).to(torch.int32)


@dataclass(frozen=True)
class RandomForest:
    num_trees: int = 20
    depth: int = 6
    num_classes: int = 2
    feature_frac: float = 0.7

    def bootstrap(self, key, N, F):
        """Per-tree bootstrap weights (T, N) and feature masks (T, F) as
        float32 numpy arrays, drawn at the TRUE dataset size N with the
        reference's draws: a (T, N) randint histogrammed per tree, and a
        (T, F) uniform below ``feature_frac`` (feature 0 always on)."""
        kb, kf = prng.split(key)
        idx = prng.randint(kb, (self.num_trees, N), 0, N).astype(np.int64)
        rows = np.arange(self.num_trees, dtype=np.int64)[:, None] * N
        w = np.bincount((rows + idx).ravel(),
                        minlength=self.num_trees * N)
        w = w.reshape(self.num_trees, N).astype(np.float32)
        fm = (prng.uniform(kf, (self.num_trees, F))
              < self.feature_frac).astype(np.float32)
        fm[:, 0] = 1.0
        return w, fm


# ---------------------------------------------------------------------------
# GBDT (binary, logistic loss, XGBoost-style gains)
# ---------------------------------------------------------------------------
def fit_trees_gh(xb, g, h, *, depth, num_bins=NUM_BINS, lam=1.0):
    """G regression trees on gradients/hessians, batched: xb (G, N, F),
    g/h (G, N).  Returns tree arrays with scalar leaves (G, 2^depth, 1)."""
    G, N, Fn = xb.shape
    dev = xb.device
    forest = torch.arange(G, device=dev)
    n_internal = 2 ** depth - 1
    split_feat = torch.zeros((G, n_internal), dtype=torch.int32, device=dev)
    split_bin = torch.zeros((G, n_internal), dtype=torch.int32, device=dev)
    node = torch.zeros((G, N), dtype=torch.int32, device=dev)
    gh_w = torch.stack([g, h], dim=1).contiguous()          # (G, 2, N)

    for level in range(depth):
        n_nodes = 2 ** level
        base = n_nodes - 1
        gh = ops.tree_hist(xb, node, gh_w, num_nodes=n_nodes,
                           num_bins=num_bins)               # (G,2,n,F,B)
        Gs, Hs = gh[:, 0], gh[:, 1]
        GL, HL = torch.cumsum(Gs, 3), torch.cumsum(Hs, 3)
        GT, HT = GL[..., -1:], HL[..., -1:]
        GR, HR = GT - GL, HT - HL
        gain = GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam) \
            - GT ** 2 / (HT + lam)
        gain[..., -1] = NEG_INF
        bf, bb = _best_split(gain, num_bins)
        split_feat[:, base:base + n_nodes] = bf
        split_bin[:, base:base + n_nodes] = bb
        node = _descend(xb, node, bf, bb, forest)

    GHs = ops.node_hist(node, gh_w, num_nodes=2 ** depth)
    leaf = (-GHs[:, 0] / (GHs[:, 1] + lam))[:, :, None]
    return split_feat, split_bin, leaf


def fit_tree_gh(xb, g, h, *, depth, num_bins=NUM_BINS, lam=1.0):
    """One regression tree on gradients/hessians (the reference's
    single fit): xb (N, F), g/h (N,).  Returns tree arrays with scalar
    leaves (2^depth, 1), the batched fit at a stack of one."""
    tree = fit_trees_gh(xb[None], g[None], h[None], depth=depth,
                        num_bins=num_bins, lam=lam)
    return tuple(a[0] for a in tree)


def fit_gbdt(xb, y, w, lr, *, num_rounds, depth, num_bins=NUM_BINS):
    """One GBDT's boosting loop (the reference's single fit): xb (N, F)
    bins, y (N,), w (N,) masks the gradients/hessians.  Returns
    (split_feat, split_bin, leaf) stacked over rounds (R, ...)."""
    trees = _boost(xb[None], y[None], w[None], lr, num_rounds=num_rounds,
                   depth=depth, num_bins=num_bins)
    return tuple(a[0] for a in trees)


def fit_gbdt_stacked(X, edges, y, w, lr, *, num_rounds, depth,
                     num_bins=NUM_BINS):
    """k GBDTs as one batched fit.  X: (k, M, F) rows padded to a shared
    bucket; edges: (k, F, num_bins-1); y: (k, M); w: (k, M) masks the
    gradients/hessians, zero on padding rows, so padding never changes
    a split or leaf.  Returns (split_feat, split_bin, leaf) shaped
    (k, num_rounds, ...)."""
    return _boost(binize(X, edges), y, w, lr, num_rounds=num_rounds,
                  depth=depth, num_bins=num_bins)


def _boost(xb, y, w, lr, *, num_rounds, depth, num_bins):
    """The boosting loop of k GBDTs on binned rows xb (k, M, F)."""
    yf = y.to(torch.float32)
    lr = torch.tensor(lr, dtype=torch.float32, device=xb.device)
    logits = torch.zeros(yf.shape, dtype=torch.float32, device=xb.device)
    rounds = []
    for _ in range(num_rounds):
        # in float64, rounded once: the CPU's vectorised and scalar-tail
        # float32 sigmoids can differ by an ulp, which would make a row's
        # g/h depend on the row count (stacked vs serial fits)
        p = torch.sigmoid(logits.to(torch.float64)).to(torch.float32)
        tree = fit_trees_gh(xb, (p - yf) * w, (p * (1.0 - p)) * w,
                            depth=depth, num_bins=num_bins)
        logits = logits + lr * tree_apply(tree, xb)[..., 0]
        rounds.append(tree)
    return tuple(torch.stack([t[i] for t in rounds], dim=1)
                 for i in range(3))


def _gbdt_logits(trees, xb, lr):
    """Summed round outputs of k GBDTs (rounds in order) times lr:
    trees shaped (k, R, ...), xb (k, N, F)."""
    k, R = trees[2].shape[:2]
    flat = tuple(a.reshape(k * R, *a.shape[2:]) for a in trees)
    vals = tree_apply(flat, xb)[..., 0].reshape(k, R, xb.shape[1])
    acc = vals[:, 0]
    for r in range(1, R):
        acc = acc + vals[:, r]
    return lr * acc


def predict_gbdt_stacked(trees, X, edges, lr):
    """(k,) stacked GBDTs on one shared X (N, F) -> (k, N) int32."""
    k = edges.shape[0]
    xb = binize(X.expand(k, *X.shape), edges)
    lr = torch.tensor(lr, dtype=torch.float32, device=xb.device)
    return (_gbdt_logits(trees, xb, lr) > 0).to(torch.int32)


@dataclass(frozen=True)
class GBDT:
    num_rounds: int = 30
    depth: int = 6
    learning_rate: float = 0.3
    num_classes: int = 2  # binary only
