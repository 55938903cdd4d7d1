"""The attention, recurrence, vote and tree-histogram ops, dispatched
on the tensors' device.

The counterpart of ``repro.kernels.ops``.  Where the reference picks a
backend by ``jax.default_backend()``, the port dispatches on where the
data lies:

  - a CUDA tensor goes to the hand-written kernel (or the kernel
    raises: there is no fallback when a build or launch fails);
  - a CPU tensor goes to the plain PyTorch version (``ref.py``);
  - a meta tensor, where a CUDA tensor would launch a kernel, goes to
    ``meta.py``: empty outputs of the right shape and dtype, and the
    kernel's work added to the dry-run's tally.  Where the card takes
    the plain path (a decode step), so does meta.

The plain paths on the card are the decode steps: attention's (one
query row, or per-row offsets) and the recurrences' (S == 1), which the
reference also computes outside its kernels (``repro/kernels/ops.py``
``attention``, ``rglru``, ``wkv``).  To compare a kernel with its
plain version on the card, call ``ref`` directly: nothing here runs a
plain version in place of a kernel on a CUDA tensor.

Gradients: a CUDA attention call that needs one (grad mode on and an
input that requires it) runs ``flash_attention.FlashAttention``, the
forward kernel and the hand-written backward: at q_offset 0, over Sq =
Skv, or over Sq != Skv when non-causal (an encoder-decoder's cross
attention).  The recurrence kernels
have no backward yet (ROADMAP §2, N2), so a CUDA ``rglru`` or ``wkv``
call that needs a gradient raises rather than return a tensor that
would silently cut it; on the CPU the plain versions stay
differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import meta, ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import tree_hist as _th
from repro_torch.kernels import vote_aggregate as _va
from repro_torch.kernels import wkv6 as _wk

NEG_INF = ref.NEG_INF      # the plain paths' masked-score value


# ---------------------------------------------------------------------------
# Attention  (model layout: q (B, Sq, H, dh), k/v (B, Skv, KV, dh))
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
    """Softmax attention.

    ``q_offset`` is the absolute position of q[:, 0]: an int, or a (B,)
    integer tensor of per-row offsets (continuous-batching decode, where
    each batch row is a stream at its own position).  Per-row offsets
    need Sq == 1.  On a CUDA tensor a prefill (Sq > 1, an int offset)
    launches the flash-attention kernel; a decode takes the plain path,
    as in the reference.  A CPU tensor takes the plain path."""
    per_row = torch.is_tensor(q_offset) and q_offset.dim() == 1
    if per_row and q.shape[1] != 1:
        raise NotImplementedError(
            "per-row q_offset is only supported for single-token decode "
            f"(Sq == 1); got Sq={q.shape[1]}")
    if q.is_cuda and q.shape[1] > 1:
        if _needs_grad(q, k, v):
            if int(q_offset) != 0 or (causal and k.shape[1] != q.shape[1]):
                raise NotImplementedError(
                    "attention backward on the card covers training calls "
                    "only: q_offset 0, and Sq == Skv unless causal=False "
                    "(cross attention)")
            return _fa.FlashAttention.apply(q, k, v, bool(causal),
                                            int(window), float(softcap))
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=int(q_offset))
    if q.is_meta and q.shape[1] > 1:
        return meta.attention(q, k, v, causal=causal, window=window,
                              q_offset=int(q_offset))
    return ref.attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name, *tensors):
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP §2, N2: "
            f"the K4/K5 backward kernels), so a training call on the card "
            f"would cut the gradient here; train recurrent archs on the CPU "
            f"or run this call without gradients")


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------
def rglru(x, log_a, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + x_t.  x, log_a: (B, S, D) of one
    dtype; h0: (B, D) float32 or None (zeros).  Returns (h (B, S, D) in
    x's dtype, h_last (B, D) float32).  On a CUDA tensor a prefill
    (S > 1) launches the scan kernel; the decode step (S == 1) takes the
    plain formula, as in the reference.  A CPU tensor takes the plain
    path."""
    B, S, D = x.shape
    if h0 is None:
        h0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    if x.is_cuda and S > 1:
        _no_backward("rglru", x, log_a, h0)
        return _rg.rglru_scan(x, log_a, h0)
    if x.is_meta and S > 1:
        return meta.rglru(x, log_a, h0)
    return ref.rglru_scan_ref(x, log_a, h0)


# ---------------------------------------------------------------------------
# RWKV-6 WKV  (model layout: r/k/v/w (B, S, H, dh))
# ---------------------------------------------------------------------------
def wkv(r, k, v, w, u, s0=None):
    """RWKV-6 recurrence.  r, k, v, w: (B, S, H, dh) of one dtype; u:
    (H, dh); s0: (B, H, dh, dh) float32 or None (zeros).  Returns (o (B,
    S, H, dh) in r's dtype, s_last (B, H, dh, dh) float32).  On a CUDA
    tensor a prefill (S > 1) launches the WKV kernel; the decode step
    takes the plain formula, as in the reference.  A CPU tensor takes
    the plain path."""
    B, S, H, dh = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                         device=r.device)
    if r.is_cuda and S > 1:
        _no_backward("wkv", r, k, v, w, u, s0)
        return _wk.wkv6(r, k, v, w, u, s0)
    if r.is_meta and S > 1:
        return meta.wkv(r, k, v, w, u, s0)
    return ref.wkv6_ref(r, k, v, w, u, s0)


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
