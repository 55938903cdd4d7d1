"""Vote aggregation: the paper's Algorithm 1 math (``repro.core.voting``).

Party side  (lines 6-11): per-partition teacher ensemble max-vote, with
optional L2 Laplace noise on the histogram.
Server side (lines 14-22): consistent voting over the n*s student models
(v_m(x) = s * |{i : v^i_m(x) = s}|), with optional L1 Laplace noise.

Vote counting on the party side runs through ``kernels.ops.votes_with_
clean`` (the CUDA vote kernel for tensors on the card).  Laplace noise
comes from the threefry port (``repro_torch.prng``): the same keys give
the same uniform draws as the reference, and the log transform runs on
the votes' device.  As in the reference, a server-side function takes a
``VoteDomain`` (duck-typed: anything with ``num_classes``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops, ref


class VoteResult(NamedTuple):
    labels: torch.Tensor      # (T,) int32
    counts: Optional[torch.Tensor]  # (T, U) CLEAN counts (None on the
    #                           kernel path, which never materialises the
    #                           histogram — it emits the gap directly)
    top_gap: torch.Tensor     # (T,) f32 — clean top1 - top2 (Lemma 7)
    domain: Optional[Any] = None   # VoteDomain the vote was computed in


def laplace(key, shape, scale, device=None):
    """Laplace(0, scale) via inverse CDF of a uniform in [-0.5, 0.5),
    clipped to the SYMMETRIC interval [-0.5 + 1e-7, 0.5 - 1e-7].  The
    uniform bits equal ``jax.random.uniform``'s (drawn on ``device``:
    the token vote's noise is vocabulary-sized); ``log1p`` may differ
    from XLA's by an ulp."""
    u = prng.uniform_tensor(key, shape, -0.5, 0.5, device)
    u = torch.clamp(u, -0.5 + 1e-7, 0.5 - 1e-7)
    return (-scale * torch.sign(u)) * torch.log1p(-2.0 * torch.abs(u))


def teacher_vote(preds, num_classes, *, gamma=0.0,
                 key=None) -> VoteResult:
    """Party-side ensemble vote.  preds: (t, T) int32 teacher predictions.

    gamma > 0 adds Lap(1/gamma) to the histogram (FedKT-L2, lines 9-10).
    The noised labels and the clean Lemma-7 gap both come out of ONE
    histogram build (the vote kernel on the card)."""
    t, T = preds.shape
    noise = None
    if gamma > 0.0:
        assert key is not None
        noise = laplace(key, (T, num_classes), 1.0 / gamma, preds.device)
    labels, counts, c1, c2 = ops.votes_with_clean(preds, num_classes,
                                                  noise)
    return VoteResult(labels, counts, c1 - c2)


def token_teacher_vote(preds_bts, domain, *, gamma=0.0, key=None):
    """LM-scale party-side vote: preds (M, B, S) over a vocab-sized class
    space (U = domain.num_classes).  Returns (labels (B, S), gap (B,
    S)), the gap the CLEAN top1 - top2, as ``teacher_vote``'s.  With
    gamma > 0 the (B*S, vocab) Laplace noise is drawn on the votes'
    device and the vote kernel folds it; without noise, at a vocabulary
    over 2048, the vote is the sort path (``ops.votes_sort``)."""
    M, B, S = preds_bts.shape
    vocab = domain.num_classes
    flat = preds_bts.reshape(M, B * S)
    noise = None
    if gamma > 0.0:
        assert key is not None
        noise = laplace(key, (B * S, vocab), 1.0 / gamma, flat.device)
    labels, _, c1, c2 = ops.votes_with_clean(flat, vocab, noise)
    return labels.reshape(B, S), (c1 - c2).reshape(B, S)


def party_vote_counts(student_preds, domain, *,
                      consistent=True) -> torch.Tensor:
    """ONE party's additive contribution to the server vote histogram.

    student_preds: (s, T) int32.  Returns (T, U) int32.  Under
    consistent voting the party contributes s votes for class m iff all
    its s students predict m; otherwise each student votes
    independently.  The server histogram is the integer SUM of these
    terms, so folding updates in any order gives the same counts."""
    s, T = student_preds.shape
    if consistent:
        first = student_preds[0]
        agree = torch.all(student_preds == first[None], dim=0)
        onehot = F.one_hot(first.long(), domain.num_classes).to(torch.int32)
        return s * onehot * agree[:, None].to(torch.int32)
    _, counts = ref.vote_aggregate_ref(student_preds, domain.num_classes)
    return counts


def finalize_vote(counts, domain=None, *, gamma=0.0, key=None
                  ) -> VoteResult:
    """Noise + argmax + clean-gap bookkeeping over a finished server
    histogram.  counts: (T, U) int32 CLEAN counts."""
    scores = counts.to(torch.float32)
    if gamma > 0.0:
        assert key is not None
        scores = scores + laplace(key, tuple(counts.shape), 1.0 / gamma,
                                  counts.device)
    labels = torch.argmax(scores, dim=-1).to(torch.int32)
    top2 = torch.topk(counts.to(torch.float32), 2, dim=-1).values
    return VoteResult(labels, counts, top2[:, 0] - top2[:, 1],
                      domain=domain)


def consistent_vote(student_preds, num_classes, *, consistent=True,
                    gamma=0.0, key=None) -> VoteResult:
    """Server-side vote.  student_preds: (n, s, T) int32: the sum of
    per-party ``party_vote_counts`` terms, then ``finalize_vote``."""
    from repro_torch.federation.domain import VoteDomain
    domain = VoteDomain(unit="example",
                        num_units=int(student_preds.shape[-1]),
                        num_classes=int(num_classes))
    counts = sum(party_vote_counts(sp, domain, consistent=consistent)
                 for sp in student_preds)
    return finalize_vote(counts, domain, gamma=gamma, key=key)
