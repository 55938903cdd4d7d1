"""Data-dependent privacy accounting for FedKT (paper §4 + Appendix A).

Implements:
  - Lemma 7   : q >= Pr[M(d) != o*] bound from the clean vote gaps
  - Thm 5/6   : per-query moment bounds for a (2*g, 0)-DP mechanism
  - Thm 1/2   : FedKT-L1 party-level accounting  (sensitivity 2s)
  - Thm 3/4   : FedKT-L2 example-level accounting (sensitivity 2),
                parallel composition across parties (max_i eps_i)
  - Thm 8     : composability across queries + tail-bound conversion to
                (eps, delta)
  - advanced composition (Dwork et al.) for the paper's §B.7 comparison
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

LAMBDAS = np.arange(1, 129, dtype=np.float64)


def lemma7_q(gaps: np.ndarray, gamma: float,
             num_classes: int) -> np.ndarray:
    """Per-query bound on q = Pr[M(d) != o*].

    gaps: (T,) top1-top2 clean vote gap per query.  The exact lemma sums
    over all o != o*; with only the top-2 gap available we use the valid
    upper bound (u-1) terms at the smallest gap.  Clipped to [0, 1].
    """
    g = np.maximum(np.asarray(gaps, np.float64), 0.0)
    per = (2.0 + gamma * g) / (4.0 * np.exp(gamma * g))
    return np.clip((num_classes - 1) * per, 0.0, 1.0)


def lemma7_q_exact(counts: np.ndarray, gamma: float) -> np.ndarray:
    """Exact Lemma-7 bound given full clean histograms (T, U)."""
    c = np.asarray(counts, np.float64)
    vmax = c.max(axis=1, keepdims=True)
    gaps = vmax - c                                  # (T, U), 0 at o*
    term = (2.0 + gamma * gaps) / (4.0 * np.exp(gamma * gaps))
    # zero out the o* term (gap==0 col contributes where c==vmax once)
    is_star = (c == vmax)
    # ensure only one argmax column removed per row
    first_star = np.cumsum(is_star, axis=1) == 1
    star = is_star & first_star
    q = term.sum(axis=1) - term[star].reshape(len(c), -1)[:, 0]
    return np.clip(q, 0.0, 1.0)


def per_query_moments(q: np.ndarray, eps0: float,
                      lambdas: np.ndarray = LAMBDAS) -> np.ndarray:
    """Thm 2/3 (via Thm 5+6): alpha(lambda) per query for a (eps0, 0)-DP
    mechanism with outcome-stability bound q.  Returns (T, L)."""
    q = np.asarray(q, np.float64)[:, None]
    lam = lambdas[None, :]
    # Theorem 5 bound: eps0 = 2*g  =>  2 g^2 l(l+1) = eps0^2/2 * l(l+1)
    bound_dd = (eps0 ** 2 / 2.0) * lam * (lam + 1.0)
    # Theorem 6 bound (valid when q < (e^eps0 - 1)/(e^{2 eps0} - 1))
    valid = q < (np.exp(eps0) - 1.0) / (np.exp(2.0 * eps0) - 1.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = (1.0 - q) / (1.0 - np.exp(eps0) * q)
        t6 = np.log((1.0 - q) * ratio ** lam + q * np.exp(eps0 * lam))
    t6 = np.where(valid & np.isfinite(t6), t6, np.inf)
    return np.minimum(t6, bound_dd)


def moments_to_eps(alpha_total: np.ndarray, delta: float,
                   lambdas: np.ndarray = LAMBDAS) -> float:
    """Thm 8 tail bound: eps = min_l (alpha(l) + log(1/delta)) / l."""
    return float(np.min((alpha_total + np.log(1.0 / delta)) / lambdas))


def fedkt_l1_epsilon(gaps_or_counts, gamma: float, s: int,
                     num_classes: int, delta: float = 1e-5,
                     exact: bool = False) -> float:
    """Party-level eps of FedKT-L1 over the answered queries (Thm 1+2).

    The server mechanism is (2*s*gamma, 0) party-level DP per query.

    Lemma 7's q bound is evaluated on the RAW consistent-vote histogram
    with the raw noise scale: the server adds Lap(1/gamma) to counts
    that move in multiples of s, and q = Pr[noisy argmax != o*] only
    ever sees the products gamma * gap, which are invariant under
    rescaling counts and noise to "party units" (gap/s with Lap(1/(s*
    gamma))).  Party-level sensitivity enters ONLY through eps0 =
    2*s*gamma in the moment bound below — dividing the gaps by s as
    well would double-count s and loosen the bound.
    """
    if exact:
        q = lemma7_q_exact(gaps_or_counts, gamma)
    else:
        q = lemma7_q(gaps_or_counts, gamma, num_classes)
    alpha = per_query_moments(q, 2.0 * s * gamma).sum(axis=0)
    return moments_to_eps(alpha, delta)


def fedkt_l2_epsilon(per_party_gaps: Sequence[np.ndarray], gamma: float,
                     num_classes: int, delta: float = 1e-5) -> float:
    """Example-level eps of FedKT-L2 (Thm 3 per partition query set,
    Thm 4 parallel composition: max over parties).

    per_party_gaps: list over parties; each entry is the concatenated
    top-2 gaps of every query answered by that party's partitions.
    """
    eps_parties = []
    for gaps in per_party_gaps:
        if len(gaps) == 0:
            eps_parties.append(0.0)
            continue
        q = lemma7_q(np.asarray(gaps), gamma, num_classes)
        alpha = per_query_moments(q, 2.0 * gamma).sum(axis=0)
        eps_parties.append(moments_to_eps(alpha, delta))
    return float(max(eps_parties))


def advanced_composition(eps0: float, k: int, delta_slack: float) -> float:
    """(Dwork et al. 2014) k-fold advanced composition of an eps0-DP
    mechanism — the looser bound the paper compares against in §B.7."""
    return float(np.sqrt(2.0 * k * np.log(1.0 / delta_slack)) * eps0
                 + k * eps0 * (np.exp(eps0) - 1.0))
