"""Data partitioning: the paper's federation structure.

Two levels:
  1. Dirichlet(beta) heterogeneous split of the global training set into
     n parties (the paper's protocol, following Yurochkin et al.):
     for each class k, sample p_k ~ Dir_n(beta) and give party j a
     p_{k,j} fraction of class-k examples.
  2. Within a party: s partitions, each covering the whole local dataset,
     each split into t disjoint equal subsets (Algorithm 1 line 2).

Plus the VERTICAL scenario (``vertical_split``): every silo holds the
SAME samples but a disjoint slice of the feature columns (a hospital
holds labs, a bank holds transactions, keyed by the same patients).
Parties align rows by a shared sample-id vector and train
feature-masked learners (core.learners ``feature_mask=``); the vote
layout is unchanged — each party's students still emit one vote per
query example — so vertical silos ride the same (T, U) example domain
and the same one-shot protocol as horizontal ones.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dirichlet_partition(y: np.ndarray, num_parties: int, beta: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Returns per-party index arrays.  Retries until every party has at
    least ``min_size`` examples (paper's experimental practice)."""
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    for _ in range(100):
        party_idx = [[] for _ in range(num_parties)]
        for k in range(n_classes):
            idx_k = np.where(y == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet([beta] * num_parties)
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for j, part in enumerate(np.split(idx_k, cuts)):
                party_idx[j].extend(part.tolist())
        sizes = [len(ix) for ix in party_idx]
        if min(sizes) >= min_size:
            return [np.array(sorted(ix)) for ix in party_idx]
    raise RuntimeError("could not satisfy min_size partition")


def homogeneous_partition(n: int, num_parties: int,
                          seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(a) for a in np.array_split(idx, num_parties)]


def vertical_split(sample_ids: np.ndarray, num_features: int,
                   num_parties: int, seed: int = 0
                   ) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """Feature-sliced federation: n parties hold the SAME samples and
    disjoint column slices.

    ``sample_ids`` is the shared join key — each silo stores its slice
    keyed by these ids, in whatever order its own storage uses.
    Returns:

      row_order     : indices that put the samples in canonical
                      ascending-id order.  EVERY party applies this
                      order to its local rows, so row i means the same
                      sample at every silo — the alignment the vote
                      depends on (votes are summed per query row).
      feature_masks : one sorted tuple of column indices per party, a
                      seeded disjoint cover of range(num_features).
                      Tuples (not arrays) because learners carry the
                      mask as a hashable jit-static field
                      (core.learners ``feature_mask=``).

    Raises on duplicate sample ids (an ambiguous join) and on more
    parties than feature columns.
    """
    ids = np.asarray(sample_ids)
    if len(np.unique(ids)) != len(ids):
        raise ValueError("vertical_split needs unique sample ids: the "
                         "id vector is the cross-silo row join key")
    if num_parties > num_features:
        raise ValueError(f"cannot slice {num_features} feature columns "
                         f"across {num_parties} parties")
    row_order = np.argsort(ids, kind="stable")
    rng = np.random.default_rng(seed)
    cols = rng.permutation(num_features)
    feature_masks = [tuple(int(c) for c in sorted(part))
                     for part in np.array_split(cols, num_parties)]
    return row_order, feature_masks


def subsets_of_partition(local_idx: np.ndarray, num_partitions: int,
                         num_subsets: int, seed: int = 0
                         ) -> List[List[np.ndarray]]:
    """Algorithm 1 line 2: s independent shuffles of the local data, each
    cut into t disjoint subsets.  Returns [partition][subset] -> indices."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_partitions):
        perm = rng.permutation(local_idx)
        out.append([np.sort(a) for a in np.array_split(perm, num_subsets)])
    return out
