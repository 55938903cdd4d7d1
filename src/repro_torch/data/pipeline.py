"""Data pipeline: batching, shuffling, party splits for the LM path
(``repro.data.pipeline``).

Host-side (numpy) pipeline feeding device batches — deterministic,
seeded, with Dirichlet party partitioning from ``core/partition``.  The
same seed gives the reference's batches, in the same order.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.partition import dirichlet_partition


class TokenDataset:
    """(N, S+1) token matrix -> batches of {tokens, labels} (next-token)."""

    def __init__(self, seqs: np.ndarray, seed: int = 0):
        assert seqs.ndim == 2
        self.seqs = seqs.astype(np.int32)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.seqs)

    def batches(self, batch_size: int, steps: Optional[int] = None,
                labels: Optional[np.ndarray] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite (or ``steps``-bounded) shuffled batch stream.  If
        ``labels`` is given (distillation), they replace the shifted
        next-token labels."""
        n, produced = len(self.seqs), 0
        while steps is None or produced < steps:
            order = self.rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                seq = self.seqs[idx]
                if labels is not None:
                    yield {"tokens": seq[:, :-1], "labels": labels[idx]}
                else:
                    yield {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
                produced += 1
                if steps is not None and produced >= steps:
                    return


def party_token_datasets(seqs: np.ndarray, num_parties: int, beta: float,
                         seed: int = 0) -> List[TokenDataset]:
    """Dirichlet-heterogeneous split of sequences by their dominant token
    class (a proxy label so 'label skew' is meaningful for LM data)."""
    parts = dirichlet_partition(sequence_proxy_labels(seqs), num_parties,
                                beta, seed)
    return [TokenDataset(seqs[ix], seed + i) for i, ix in enumerate(parts)]


def sequence_proxy_labels(seqs: np.ndarray) -> np.ndarray:
    """Per-sequence proxy class (first token mod 10) so the Dirichlet
    'label skew' partition is meaningful for LM data."""
    return (seqs[:, 0] % 10).astype(np.int32)


def lm_session_data(train: np.ndarray, public: np.ndarray,
                    test: np.ndarray) -> Dict[str, np.ndarray]:
    """Token splits in the FedKTSession data schema.

    X_* are (N, S+1) int32 sequence matrices (an "example" is a
    sequence); ``y_train`` carries the proxy classes the partitioner
    skews over — the same proxy ``party_token_datasets`` uses.
    ``y_test`` is the flat next-token target stream matching
    ``LMLearner.predict``'s (N*S,) layout, making the session's
    ``accuracy`` metric next-token accuracy.
    """
    train = np.asarray(train, np.int32)
    test = np.asarray(test, np.int32)
    return {"X_train": train,
            "y_train": sequence_proxy_labels(train),
            "X_public": np.asarray(public, np.int32),
            "X_test": test,
            "y_test": test[:, 1:].reshape(-1)}
