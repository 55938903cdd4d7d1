"""Wire-level types of the FedKT protocol (``repro.federation.messages``).

  PartyUpdate : party -> server, ONCE.  The party's s student states
                plus the clean vote-gap trace the L2 accountant needs.
  TokenLabels : the vote ANSWER as a message (one int32 per query unit).
  RoundResult : server -> caller.  Final model, accounting, metrics.

Leaves may be tensors (any device), numpy arrays, or ``ShapeDtype``
stand-ins that price a message from shapes alone.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree_util import tree_leaves

LABEL_BYTES = 4   # int32 vote labels — the server->party query answer unit


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf known by shape and numpy dtype only (abstract pricing)."""
    shape: Tuple[int, ...]
    dtype: Any


def leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return int(leaf.numel() * leaf.element_size())
    return (int(np.prod(leaf.shape, dtype=np.int64))
            * np.dtype(leaf.dtype).itemsize)


def pytree_bytes(tree: Any) -> int:
    """On-the-wire size of a state (sum of array leaf bytes)."""
    return int(sum(leaf_nbytes(leaf) for leaf in tree_leaves(tree)
                   if hasattr(leaf, "shape") and hasattr(leaf, "dtype")))


def label_wire_bytes(num_queries: int) -> int:
    """Cost of shipping vote labels for ``num_queries`` public examples."""
    return num_queries * LABEL_BYTES


@dataclass
class PartyUpdate:
    """Everything a party sends to the server in the single round:
    its s student states, the concatenated clean vote gaps, its local
    size, the STUDENT learner kind and its declared VoteDomain."""
    party_id: int
    student_states: List[Any]          # s trained student states
    vote_gaps: np.ndarray              # concat clean top-2 gaps (L2 acct)
    num_examples: int                  # local dataset size (for metrics)
    learner_kind: Optional[str] = None  # student-learner family name
    domain: Optional[Any] = None       # declared VoteDomain (or None)
    meta: Dict[str, Any] = field(default_factory=dict)

    def wire_bytes(self) -> int:
        """Payload bytes: the s student states PLUS the vote-gap trace
        (the codec's framed size adds only the header)."""
        return pytree_bytes(self.student_states) + pytree_bytes(self.vote_gaps)


@dataclass
class TokenLabels:
    """One partition-ensemble's voted labels for the public queries."""
    party_id: int
    labels: Any                        # int32 voted labels
    meta: Dict[str, Any] = field(default_factory=dict)

    def wire_bytes(self) -> int:
        return pytree_bytes(self.labels)


@dataclass
class RoundResult:
    """Outcome of one FedKT round, as produced by FedKTSession;
    ``by_domain`` breaks it down per vote domain (one entry in a
    single-domain round)."""
    final_state: Any
    accuracy: float
    student_states: List[List[Any]]    # [party][partition] -> state
    epsilon: Optional[float] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    by_domain: Dict[str, Dict[str, Any]] = field(default_factory=dict)
