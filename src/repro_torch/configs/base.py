"""FedKT hyper-parameters: the counterpart of ``repro.configs.base``'s
``FedKTConfig``, a frozen dataclass with the same fields and defaults."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FedKTConfig:
    """FedKT algorithm hyper-parameters (paper notation)."""
    num_parties: int = 10            # n
    num_partitions: int = 2          # s
    num_subsets: int = 5             # t
    num_classes: int = 10            # u
    consistent_voting: bool = True
    privacy_level: str = "L0"        # "L0" | "L1" | "L2"
    gamma: float = 0.0               # Laplace scale is 1/gamma (0 = no noise)
    query_fraction: float = 1.0      # fraction of D_aux queried (DP budget)
    beta: float = 0.5                # Dirichlet concentration for partition
    seed: int = 0
