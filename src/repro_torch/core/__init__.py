"""FedKT's algorithm: partitioning, privacy accounting, voting, trees
and the learners."""
from repro_torch.core.voting import consistent_vote, teacher_vote  # noqa: F401
