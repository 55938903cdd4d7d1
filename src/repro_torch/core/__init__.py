"""FedKT's algorithm: partitioning, privacy accounting, voting, trees
and the learners."""
