"""Server: the aggregator side of the FedKT protocol (Algorithm 1
lines 13-23; ``repro.federation.server``).

Folds the arriving PartyUpdates into a ``StreamingVoteAggregate``, then
noises, argmaxes, and distills the final model from the voted labels.
The server owns the L1 accounting; L2 accounting composes the parties'
local gap traces (Thm 4), folded per arrival.
"""
from __future__ import annotations

from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.federation.aggregate import StreamingVoteAggregate
from repro_torch.federation.engines import Engine, LoopEngine


class Server:
    def __init__(self, cfg: FedKTConfig, student_learner, final_learner,
                 *, bindings=None):
        """``bindings`` (party_id -> ResolvedBinding): each arriving
        update folds under THAT party's student learner and engine."""
        self.cfg = cfg
        self.student_learner = student_learner
        self.final_learner = final_learner
        self.bindings = bindings

    def make_aggregate(self, X_public, num_queries: int,
                       engine: Engine = None, *,
                       retain_students: bool = True
                       ) -> StreamingVoteAggregate:
        return StreamingVoteAggregate(
            self.cfg, self.student_learner, engine or LoopEngine(),
            X_public[:num_queries], retain_students=retain_students,
            bindings=self.bindings)

    def finalize_all(self, key, agg: StreamingVoteAggregate):
        """Per-domain finalize: each domain gets its own noise split, in
        sorted-identity order; the final model distills from the primary
        domain.  Returns (final_state, primary VoteResult,
        {domain.ident -> VoteResult}, key), split for split as the
        reference."""
        votes = {}
        for dom in agg.domains():
            key, kk = prng.split(key)
            votes[dom.ident] = agg.finalize_domain(dom, kk)
        primary = agg.primary_domain(self.final_learner)
        vote = votes[primary.ident]
        key, kk = prng.split(key)
        final_state = self.final_learner.fit(kk, agg.Xq,
                                             vote.labels.cpu().numpy())
        return final_state, vote, votes, key
