"""Server-side aggregation: fold PartyUpdates as they arrive
(``repro.federation.aggregate``).

``StreamingVoteAggregate`` consumes each update: the party's students
answer the query set once, their consistent-vote contribution is ADDED
into the running histogram of the party's VOTE DOMAIN, the per-party
accounting scalars are folded, and the update can be dropped.  Integer
addition commutes, so any arrival order gives the same histograms,
labels, accuracy and epsilon.  A same-unit layout clash, a declared
domain that contradicts the binding, or a declared learner kind that
contradicts it, is refused naming the parties involved.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import FedKTConfig
from repro_torch.core import privacy as P
from repro_torch.core.voting import VoteResult, finalize_vote
from repro_torch.federation import codec
from repro_torch.federation.bindings import learner_kind
from repro_torch.federation.domain import (VoteDomain, check_same_unit,
                                           fingerprint_queries,
                                           learner_domain)
from repro_torch.federation.messages import (LABEL_BYTES, PartyUpdate,
                                             ShapeDtype, TokenLabels)


class _DomainFold:
    """One domain's running state: its histogram, its L2 terms, and the
    parties that vote in it (first arrival kept for error messages)."""

    def __init__(self, domain: VoteDomain, first_pid: int,
                 first_kind: str):
        self.domain = domain
        self.counts = None               # (T, U) int32 running histogram
        self.l2_eps: Dict[int, float] = {}  # party_id -> Thm 3 epsilon
        self.parties: List[int] = []
        self.first = {"pid": first_pid, "kind": first_kind}


class StreamingVoteAggregate:
    """Running consistent-vote histograms + round accounting; one
    instance per round.  ``bindings`` maps party_id -> ResolvedBinding,
    so each update folds under THAT party's student learner and engine."""

    def __init__(self, cfg: FedKTConfig, student_learner, engine, Xq, *,
                 retain_students: bool = True, bindings=None):
        self.cfg = cfg
        self.student_learner = student_learner
        self.engine = engine
        self.Xq = Xq
        self.retain_students = retain_students
        self.bindings = dict(bindings) if bindings else {}
        self._fp = fingerprint_queries(Xq)
        self._folds: Dict[Any, _DomainFold] = {}  # domain.key -> fold
        self._students: Dict[int, Any] = {}
        self._meta: Dict[int, Dict[str, Any]] = {}

    def _binding_for(self, pid: int, update: PartyUpdate):
        b = self.bindings.get(pid)
        lrn = b.student_learner if b is not None else self.student_learner
        eng = b.engine if b is not None else self.engine
        bound_kind = learner_kind(lrn)
        if update.learner_kind is not None \
                and update.learner_kind != bound_kind:
            raise ValueError(
                f"party {pid} declares learner kind "
                f"{update.learner_kind!r} but the session binds "
                f"{bound_kind!r} for it — refusing to fold states "
                f"under the wrong learner")
        return lrn, eng, bound_kind

    def expected_domain(self, student_learner) -> VoteDomain:
        return learner_domain(student_learner, self.Xq,
                              self.cfg.num_classes, fingerprint=self._fp)

    def _check_declared(self, pid: int, kind: str, expected: VoteDomain,
                        declared: Optional[VoteDomain]) -> None:
        if declared is not None and not expected.matches(declared):
            raise ValueError(
                f"vote-domain mismatch: party {pid} ({kind}) declares a "
                f"{declared.describe()} on the wire, but its session "
                f"binding derives a {expected.describe()} — refusing "
                f"to fold an update that voted in a different domain")

    def _check_contrib(self, pid: int, kind: str, dom: VoteDomain,
                       contrib) -> None:
        shape = tuple(int(d) for d in contrib.shape)
        if shape != (dom.num_units, dom.num_classes):
            raise ValueError(
                f"party {pid} ({kind}) contributes vote counts of "
                f"shape {shape}, expected (T={dom.num_units}, "
                f"num_classes={dom.num_classes}) — the {dom.describe()}")

    def _fold_for(self, pid: int, kind: str, dom: VoteDomain
                  ) -> _DomainFold:
        fold = self._folds.get(dom.key)
        if fold is None:
            for other in self._folds.values():
                check_same_unit(other.domain, dom,
                                party_a=other.first["pid"], party_b=pid)
            fold = self._folds[dom.key] = _DomainFold(dom, pid, kind)
        return fold

    # -- folding ----------------------------------------------------------
    def add(self, update: PartyUpdate) -> None:
        """Folds one party's update into its domain's running histogram."""
        pid = int(update.party_id)
        if pid in self._meta:
            raise ValueError(f"duplicate update from party {pid}")
        lrn, eng, kind = self._binding_for(pid, update)
        dom = self.expected_domain(lrn)
        self._check_declared(pid, kind, dom, update.domain)
        contrib = eng.student_vote_counts(
            lrn, update.student_states, self.Xq, dom,
            consistent=self.cfg.consistent_voting)
        self._check_contrib(pid, kind, dom, contrib)
        fold = self._fold_for(pid, kind, dom)
        fold.counts = contrib if fold.counts is None \
            else fold.counts + contrib
        fold.parties.append(pid)
        if self.cfg.privacy_level == "L2":
            fold.l2_eps[pid] = P.fedkt_l2_epsilon(
                [np.asarray(update.vote_gaps)], self.cfg.gamma,
                dom.num_classes)
        if self.retain_students:
            self._students[pid] = update.student_states
        nlabels = int(update.meta["num_query_labels"])
        self._meta[pid] = {
            "learner_kind": kind,
            "domain": dom.ident,
            "num_examples": int(update.num_examples),
            "encoded_bytes": int(update.meta["encoded_bytes"]),
            "payload_bytes": int(update.wire_bytes()),
            "frame_sha256": update.meta.get("frame_sha256"),
            "num_query_labels": nlabels,
            "labels_framed": codec.labels_encoded_nbytes(TokenLabels(
                party_id=pid, labels=ShapeDtype((nlabels,), np.int32))),
        }

    # -- results ----------------------------------------------------------
    @property
    def num_parties(self) -> int:
        return len(self._meta)

    @property
    def party_ids(self) -> List[int]:
        return sorted(self._meta)

    def domains(self) -> List[VoteDomain]:
        """Every domain that received an update, sorted by identity."""
        return [self._folds[k].domain for k in
                sorted(self._folds, key=lambda k: self._folds[k]
                       .domain.ident)]

    def _sole_fold(self) -> _DomainFold:
        if not self._folds:
            raise ValueError("no party updates were aggregated")
        if len(self._folds) > 1:
            raise ValueError(
                f"round holds {len(self._folds)} vote domains "
                f"({[f.domain.ident for f in self._folds.values()]}); "
                f"use the per-domain API (finalize_domain/counts_for)")
        return next(iter(self._folds.values()))

    def _fold_of(self, domain: VoteDomain) -> _DomainFold:
        fold = self._folds.get(domain.key)
        if fold is None:
            raise ValueError(f"no updates arrived in the "
                             f"{domain.describe()}")
        return fold

    @property
    def counts(self):
        """The single-domain round's running (T, U) int32 histogram."""
        return self._sole_fold().counts

    def counts_for(self, domain: VoteDomain):
        """One domain's running (T, U) int32 histogram."""
        return self._fold_of(domain).counts

    def domain_parties(self, domain: VoteDomain) -> List[int]:
        return sorted(self._fold_of(domain).parties)

    def primary_domain(self, final_learner) -> VoteDomain:
        """The domain the final model distills from: the one the final
        learner itself would vote in, else the first by identity."""
        doms = self.domains()
        if not doms:
            raise ValueError("no party updates were aggregated")
        if len(doms) == 1:
            return doms[0]
        want = self.expected_domain(final_learner)
        for d in doms:
            if d.key == want.key:
                return d
        for d in doms:
            if d.unit == want.unit:
                return d
        return doms[0]

    def finalize_domain(self, domain: VoteDomain, key) -> VoteResult:
        """Noise + argmax over ONE domain's finished histogram."""
        fold = self._fold_of(domain)
        gamma = self.cfg.gamma if self.cfg.privacy_level == "L1" else 0.0
        return finalize_vote(fold.counts, fold.domain, gamma=gamma,
                             key=key)

    def finalize(self, key) -> VoteResult:
        """The single-domain round's finalize."""
        return self.finalize_domain(self._sole_fold().domain, key)

    def epsilon(self, vote: VoteResult) -> Optional[float]:
        """Data-dependent (eps, delta=1e-5) bound for the configured
        privacy level; None under L0.  An anonymous vote resolves
        against the sole fold."""
        fold = (self._fold_of(vote.domain) if vote.domain is not None
                else self._sole_fold())
        cfg = self.cfg
        if cfg.privacy_level == "L1":
            return P.fedkt_l1_epsilon(vote.counts.cpu().numpy(), cfg.gamma,
                                      cfg.num_partitions,
                                      fold.domain.num_classes, exact=True)
        if cfg.privacy_level == "L2":
            return float(max(fold.l2_eps.values()))
        return None

    def student_states(self) -> List[List[Any]]:
        return [self._students[pid] for pid in self.party_ids] \
            if self.retain_students else []

    def student_states_for(self, domain: VoteDomain) -> Dict[int, Any]:
        if not self.retain_students:
            return {}
        return {pid: self._students[pid]
                for pid in self.domain_parties(domain)}

    def wire_meta(self) -> Dict[str, Any]:
        """The session's wire_bytes block, summed over arrived parties."""
        rows = self._meta
        by_kind: Dict[str, int] = {}
        by_domain: Dict[str, int] = {}
        for r in rows.values():
            k = r["learner_kind"]
            by_kind[k] = by_kind.get(k, 0) + r["encoded_bytes"]
            d = r["domain"]
            by_domain[d] = by_domain.get(d, 0) + r["encoded_bytes"]
        return {
            "updates": sum(r["encoded_bytes"] for r in rows.values()),
            "updates_payload": sum(r["payload_bytes"]
                                   for r in rows.values()),
            "labels": sum(r["num_query_labels"]
                          for r in rows.values()) * LABEL_BYTES,
            "labels_framed": sum(r["labels_framed"]
                                 for r in rows.values()),
            "per_party": {pid: rows[pid]["encoded_bytes"]
                          for pid in sorted(rows)},
            "by_learner_kind": by_kind,
            "by_domain": by_domain,
        }

    def party_meta(self) -> Dict[int, Dict[str, Any]]:
        """Per-party accounting scalars, keyed by party id."""
        return {pid: dict(row) for pid, row in self._meta.items()}
