"""Per-party learner/engine bindings (``repro.federation.bindings``).

A ``PartyBinding`` is what a single party brings to the session: its
teacher learner, its student learner and its engine.  The homogeneous
shorthand ``FedKTSession(learner, data, cfg, engine=...)`` resolves to
ONE binding shared by every party.  The only cross-party contract is the
vote DOMAIN (federation/domain.py) each binding derives from its
student learner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.federation.domain import VoteDomain, learner_domain
from repro_torch.federation.engines import Engine, get_engine

# Learner kind names by class name, so decoded updates can be validated
# by name alone.  The kind a PartyUpdate declares is that of its STUDENT
# learner — the model the server must run to fold the party's votes.
_KIND_BY_CLASS: Dict[str, str] = {
    "NNLearner": "nn",
    "RFLearner": "rf",
    "GBDTLearner": "gbdt",
    "LMLearner": "lm",
}


def register_learner_kind(cls_name: str, kind: str) -> None:
    """Names a learner class for wire-level kind validation (a custom
    learner only needs this if it wants a kind shorter than its class
    name)."""
    _KIND_BY_CLASS[cls_name] = kind


def registered_learner_kinds() -> List[str]:
    """Every wire-level learner kind the registry knows, sorted — what
    a CLI prints when a roster names a kind it cannot build."""
    return sorted(set(_KIND_BY_CLASS.values()))


def learner_kind(learner: Any) -> str:
    """Short kind name for a learner instance ("nn" | "rf" | "gbdt" |
    "lm" | a registered kind | the lowercased class name for
    unregistered learners)."""
    name = type(learner).__name__
    return _KIND_BY_CLASS.get(name, name.lower())


@dataclass(frozen=True)
class PartyBinding:
    """What ONE party brings to a FedKT session: its teacher learner,
    its student learner (defaults to the teacher learner) and its
    engine ("loop" | "vmap" | an Engine, or None for the session's)."""
    learner: Any
    student_learner: Any = None
    engine: Any = None

    def resolve(self, default_engine="loop") -> "ResolvedBinding":
        return ResolvedBinding(
            learner=self.learner,
            student_learner=self.student_learner or self.learner,
            engine=get_engine(self.engine if self.engine is not None
                              else default_engine))


@dataclass(frozen=True)
class ResolvedBinding:
    """A PartyBinding with every default filled in."""
    learner: Any
    student_learner: Any
    engine: Engine

    @property
    def kind(self) -> str:
        return learner_kind(self.student_learner)

    def domain(self, Xq, default_num_classes: int, *,
               fingerprint=None) -> VoteDomain:
        """The VoteDomain this party's student votes fold under."""
        return learner_domain(self.student_learner, Xq,
                              default_num_classes,
                              fingerprint=fingerprint)


def resolve_bindings(learner_or_bindings: Any, *, student_learner=None,
                     engine="loop", num_parties: int,
                     final_learner: Optional[Any] = None):
    """One shared binding from the homogeneous shorthand, or one per
    party from an explicit sequence.  Returns (bindings, final_learner);
    the final learner defaults to the first binding's teacher learner."""
    if isinstance(learner_or_bindings, (list, tuple)):
        if student_learner is not None:
            raise ValueError(
                "student_learner= is the homogeneous shorthand; with "
                "per-party bindings, set each PartyBinding's "
                "student_learner instead")
        if len(learner_or_bindings) != num_parties:
            raise ValueError(
                f"got {len(learner_or_bindings)} party bindings for "
                f"cfg.num_parties={num_parties}")
        bindings = []
        for i, b in enumerate(learner_or_bindings):
            if not isinstance(b, PartyBinding):
                raise TypeError(f"binding {i} is {type(b).__name__}, "
                                f"expected PartyBinding")
            bindings.append(b.resolve(default_engine=engine))
    else:
        if learner_or_bindings is None:
            raise ValueError("FedKTSession needs a learner or a "
                             "sequence of PartyBinding")
        shared = PartyBinding(learner_or_bindings,
                              student_learner=student_learner).resolve(
                                  default_engine=engine)
        bindings = [shared] * num_parties
    final = final_learner or bindings[0].learner
    return bindings, final
