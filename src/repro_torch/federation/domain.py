"""VoteDomain: the vote-layout contract as a first-class object.

(This package's own copy of ``repro.federation.domain``: numpy only,
the same identities and wire form, so domains compare across packages.)

FedKT's single round works because every party's students answer one
shared query set and their votes fold into one integer histogram.  The
histogram's layout used to be an IMPLICIT convention — (T vote units,
U classes), fixed by whichever PartyUpdate arrived first — which is
exactly what blocked mixed per-token + per-example rounds and the
vertically-partitioned scenario.  A ``VoteDomain`` makes the contract
explicit and typed:

  unit        : what one vote row IS — "example" (tabular learners: one
                row per query example) or "token" (the LM path: one row
                per query TOKEN, the flat (N*S,) layout).
  num_units   : T — how many vote rows the query set produces in this
                unit.
  num_classes : U — the class space the votes range over (vocab size on
                the token path).
  fingerprint : content hash of the query set the units index into, so
                two parties can never silently vote on DIFFERENT Xq's
                that happen to share a shape.  None means "anonymous"
                (legacy frames, hand-built updates) and matches any
                fingerprint.
  label_names : optional class-name tag (purely descriptive; rides the
                wire, never affects identity).

Identity and compatibility:

  * Two domains with different ``unit`` are DISTINCT and COEXIST — the
    aggregate keeps one running histogram per domain, so an lm party
    and an nn party share a round instead of crashing.
  * Two domains with the same ``unit`` must agree on T, U, and
    fingerprint; a same-unit mismatch is refused with an error naming
    both parties and both domains (they claim the same kind of vote
    row, so folding them together would be silently wrong).

Derivation: a learner may declare its own domain via a
``vote_domain(Xq, default_num_classes, fingerprint=None)`` hook
(core.learners.LMLearner does — the token path); every other learner
gets the example domain with U taken from its own ``num_classes`` when
it has one, else the session default (``cfg.num_classes``).  See
docs/engines.md "Vote domains" for the custom-learner contract.

This module is imported from core/ and federation/ both, so it depends
on nothing but numpy and the standard library.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

UNITS = ("example", "token")


def fingerprint_queries(Xq) -> str:
    """Content hash of a query set: shape, dtype, and raw bytes.  Two
    parties voting on Xq's that differ in ANY element get different
    fingerprints, even at identical shapes."""
    X = np.ascontiguousarray(np.asarray(Xq))
    h = hashlib.blake2b(digest_size=8)
    h.update(repr((X.shape, X.dtype.str)).encode())
    h.update(X.tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class VoteDomain:
    """One vote-layout contract: (unit, T, U) plus the query-set
    fingerprint the units index into."""
    unit: str                      # "example" | "token"
    num_units: int                 # T — vote rows
    num_classes: int               # U — class space
    fingerprint: Optional[str] = None   # None = anonymous (legacy)
    label_names: Optional[Tuple[str, ...]] = field(default=None,
                                                   compare=False)

    def __post_init__(self):
        if self.unit not in UNITS:
            raise ValueError(f"unknown vote unit {self.unit!r}; "
                             f"expected one of {UNITS}")
        if self.num_units < 1 or self.num_classes < 1:
            raise ValueError(f"degenerate vote domain: T="
                             f"{self.num_units}, U={self.num_classes}")

    @property
    def key(self) -> Tuple[str, int, int, Optional[str]]:
        """Identity for histogram keying (label_names excluded — it is
        a descriptive tag, not part of the layout contract)."""
        return (self.unit, self.num_units, self.num_classes,
                self.fingerprint)

    @property
    def ident(self) -> str:
        """Short stable id string — sorts deterministically, keys the
        session's per-domain meta blocks."""
        fp = self.fingerprint or "anon"
        return f"{self.unit}:T{self.num_units}:U{self.num_classes}:{fp}"

    def describe(self) -> str:
        """Human-readable form for error messages."""
        fp = self.fingerprint[:8] if self.fingerprint else "anonymous"
        return (f"{self.unit}-unit domain (T={self.num_units} vote "
                f"rows x U={self.num_classes} classes, queries {fp})")

    def matches(self, other: "VoteDomain") -> bool:
        """True when ``other`` names the same layout.  An anonymous
        fingerprint (None) on EITHER side matches any fingerprint —
        legacy frames declare no query hash but are otherwise checked
        in full."""
        if (self.unit, self.num_units, self.num_classes) != \
                (other.unit, other.num_units, other.num_classes):
            return False
        return (self.fingerprint is None or other.fingerprint is None
                or self.fingerprint == other.fingerprint)

    # -- wire form --------------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        """JSON-able header form (codec: rides next to learner_kind)."""
        d: Dict[str, Any] = {"unit": self.unit,
                             "num_units": int(self.num_units),
                             "num_classes": int(self.num_classes),
                             "fingerprint": self.fingerprint}
        if self.label_names is not None:
            d["label_names"] = list(self.label_names)
        return d

    @classmethod
    def from_wire(cls, d: Optional[Dict[str, Any]]
                  ) -> Optional["VoteDomain"]:
        """Inverse of ``to_wire``; None (absent header field — a
        legacy frame) stays None, the "undeclared" domain the aggregate
        infers from the party's binding."""
        if d is None:
            return None
        names = d.get("label_names")
        return cls(unit=d["unit"], num_units=int(d["num_units"]),
                   num_classes=int(d["num_classes"]),
                   fingerprint=d.get("fingerprint"),
                   label_names=tuple(names) if names is not None
                   else None)


def example_domain(Xq, num_classes: int, *,
                   fingerprint: Optional[str] = None,
                   label_names: Optional[Tuple[str, ...]] = None
                   ) -> VoteDomain:
    """One vote row per query example."""
    return VoteDomain(unit="example", num_units=int(len(Xq)),
                      num_classes=int(num_classes),
                      fingerprint=(fingerprint if fingerprint is not None
                                   else fingerprint_queries(Xq)),
                      label_names=label_names)


def token_domain(num_tokens: int, vocab_size: int, *,
                 fingerprint: Optional[str] = None) -> VoteDomain:
    """One vote row per query TOKEN (the LM path's flat (N*S,)
    layout).  Anonymous by default: the callers that hold the concrete
    query tokens attach the fingerprint."""
    return VoteDomain(unit="token", num_units=int(num_tokens),
                      num_classes=int(vocab_size),
                      fingerprint=fingerprint)


def learner_domain(student_learner, Xq, default_num_classes: int, *,
                   fingerprint: Optional[str] = None) -> VoteDomain:
    """The vote domain ONE party's students produce over ``Xq``.

    A learner that declares ``vote_domain(Xq, default_num_classes,
    fingerprint=None)`` owns its layout outright (LMLearner: token
    unit, T = N*S, U = vocab).  Every other learner votes one row per
    example with U from its own ``num_classes`` field when present,
    else the session default — in every shipped configuration the two
    agree, so the homogeneous paths are unchanged.

    ``fingerprint=None`` hashes Xq here; pass a precomputed hash when
    deriving many domains over one query set (the aggregate does).
    """
    if hasattr(student_learner, "vote_domain"):
        return student_learner.vote_domain(Xq, default_num_classes,
                                           fingerprint=fingerprint)
    u = getattr(student_learner, "num_classes", None)
    return example_domain(Xq, u if u is not None else default_num_classes,
                          fingerprint=fingerprint)


def check_same_unit(a: VoteDomain, b: VoteDomain, *, party_a, party_b
                    ) -> None:
    """The coexistence rule: same-unit domains must be identical.
    Raises naming both parties and both domains; different units pass
    (they fold into separate histograms)."""
    if a.unit == b.unit and not a.matches(b):
        raise ValueError(
            f"vote-domain clash: party {party_a} votes in a "
            f"{a.describe()} but party {party_b} votes in a "
            f"{b.describe()} — same vote unit, different layout; "
            f"refusing to fold them into one histogram")
