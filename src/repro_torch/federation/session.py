"""FedKTSession: drives the paper's single communication round
(``repro.federation.session``).

    session = FedKTSession(RFLearner(num_classes=2), data, cfg,
                           engine="vmap")          # on the card
    result = session.run()                         # RoundResult

The session decides the round's device: ``device="cuda"`` (the default)
or ``"cpu"``, and every learner of the round (each binding's teacher and
student learner, and the final learner) is placed there.  Asking for
CUDA where there is none raises; nothing falls back to the CPU.  On the
card every teacher vote runs the CUDA vote kernel and every tree level
the CUDA histogram kernel; on the CPU their plain versions run.

Every transport's updates fold through the SAME
``StreamingVoteAggregate``: a transport with ``streams = True`` (socket)
folds per arrival, the others fold the finished list.

Seed contract: party keys are precomputed from the serial schedule
(``party_starting_keys``), and every draw of the round uses the
threefry port, so a round at a given ``cfg.seed`` consumes the same
random bits as the reference's round, through any transport: the vote
histogram is an integer sum, so arrival order cannot change it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as D
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import accuracy
from repro_torch.core.partition import dirichlet_partition
from repro_torch.federation.bindings import ResolvedBinding, resolve_bindings
from repro_torch.federation.engines import get_engine
from repro_torch.federation.messages import RoundResult
from repro_torch.federation.party import Party, query_budget
from repro_torch.federation.server import Server
from repro_torch.federation.transport import get_transport

__all__ = ["FedKTSession", "party_starting_keys", "query_budget"]


def party_starting_keys(parties, seed: int):
    """Every party's starting key (the serial loop's split positions,
    played forward without training) plus the key the server side
    continues from."""
    key = prng.PRNGKey(seed)
    keys = []
    for party in parties:
        keys.append(key)
        key = party.advance_key(key)
    return keys, key


def _placed(learner, dev: torch.device):
    """The learner with its ``device`` set to the round's device."""
    if dataclasses.is_dataclass(learner) and any(
            f.name == "device" for f in dataclasses.fields(learner)):
        return dataclasses.replace(learner, device=str(dev))
    return learner


class FedKTSession:
    """One FedKT round over in-process array data.

    learner: a single Learner (every party gets the same binding) OR a
        sequence of ``bindings.PartyBinding``, one per party.
    data: dict with X_train/y_train/X_public/X_test/y_test arrays.
    engine: "loop" | "vmap" | an engines.Engine instance.
    final_learner: trains on the server's voted labels; defaults to the
        (first binding's) teacher learner.
    transport: "inprocess" | "thread" | "subprocess" | "socket" | a
        transport instance — where the party rounds run and how their
        updates cross the party/server boundary.  Pass a
        ``net.SocketTransport(...)`` instance to set the fleet knobs
        (deadline_s, min_parties, journal, chaos plan).
    parallelism: worker count for the fan-out transports.
    retain_students: False drops each update after it is folded
        (constant server memory in the party count).
    device: where the round runs: "cuda" (default) or "cpu".
    """

    def __init__(self, learner, data: Dict[str, np.ndarray],
                 cfg: FedKTConfig, *, student_learner=None,
                 final_learner=None, engine="loop", party_indices=None,
                 transport="inprocess", parallelism=None,
                 retain_students=True, device=D.DEFAULT):
        self.device = D.resolve(device)
        bindings, final = resolve_bindings(
            learner, student_learner=student_learner, engine=engine,
            num_parties=cfg.num_parties, final_learner=final_learner)
        self.bindings = [ResolvedBinding(
            learner=_placed(b.learner, self.device),
            student_learner=_placed(b.student_learner, self.device),
            engine=b.engine) for b in bindings]
        self.final_learner = _placed(final, self.device)
        self.learner = self.bindings[0].learner
        self.student_learner = self.bindings[0].student_learner
        self.data = data
        self.cfg = cfg
        self.engine = get_engine(engine)
        self.transport = get_transport(transport, parallelism)
        self.retain_students = retain_students

        ytr = data["y_train"]
        if party_indices is None:
            party_indices = dirichlet_partition(ytr, cfg.num_parties,
                                                cfg.beta, cfg.seed)
        self.parties = [
            Party(party_id=i, X=data["X_train"], y=ytr, indices=ix,
                  cfg=cfg, learner=b.learner,
                  student_learner=b.student_learner, engine=b.engine)
            for i, (ix, b) in enumerate(zip(party_indices,
                                            self.bindings))]
        self.server = Server(cfg, self.student_learner,
                             self.final_learner,
                             bindings=dict(enumerate(self.bindings)))
        self.tq_party, self.tq_server = query_budget(cfg,
                                                     len(data["X_public"]))

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def run(self, verbose: bool = False) -> RoundResult:
        cfg = self.cfg
        Xpub = self.data["X_public"]
        party_keys, key = party_starting_keys(self.parties, cfg.seed)
        agg = self.server.make_aggregate(
            Xpub, self.tq_server, self.engine,
            retain_students=self.retain_students)

        streaming = getattr(self.transport, "streams", False)

        def fold(upd):
            agg.add(upd)
            if verbose:
                print(f"party {upd.party_id}: {upd.num_examples} "
                      f"examples, {upd.meta['num_teachers']} teachers "
                      f"trained, {upd.meta['encoded_bytes']} wire bytes")

        t0 = self._clock()
        # engine=None: every party runs under its OWN bound engine
        if streaming:
            # the server folds each update the moment it arrives; party
            # training and aggregation overlap, so "parties" time IS the
            # whole collect-and-fold phase
            for upd in self.transport.stream_round(
                    self.parties, party_keys, Xpub, self.tq_party, None):
                fold(upd)
            t_parties = self._clock() - t0
            t0 = self._clock()
        else:
            updates = self.transport.run_round(
                self.parties, party_keys, Xpub, self.tq_party, None)
            t_parties = self._clock() - t0
            t0 = self._clock()
            for upd in updates:
                fold(upd)
        final_state, vote, votes, key = self.server.finalize_all(key, agg)
        t_server = self._clock() - t0

        acc = accuracy(self.final_learner, final_state,
                       self.data["X_test"], self.data["y_test"])
        by_domain: Dict[str, Dict[str, Any]] = {}
        for dom in agg.domains():
            v = votes[dom.ident]
            by_domain[dom.ident] = {
                "domain": dom,
                "vote": v,
                "labels": v.labels.cpu().numpy(),
                "epsilon": agg.epsilon(v),
                "parties": agg.domain_parties(dom),
                "student_states": agg.student_states_for(dom),
            }
        # privacy composes across domains by max
        dom_eps = [row["epsilon"] for row in by_domain.values()
                   if row["epsilon"] is not None]
        eps = max(dom_eps) if dom_eps else None

        engine_names = sorted({b.engine.name for b in self.bindings})
        meta: Dict[str, Any] = {
            "party_sizes": [p.num_examples for p in self.parties],
            "engine": (engine_names[0] if len(engine_names) == 1
                       else "mixed"),
            "party_bindings": [{"learner": b.kind,
                                "engine": b.engine.name}
                               for b in self.bindings],
            "transport": self.transport.name,
            "parallelism": getattr(self.transport, "parallelism", None),
            "device": str(self.device),
            "queries": {"party": self.tq_party, "server": self.tq_server},
            "seconds": {"parties": round(t_parties, 3),
                        "server": round(t_server, 3)},
            "wire_bytes": agg.wire_meta(),
            # the digest of each arrived party's frame as the server
            # received it: equal digests across transports are equal
            # bytes on the wire
            "frame_sha256": {pid: row["frame_sha256"] for pid, row in
                             sorted(agg.party_meta().items())},
            "num_updates": agg.num_parties,
        }
        if streaming:
            report = dict(self.transport.round_report)
            meta["socket"] = report
            # dropout accounting: stragglers excluded from the vote
            meta["dropped_parties"] = report.get("dropped", [])
        return RoundResult(final_state=final_state, accuracy=acc,
                           student_states=agg.student_states(),
                           epsilon=eps, meta=meta, by_domain=by_domain)
