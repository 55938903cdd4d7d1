"""Cross-silo federation launcher: one FedKT round over real sockets
(``repro.launch.federate``).

Three roles, sharing one seeded setup (data, partition, key schedule),
so a round split across OS processes — or hosts — reproduces the
in-process session seed-for-seed:

  local        : the whole fleet on this host.  FedKTSession with the
                 socket transport; parties are simulated on a thread
                 pool and deliver over localhost TCP.

  coordinator  : the server side only (``SocketTransport(spawn=False)``).
                 Binds host:port and waits for remote parties, folding
                 each arriving update into the streaming vote aggregate;
                 proceeds at quorum when the deadline passes.

  party        : one silo.  Rebuilds ITS shard and starting key from
                 the shared seed, runs the local round, ships the one
                 PartyUpdate to the coordinator (connect retries with
                 exponential backoff baked in).

Crash safety: ``--journal PATH`` makes the coordinator write-ahead
journal every accepted frame (fsync'd before the ACK), and
``--resume`` replays that journal after a crash — the restarted round
refolds the already-delivered parties and waits only for the missing
ones, so no silo ever retrains because the server died.  ``--chaos``
(with ``--chaos-seed``) runs the local fleet through a seeded
fault-injection proxy — corrupted frames, killed connections, dropped
ACKs, duplicate deliveries — as a soak of exactly those guarantees;
the faults that fired are reported under ``"chaos"``.

Every role accepts ``--learner`` (uniform model family: nn | rf |
gbdt) or ``--learners rf,gbdt,nn,...`` (one kind per party) — a real
TCP fleet can mix tree and neural silos in one round because the vote
DOMAIN (federation/domain.py) is the only cross-party contract.  All
roles must pass the SAME roster: the coordinator needs it to bind each
arriving update to its student learner.  ``--vertical`` switches the
round to feature-split silos: every party holds ALL samples and a
disjoint column slice (core.partition.vertical_split), trains a
feature-masked learner, and votes in the shared example domain (the
JAX package's examples/vertical_fedkt.py walks through it).

Every role runs its silo's fits and votes on ``--device`` (default
``cuda``: the vote and histogram kernels; a host without a card raises,
nothing falls back).  ``--device cpu`` runs the plain versions.

Demo (two shells; add ``--device cpu`` to every command on a host
without a card):
  PYTHONPATH=src python -m repro_torch.launch.federate coordinator \
      --parties 4 --port 7733 --deadline-s 120 --min-parties 3 \
      --learner rf
  for i in 0 1 2 3; do PYTHONPATH=src python -m \
      repro_torch.launch.federate party --party-id $i --parties 4 \
      --port 7733 --learner rf & done
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import GBDTLearner, NNLearner, RFLearner
from repro_torch.core.partition import vertical_split
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import (FaultPlan, FedKTSession, PartyBinding,
                                    SocketTransport, party_starting_keys,
                                    query_budget, registered_learner_kinds,
                                    run_party_client)
from repro_torch.models.smallnets import MLP

LEARNER_KINDS = ("nn", "rf", "gbdt")
NUM_FEATURES = 14          # tabular_binary's fixed feature width


def build_learner(kind: str, args, feature_mask=None):
    """One learner instance for a party role.  The same --seed plus the
    same kind list must rebuild identical learners on every host, so
    all hyperparameters come from CLI flags (never from local state).
    ``feature_mask`` (a sorted column-index tuple from
    ``vertical_split``) builds the vertical variant: the learner trains
    and predicts on only its silo's feature slice."""
    nfeat = NUM_FEATURES if feature_mask is None else len(feature_mask)
    if kind == "nn":
        return NNLearner(MLP(num_features=nfeat, num_classes=2,
                             hidden=args.hidden),
                         num_classes=2, steps=args.steps,
                         feature_mask=feature_mask)
    if kind == "rf":
        return RFLearner(num_classes=2, num_trees=args.trees,
                         depth=args.depth, feature_mask=feature_mask)
    if kind == "gbdt":
        return GBDTLearner(num_classes=2, num_rounds=args.trees,
                           depth=args.depth, feature_mask=feature_mask)
    raise ValueError(f"unknown learner kind {kind!r}; "
                     f"available: {list(LEARNER_KINDS)}")


def party_kinds(args):
    """The fleet's learner-kind roster, one entry per party.  --learners
    (comma list) pins each silo's model family; --learner is the uniform
    default.  Every role — coordinator included — derives the SAME
    roster, because the server must know which student learner answers
    each party's update.  A kind this launcher cannot build fails HERE
    — up front, naming the offending party — not as a stray exception
    mid-round on some host."""
    if args.learners:
        kinds = [k.strip() for k in args.learners.split(",")]
        if len(kinds) != args.parties:
            raise SystemExit(f"--learners names {len(kinds)} kinds but "
                             f"--parties is {args.parties}")
        for i, k in enumerate(kinds):
            if k not in LEARNER_KINDS:
                raise SystemExit(
                    f"--learners: unknown learner kind {k!r} for party "
                    f"{i}; this launcher builds {list(LEARNER_KINDS)} "
                    f"(registered wire kinds: "
                    f"{registered_learner_kinds()})")
        return kinds
    return [args.learner] * args.parties


def build_session(args, transport) -> FedKTSession:
    """The shared seeded setup: every role derives the same data,
    partition, key schedule, and per-party learner bindings from the
    CLI flags, so the only thing that differs between roles is WHERE
    each piece runs.  Every learner runs on ``--device``."""
    data = tabular_binary(n=args.n_train, seed=args.seed)
    kinds = party_kinds(args)
    cfg = FedKTConfig(num_parties=args.parties,
                      num_partitions=args.partitions,
                      num_subsets=args.subsets, num_classes=2,
                      privacy_level=args.privacy, gamma=args.gamma,
                      seed=args.seed)
    if args.vertical:
        # feature-split silos: every party holds ALL samples (aligned
        # by the shared sample-id vector — here the synthetic row ids)
        # and a disjoint column slice; its learner is feature-masked,
        # so raw off-silo columns never cross the boundary.  The final
        # model distills on the full-width public queries.
        row_order, masks = vertical_split(
            np.arange(len(data["X_train"])), NUM_FEATURES, args.parties,
            seed=args.seed)
        bindings = [PartyBinding(build_learner(k, args, feature_mask=m),
                                 engine=args.engine)
                    for k, m in zip(kinds, masks)]
        indices = [row_order.copy() for _ in range(args.parties)]
        return FedKTSession(bindings, data, cfg, engine=args.engine,
                            final_learner=build_learner("nn", args),
                            party_indices=indices, transport=transport,
                            retain_students=not args.drop_students,
                            device=args.device)
    if len(set(kinds)) == 1:
        # homogeneous shorthand: identical to the pre-binding launcher
        return FedKTSession(build_learner(kinds[0], args), data, cfg,
                            engine=args.engine, transport=transport,
                            retain_students=not args.drop_students,
                            device=args.device)
    bindings = [PartyBinding(build_learner(k, args), engine=args.engine)
                for k in kinds]
    # mixed fleets distill the final model with an NN student on the
    # server (any kind works; the vote labels are learner-agnostic)
    return FedKTSession(bindings, data, cfg, engine=args.engine,
                        final_learner=build_learner("nn", args),
                        transport=transport,
                        retain_students=not args.drop_students,
                        device=args.device)


def _report(result) -> None:
    sock = result.meta.get("socket", {})
    out = {
        "accuracy": round(float(result.accuracy), 4),
        "epsilon": result.epsilon,
        "arrived": len(sock.get("arrived", [])),
        "dropped_parties": result.meta.get("dropped_parties", []),
        "wire_bytes": result.meta["wire_bytes"],
        "seconds": result.meta["seconds"],
    }
    if sock.get("journal"):
        out["journal"] = sock["journal"]
        out["resumed"] = sock.get("resumed", False)
        out["replayed_parties"] = sock.get("replayed_parties", [])
        out["corrupt_records_dropped"] = \
            sock.get("corrupt_records_dropped", 0)
        out["re_acked"] = sock.get("re_acked", {})
    if "chaos" in sock:
        out["chaos"] = sock["chaos"]
    print(json.dumps(out, indent=1))


def _chaos_plan(args):
    """The local soak's seeded fault schedule: enough scripted faults
    to cover every party a few times over (retransmits get their own
    connection ordinals), reproducible from --chaos-seed."""
    if not args.chaos:
        return None
    return FaultPlan.random(args.chaos_seed, 3 * args.parties)


def run_local(args):
    transport = SocketTransport(parallelism=args.parallelism,
                                port=args.port,
                                deadline_s=args.deadline_s,
                                min_parties=args.min_parties,
                                journal_path=args.journal,
                                resume=args.resume,
                                chaos_plan=_chaos_plan(args))
    result = build_session(args, transport).run(verbose=args.verbose)
    _report(result)
    return result


def run_coordinator(args):
    transport = SocketTransport(host=args.host, port=args.port,
                                spawn=False,
                                deadline_s=args.deadline_s,
                                min_parties=args.min_parties,
                                journal_path=args.journal,
                                resume=args.resume)
    print(f"coordinator: waiting for {args.parties} parties on "
          f"{args.host}:{args.port} (deadline "
          f"{args.deadline_s}s, quorum "
          f"{args.min_parties or args.parties})"
          + (f"; journaling to {args.journal}"
             + (" [resume]" if args.resume else "")
             if args.journal else ""))
    result = build_session(args, transport).run(verbose=args.verbose)
    _report(result)
    return result


def run_party(args) -> None:
    session = build_session(args, "inprocess")   # setup only, never run
    keys, _ = party_starting_keys(session.parties, args.seed)
    party = session.parties[args.party_id]
    tq_party, _ = query_budget(session.cfg,
                               len(session.data["X_public"]))
    nbytes = run_party_client(
        args.host, args.port, party, keys[args.party_id],
        session.data["X_public"], tq_party, engine=None,
        retries=args.retries, backoff_s=args.backoff_s)
    kind = session.bindings[args.party_id].kind
    print(f"party {args.party_id} ({kind}): update delivered to "
          f"{args.host}:{args.port} ({nbytes} framed bytes)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="one FedKT round over TCP sockets")
    ap.add_argument("role", choices=["local", "coordinator", "party"])
    ap.add_argument("--parties", type=int, default=4)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--subsets", type=int, default=2)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--learner", default="nn", choices=LEARNER_KINDS,
                    help="model family every party trains (uniform "
                         "default; see --learners for mixed fleets)")
    ap.add_argument("--learners", default=None,
                    help="comma list, one kind per party (e.g. "
                         "'rf,gbdt,nn,nn') — every role must pass the "
                         "same list so the server binds each silo's "
                         "update to its learner")
    ap.add_argument("--trees", type=int, default=20,
                    help="rf: trees per forest / gbdt: boosting rounds")
    ap.add_argument("--depth", type=int, default=6,
                    help="rf/gbdt tree depth")
    ap.add_argument("--engine", default="loop")
    ap.add_argument("--privacy", default="L0",
                    choices=["L0", "L1", "L2"])
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where this role's fits and votes run: 'cuda' "
                         "(the default; raises without a card) or "
                         "'cpu'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7733)
    ap.add_argument("--parallelism", type=int, default=None,
                    help="local role: concurrent simulated parties")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-party deadline from round start")
    ap.add_argument("--min-parties", type=int, default=None,
                    help="quorum: proceed at the deadline with at "
                         "least this many updates")
    ap.add_argument("--vertical", action="store_true",
                    help="feature-split silos: every party holds all "
                         "samples and a disjoint slice of the feature "
                         "columns (core.partition.vertical_split); "
                         "works in every role — remote parties rebuild "
                         "the same masks from --seed")
    ap.add_argument("--drop-students", action="store_true",
                    help="fold-and-drop updates (constant server "
                         "memory; RoundResult carries no student "
                         "states)")
    ap.add_argument("--journal", default=None,
                    help="local/coordinator: write-ahead journal file; "
                         "every accepted update is fsync'd here before "
                         "it is ACKed, so a crashed round resumes")
    ap.add_argument("--resume", action="store_true",
                    help="replay an existing --journal: refold the "
                         "already-delivered parties and wait only for "
                         "the missing ones")
    ap.add_argument("--chaos", action="store_true",
                    help="local role: route party deliveries through a "
                         "seeded fault-injection proxy (corrupt / kill "
                         "/ delay / duplicate / dropped-ACK) — a soak "
                         "of the crash-safety layer")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the --chaos fault schedule (same "
                         "seed, same faults)")
    ap.add_argument("--retries", type=int, default=8,
                    help="party role: connect attempts")
    ap.add_argument("--backoff-s", type=float, default=0.05,
                    help="party role: base exponential backoff")
    ap.add_argument("--party-id", type=int, default=0,
                    help="party role: which silo this process is")
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs one role; the local and coordinator roles return the
    session's RoundResult (after printing its report)."""
    args = parse_args(argv)
    return {"local": run_local, "coordinator": run_coordinator,
            "party": run_party}[args.role](args)


if __name__ == "__main__":
    main()
