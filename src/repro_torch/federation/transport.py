"""Transports: HOW a PartyUpdate crosses the party/server boundary
(``repro.federation.transport``).

The protocol says each party sends ONE message; a Transport decides
where the party side runs and how the message travels.  Every
implementation routes the update through the wire codec — encode on the
party side, decode on the server side — so ``meta["encoded_bytes"]`` is
the measured wire size of each update, and ``meta["frame_sha256"]`` the
digest of the bytes the server received:

  InProcessTransport : parties run serially in the caller's process
                       (the reference semantics; codec round trip only).
  ThreadTransport    : parties fan out over a thread pool.  On the card
                       every thread launches the vote and histogram
                       kernels on the device's current (default)
                       stream, so each party's launches stay in order.
  SubprocessTransport: each party's local round runs in its OWN worker
                       process (spawned interpreters, each with its own
                       CUDA context when the party's learner is on the
                       card); the encoded PartyUpdate bytes are what
                       crosses the process boundary — the paper's
                       cross-silo deployment shape, one process per silo.
  SocketTransport    : federation/net.py — updates cross REAL TCP
                       connections, streamed into the server's running
                       vote aggregate with deadline/quorum straggler
                       semantics.  The only transport with a
                       ``stream_round`` (``streams = True``).

Every transport is a context manager, and a party failure mid-round
never leaks execution resources: the subprocess pool is TERMINATED (not
drained) when a party raises, so no spawned interpreter outlives the
round it was serving.

Seed contract: parties receive PRECOMPUTED keys (the serial schedule
played forward by the session), so fan-out order never changes any
party's randomness and every transport is bit-identical to the
in-process loop at a fixed seed.
"""
from __future__ import annotations

import hashlib
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.federation.codec import decode_update, encode_update
from repro_torch.federation.messages import PartyUpdate


class Transport(Protocol):
    """Pluggable party-execution + message-passing backend."""
    name: str

    def run_round(self, parties: Sequence[Any], keys: Sequence[Any],
                  X_public, num_queries: int,
                  engine) -> List[PartyUpdate]:
        """Runs every party's local round (one precomputed key each) and
        returns the DECODED updates, in party order.  ``engine=None``
        lets every party run under its OWN bound engine."""
        ...

    def close(self) -> None:
        """Releases any resources the transport holds across rounds."""
        ...


class TransportBase:
    """Context-manager plumbing: ``close`` is idempotent and runs on
    ``with`` exit, success or failure.  Per-ROUND resources (pools,
    sockets) are the run methods' own and are cleaned up in ``finally``."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def _decode_annotated(buf: bytes) -> PartyUpdate:
    # the digest runs on a worker beside the decode: both release the
    # GIL over a large frame (two full-width students hash in seconds)
    with ThreadPoolExecutor(max_workers=1) as pool:
        digest = pool.submit(lambda: hashlib.sha256(buf).hexdigest())
        upd = decode_update(buf)
    upd.meta["encoded_bytes"] = len(buf)
    upd.meta["frame_sha256"] = digest.result()
    return upd


def _encoded_round(party, key, X_public, num_queries, engine) -> bytes:
    upd, _ = party.local_round(key, X_public, num_queries, engine)
    return encode_update(upd)


def _party_devices(parties) -> set:
    """The devices the parties' learners ask for."""
    return {torch.device(str(getattr(lrn, "device", "cpu")))
            for p in parties for lrn in (p.learner, p.student_learner)}


class InProcessTransport(TransportBase):
    """Parties run serially in the caller's process, each update
    through the codec round trip."""
    name = "inprocess"

    def __init__(self, parallelism: Optional[int] = None):
        if parallelism not in (None, 1):
            raise ValueError("the inprocess transport is serial; use "
                             "transport=\"thread\" or \"subprocess\" "
                             "for parallelism > 1")
        self.parallelism = 1

    def run_round(self, parties, keys, X_public, num_queries, engine):
        return [_decode_annotated(
                    _encoded_round(p, k, X_public, num_queries, engine))
                for p, k in zip(parties, keys)]


class ThreadTransport(TransportBase):
    """Concurrent parties in one interpreter.  Engines and learners hold
    no per-round state, the kernel library loads and launch counters
    are locked (kernels/build.py), so sharing them across workers is
    safe; results are collected in party order.  On the card the
    parties share the default stream, so each party's host reads wait
    for the other parties' queued kernels: the threads do not overlap
    there (tools/fleet_bench.py measures it)."""
    name = "thread"

    def __init__(self, parallelism: Optional[int] = None):
        self.parallelism = parallelism

    def run_round(self, parties, keys, X_public, num_queries, engine):
        workers = self.parallelism or len(parties)
        ex = ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="fedkt-party")
        try:
            futs = [ex.submit(_encoded_round, p, k, X_public,
                              num_queries, engine)
                    for p, k in zip(parties, keys)]
            return [_decode_annotated(f.result()) for f in futs]
        finally:
            # a failed party must not make the round run the REMAINING
            # parties to completion before raising: drop queued work
            # (running threads finish their current party and exit)
            ex.shutdown(wait=False, cancel_futures=True)


def _subprocess_worker(blob: bytes) -> bytes:
    """Runs in a spawned interpreter: unpickle the silo, run its local
    round (on the device its learner names), return the codec-encoded
    PartyUpdate."""
    party, key, X_public, num_queries, engine = pickle.loads(blob)
    return _encoded_round(party, key, X_public, num_queries, engine)


class SubprocessTransport(TransportBase):
    """One worker process per party, from the ``spawn`` start method: a
    forked child of a process that has initialised CUDA cannot use the
    card.  Workers re-import torch and open their own CUDA context, so
    cold cost is high — this transport makes the cross-silo deployment
    real, it does not win single-host benchmarks.  When a party's
    learner is on the card, the parent builds the round's kernels
    before it spawns, so the workers load the libraries instead of each
    running ``nvcc``.

    Cleanup contract: when any party raises, the whole worker pool is
    terminated on the spot."""
    name = "subprocess"

    def __init__(self, parallelism: Optional[int] = None):
        self.parallelism = parallelism

    def run_round(self, parties, keys, X_public, num_queries, engine):
        import multiprocessing
        cards = [d for d in _party_devices(parties) if d.type == "cuda"]
        if cards:
            for dev in cards:
                D.resolve(dev)
            from repro_torch.kernels import build
            # the kernels a party's local round launches on the card
            build.build(("vote_aggregate", "tree_hist"))
        workers = self.parallelism or len(parties)
        Xpub = np.asarray(X_public)
        blobs = [pickle.dumps((p, np.asarray(k), Xpub, num_queries,
                               engine))
                 for p, k in zip(parties, keys)]
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(processes=workers)
        done = False
        try:
            encoded = pool.map(_subprocess_worker, blobs, chunksize=1)
            pool.close()
            pool.join()
            done = True
            return [_decode_annotated(b) for b in encoded]
        finally:
            if not done:
                # a party failed: kill every worker interpreter NOW
                # instead of letting them finish (or start) the other
                # parties' rounds
                pool.terminate()
                pool.join()


_TRANSPORTS = {"inprocess": InProcessTransport, "thread": ThreadTransport,
               "subprocess": SubprocessTransport}


def get_transport(transport, parallelism: Optional[int] = None) -> Transport:
    """Transport instance from a name ("inprocess" | "thread" |
    "subprocess" | "socket") or pass-through of an instance."""
    if isinstance(transport, str):
        if transport == "socket":
            # net.py imports this module; resolve lazily to avoid the
            # cycle while keeping one registry entry point
            from repro_torch.federation.net import SocketTransport
            return SocketTransport(parallelism=parallelism)
        if transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; "
                             f"available: "
                             f"{sorted([*_TRANSPORTS, 'socket'])}")
        return _TRANSPORTS[transport](parallelism=parallelism)
    if parallelism is not None:
        raise ValueError("parallelism= only applies when the transport "
                         "is given by name")
    return transport
