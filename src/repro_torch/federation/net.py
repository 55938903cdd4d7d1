"""Socket federation: the one-shot protocol over real TCP connections
(``repro.federation.net``).

The codec already made the wire format the boundary — a PartyUpdate is
one self-describing byte buffer.  This module moves that buffer over an
actual network:

  frame               : ``uint32 length | codec bytes``.  Length-prefixed
                        so a stream socket carries exactly one message;
                        the codec's own magic/version prefix inside the
                        payload rejects incompatible peers with a clear
                        error, and its crc32 trailer catches bytes
                        mangled in flight (codec.py).
  reply               : 1 byte ACK, or NAK followed by a one-byte
                        reason code (see the NAK_* table) so the party
                        can tell a retryable refusal (``corrupt`` — the
                        frame was damaged in transit, send it again)
                        from a fatal one (``unknown-party``,
                        ``domain-mismatch`` — retrying cannot help).
  Coordinator         : an asyncio server that accepts party connections
                        CONCURRENTLY and hands each decoded update to a
                        consumer queue the moment it arrives — the
                        session folds it into the running vote aggregate
                        (federation/aggregate.py) while other parties
                        are still training.  Nothing ever holds all n
                        updates at once.
  SocketTransport     : the ``FedKTSession(transport="socket")`` backend.
                        By default it also SIMULATES the fleet: party
                        rounds fan out over a bounded thread pool on
                        this host, and each worker ships its update
                        through a real localhost TCP connection (on the
                        card, every party thread launches the vote and
                        histogram kernels on the device's default
                        stream).  With
                        ``spawn=False`` it only coordinates — remote
                        parties connect from other processes/hosts via
                        ``run_party_client`` (see launch/federate.py).

Crash safety: with ``journal_path=`` set, every accepted frame is
fsync'd to a write-ahead RoundJournal (federation/journal.py) BEFORE
the ACK is written or the update folds.  A coordinator restarted with
``resume=True`` replays the journal (crc-validated, torn tail
truncated), refolds the already-arrived parties, and waits only for
the missing ones; the recovery is accounted in ``round_report``
(``resumed``, ``replayed_parties``, ``corrupt_records_dropped``).
Delivery is idempotent: a retransmit whose bytes match what the
journal holds for that party is RE-ACKED, never re-folded — so a party
that lost an ACK may safely send-until-ACK (``re_acked`` counts them).
Fault injection (federation/faults.py) plugs in as ``fault_hook``: a
hook returning True at the "journaled" event kills the coordinator in
the exact append->ACK/fold window the journal must cover.

Straggler semantics: each party has until ``deadline_s`` (measured from
round start) to deliver its update.  When the deadline passes — or when
every remaining party has already failed outright — the round proceeds
if at least ``min_parties`` updates arrived; stragglers are EXCLUDED
from the vote and reported in ``round_report["dropped"]`` (surfaced as
session meta).  Below quorum the round raises ``QuorumError``.  Party
clients retry their connection with exponential backoff, so a
coordinator that is still binding its port never costs a party its
round.

The coordinator thread makes no CUDA call: it decodes each frame to
numpy leaves, and the fold (the students' votes over the query set, on
the learner's device) runs on the consuming thread, in the session.

Determinism: party keys are precomputed by the session (the
``advance_key`` discipline), updates are integer-folded in any arrival
order, and the server-side key threading never depends on the network —
so when all parties respond, the socket session is bit-identical to the
serial in-process loop, and a crash-resumed round is bit-identical to
an uninterrupted one (test-enforced in tests/test_torch_net.py and
tests/test_torch_faults.py).
"""
from __future__ import annotations

import asyncio
import hashlib
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence)

import numpy as np

from repro_torch.federation.codec import (CorruptFrameError,
                                          TruncatedFrameError,
                                          VersionMismatchError,
                                          encode_update)
from repro_torch.federation.domain import fingerprint_queries, learner_domain
from repro_torch.federation.faults import ChaosProxy
from repro_torch.federation.journal import RoundJournal
from repro_torch.federation.messages import PartyUpdate
from repro_torch.federation.party import query_budget
from repro_torch.federation.transport import (TransportBase,
                                              _decode_annotated)

_LEN = struct.Struct("<I")
MAX_FRAME_BYTES = 1 << 31        # sanity bound on a length prefix
ACK, NAK = b"\x06", b"\x15"

# NAK reason codes: the byte after NAK.  ``corrupt`` is the only
# retryable refusal — the bytes were damaged in transit and a clean
# retransmit can succeed; every other reason is a property of the
# update or the round, and retrying the same frame cannot change it.
NAK_PROTOCOL = 0          # undecodable / wrong codec version / framing
NAK_DUPLICATE = 1         # party already folded, retransmit differs
NAK_DOMAIN_MISMATCH = 2   # declared vote domain contradicts binding
NAK_UNKNOWN_PARTY = 3     # party id not in this round
NAK_CORRUPT = 4           # crc failure / truncation: retransmit
NAK_REASON_NAMES = {
    NAK_PROTOCOL: "protocol",
    NAK_DUPLICATE: "duplicate",
    NAK_DOMAIN_MISMATCH: "domain-mismatch",
    NAK_UNKNOWN_PARTY: "unknown-party",
    NAK_CORRUPT: "corrupt",
}
RETRYABLE_NAKS = frozenset({NAK_CORRUPT})


class QuorumError(RuntimeError):
    """Round ended below ``min_parties`` arrived updates."""


class UpdateRefused(ConnectionError):
    """The coordinator NAKed the frame.  ``reason`` is the NAK_* code
    (None when the peer closed before sending one); ``retryable`` says
    whether a retransmit of the same update can ever succeed."""

    def __init__(self, reason: Optional[int]):
        self.reason = reason
        self.retryable = reason in RETRYABLE_NAKS
        name = NAK_REASON_NAMES.get(reason, "unspecified") \
            if reason is not None else "unspecified"
        kind = "retryable" if self.retryable else "fatal"
        super().__init__(
            f"coordinator refused the update frame (NAK, reason: "
            f"{name}, {kind})")


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_reason(sock: socket.socket) -> Optional[int]:
    """The optional reason byte after a NAK; None if the peer closed
    without one (a pre-reason-code coordinator, or a dying one)."""
    try:
        b = sock.recv(1)
    except OSError:
        return None
    return b[0] if b else None


def send_update_frame(host: str, port: int, payload: bytes, *,
                      retries: int = 8, backoff_s: float = 0.05,
                      io_timeout_s: float = 60.0) -> None:
    """Ships one encoded PartyUpdate to the coordinator: connect (with
    exponential backoff — the coordinator may still be binding), send
    the length-prefixed frame, wait for the ACK.  Connection failures
    and retryable NAKs (reason ``corrupt``: the frame was damaged in
    flight) are retried; a fatal NAK (unknown party, duplicate, domain
    mismatch, protocol) raises ``UpdateRefused`` IMMEDIATELY with the
    reason named — no backoff is slept after a fatal refusal or after
    the final attempt."""
    if len(payload) >= MAX_FRAME_BYTES:
        raise ValueError(f"update frame of {len(payload)} bytes exceeds "
                         f"the {MAX_FRAME_BYTES}-byte frame bound")
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            with socket.create_connection((host, port),
                                          timeout=io_timeout_s) as sock:
                sock.sendall(_LEN.pack(len(payload)) + payload)
                reply = _recv_exact(sock, 1)
                reason = None if reply == ACK else _recv_reason(sock)
        except (OSError, TimeoutError) as err:
            last_err = err
        else:
            if reply == ACK:
                return
            refusal = UpdateRefused(reason)
            if not refusal.retryable:
                raise refusal
            last_err = refusal
        if attempt + 1 < retries:
            time.sleep(backoff_s * (2 ** attempt))
    raise ConnectionError(
        f"could not deliver update to {host}:{port} after {retries} "
        f"attempts: {last_err!r}")


def run_party_client(host: str, port: int, party, key, X_public,
                     num_queries: int, engine=None, *, retries: int = 8,
                     backoff_s: float = 0.05,
                     io_timeout_s: float = 60.0) -> int:
    """The remote-silo entry point: run this party's local round and
    ship the one resulting PartyUpdate to the coordinator.  Returns the
    framed byte count (what actually crossed the wire, minus the 4-byte
    length prefix).  ``engine=None`` runs the party's own bound engine
    — in a mixed fleet each silo's binding decides.  Delivery is
    send-until-ACK safe: if the coordinator journaled the update but
    the ACK was lost, the retransmit is re-ACKed, never double-folded.
    See launch/federate.py for the CLI wrapper."""
    upd, _ = party.local_round(key, X_public, num_queries, engine)
    payload = encode_update(upd)
    send_update_frame(host, port, payload, retries=retries,
                      backoff_s=backoff_s, io_timeout_s=io_timeout_s)
    return len(payload)


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------
class Coordinator:
    """Asyncio accept loop in a background thread.

    Decoded updates land on ``self.updates`` (a thread-safe queue) in
    ARRIVAL order, each annotated with its measured framed bytes; the
    consuming thread (SocketTransport.stream_round) owns deadlines and
    quorum.  Per-connection failures (truncated frame, codec version
    mismatch, unknown party) NAK that peer with a reason byte and are
    recorded in ``self.errors`` without disturbing the round.

    With ``journal_path=`` every accepted frame is fsync'd to a
    RoundJournal before the ACK/fold; ``resume=True`` replays an
    existing journal at start() — replayed updates are queued before
    the socket even binds, ``self.replayed`` lists their parties, and
    only the missing parties are waited for.  A retransmit whose bytes
    match the journaled (or, journal-less, the digest-remembered)
    frame is re-ACKed idempotently (``self.re_acked``).

    ``fault_hook(event, party_id) -> bool`` is the chaos injection
    point (federation/faults.py): returning True at event "journaled"
    kills the coordinator after the journal append and before the
    ACK/fold — the party never hears back, the server thread dies, and
    only a resume can finish the round.
    """

    def __init__(self, expected_ids: Sequence[int], *,
                 host: str = "127.0.0.1", port: int = 0,
                 expected_domains: Optional[Dict[int, Any]] = None,
                 journal_path: Optional[str] = None,
                 resume: bool = False,
                 fault_hook: Optional[Callable[[str, int], bool]] = None):
        """``expected_domains`` (party_id -> VoteDomain) enables
        ACK-time domain validation: an update whose wire-declared domain
        contradicts what the party's binding derives is NAKed at
        delivery — the party finds out immediately, and the server never
        trains over it (the fold would refuse it later anyway;
        aggregate.py is the backstop)."""
        self.host, self._req_port = host, port
        self.expected = set(int(i) for i in expected_ids)
        self.expected_domains = dict(expected_domains or {})
        self.journal_path = journal_path
        self.resume = resume
        self.journal: Optional[RoundJournal] = None
        self.replayed: List[int] = []
        self.corrupt_records_dropped = 0
        self.re_acked: Dict[int, int] = {}
        self.killed = False
        self._fault_hook = fault_hook
        self.updates: "queue.Queue[PartyUpdate]" = queue.Queue()
        self.errors: List[str] = []
        self._seen: set = set()
        self._digest: Dict[int, bytes] = {}    # pid -> sha256(frame)
        self._lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self._kill_evt: Optional[asyncio.Event] = None
        self.port: Optional[int] = None

    # -- admission --------------------------------------------------------
    def _admit(self, payload: bytes):
        """The whole accept decision for one delivered frame, under the
        round lock: returns ``(reply_bytes, update_or_None)``.  A reply
        of None means the fault hook fired — the coordinator must die
        without answering (the journaled-but-unACKed crash window)."""
        try:
            upd = _decode_annotated(payload)
        except VersionMismatchError as err:
            self.errors.append(f"rejected connection: {err}")
            return NAK + bytes([NAK_PROTOCOL]), None
        except (TruncatedFrameError, CorruptFrameError) as err:
            self.errors.append(f"rejected connection: {err}")
            return NAK + bytes([NAK_CORRUPT]), None
        except ValueError as err:
            self.errors.append(f"rejected connection: {err}")
            return NAK + bytes([NAK_PROTOCOL]), None
        pid = int(upd.party_id)
        with self._lock:
            if pid not in self.expected:
                self.errors.append(f"rejected connection: unknown party "
                                   f"{pid}")
                return NAK + bytes([NAK_UNKNOWN_PARTY]), None
            if pid in self._seen:
                # sha256, NOT the frame's crc32: a v3 frame ends with
                # the crc of its own body, which makes crc32(frame) the
                # same constant residue for EVERY valid frame
                same = (hashlib.sha256(payload).digest()
                        == self._digest.get(pid))
                if same and self.journal is not None:
                    # digest agreement is necessary, byte identity is
                    # what a re-ACK actually promises
                    same = self.journal.frame_matches(pid, payload)
                if same:
                    self.re_acked[pid] = self.re_acked.get(pid, 0) + 1
                    return ACK, None     # lost-ACK retransmit: no fold
                self.errors.append(f"rejected connection: duplicate "
                                   f"update from party {pid} with "
                                   f"different bytes")
                return NAK + bytes([NAK_DUPLICATE]), None
            exp = self.expected_domains.get(pid)
            if (exp is not None and upd.domain is not None
                    and not exp.matches(upd.domain)):
                self.errors.append(
                    f"rejected connection: vote-domain mismatch: party "
                    f"{pid} declares a {upd.domain.describe()}, but its "
                    f"session binding expects a {exp.describe()}")
                return NAK + bytes([NAK_DOMAIN_MISMATCH]), None
            if self.journal is not None:
                self.journal.append(pid, payload)
            if (self._fault_hook is not None
                    and self._fault_hook("journaled", pid)):
                return None, None        # crash before ACK/fold
            self._seen.add(pid)
            self._digest[pid] = hashlib.sha256(payload).digest()
        return ACK, upd

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                nbytes = _LEN.unpack(await reader.readexactly(
                    _LEN.size))[0]
                if nbytes >= MAX_FRAME_BYTES:
                    self.errors.append(f"rejected connection: frame "
                                       f"length {nbytes} exceeds bound")
                    reply: Optional[bytes] = NAK + bytes([NAK_PROTOCOL])
                    upd = None
                else:
                    payload = await reader.readexactly(nbytes)
                    reply, upd = self._admit(payload)
            except asyncio.IncompleteReadError as err:
                # the frame never finished arriving (killed connection,
                # half-shipped bytes): retryable by definition
                self.errors.append(f"rejected connection: {err}")
                reply, upd = NAK + bytes([NAK_CORRUPT]), None
            if reply is None:
                self.killed = True       # fault hook: die unanswered
                if self._kill_evt is not None:
                    self._kill_evt.set()
                return
            if upd is not None:
                # queue BEFORE the ACK: if the ACK is lost on the wire
                # the update is still folded, and the retransmit hits
                # the idempotent re-ACK path instead of re-queueing
                self.updates.put(upd)
            writer.write(reply)
            await writer.drain()
        except (ConnectionError, OSError):
            pass                         # peer vanished mid-reply
        finally:
            writer.close()

    # -- lifecycle --------------------------------------------------------
    def _replay_journal(self) -> None:
        """Folds an existing journal back into the round state before
        the socket binds: every crc-valid record that still decodes is
        queued exactly as if its party had just delivered it."""
        self.journal = RoundJournal(self.journal_path,
                                    resume=self.resume)
        self.corrupt_records_dropped = self.journal.corrupt_records_dropped
        for pid, frame in self.journal.records:
            if pid not in self.expected:
                self.errors.append(f"journal replay: party {pid} is "
                                   f"not in this round; record ignored")
                continue
            try:
                upd = _decode_annotated(frame)
            except ValueError as err:
                # crc-valid yet undecodable (e.g. a codec the journal
                # outlived): drop it, let a fresh delivery re-arrive
                self.errors.append(f"journal replay: party {pid} record "
                                   f"undecodable ({err}); dropped")
                self.corrupt_records_dropped += 1
                continue
            self._seen.add(pid)
            self._digest[pid] = hashlib.sha256(frame).digest()
            self.replayed.append(pid)
            self.updates.put(upd)

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self._req_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._kill_evt = asyncio.Event()
        self._started.set()
        async with self._server:
            kill = asyncio.ensure_future(self._kill_evt.wait())
            serve = asyncio.ensure_future(self._server.serve_forever())
            done, pending = await asyncio.wait(
                {kill, serve}, return_when=asyncio.FIRST_COMPLETED)
            for task in pending:
                task.cancel()

    def start(self) -> "Coordinator":
        if self.journal_path is not None:
            self._replay_journal()

        def runner():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass
            finally:
                if self.journal is not None:
                    self.journal.close()
                self._loop.close()
        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="fedkt-coordinator")
        self._thread.start()
        if not self._started.wait(timeout=30.0):
            raise RuntimeError("coordinator failed to bind within 30s")
        return self

    def stop(self) -> None:
        """Stops accepting and joins the loop thread (idempotent).
        Late stragglers get connection-refused from here on."""
        loop = self._loop
        if loop is None or not loop.is_running():
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            return

        def shutdown():
            for task in asyncio.all_tasks(loop):
                task.cancel()
        loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._loop = None


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------
def _ship_round(party, key, X_public, num_queries, engine,
                host, port, retries, backoff_s, io_timeout_s):
    return run_party_client(host, port, party, key, X_public,
                            num_queries, engine, retries=retries,
                            backoff_s=backoff_s,
                            io_timeout_s=io_timeout_s)


class SocketTransport(TransportBase):
    """Fleet transport: parties deliver their updates over TCP, the
    coordinator streams them into the running aggregate as they land.

    parallelism : bound on concurrently-running simulated parties
                  (default min(n, 8) — a fleet of hundreds shares the
                  host, so one thread per party would thrash).
    host/port   : coordinator bind address (port=0 → ephemeral).
    deadline_s  : per-party deadline from round start; None waits
                  indefinitely (failed parties still end the wait).
    min_parties : quorum — proceed at the deadline with at least this
                  many updates, dropping stragglers.  None requires
                  every party.
    spawn       : False runs NO local parties; the coordinator waits for
                  remote ``run_party_client`` peers (cross-host mode).
    connect_retries / backoff_s / io_timeout_s : party-side client
                  knobs (exponential backoff between connect attempts).
    journal_path: write-ahead journal file enabling crash recovery
                  (every accepted frame fsync'd before ACK/fold).
    resume      : replay an existing journal at round start; replayed
                  parties fold immediately, are NOT re-spawned, and are
                  not waited for.
    chaos_plan  : a faults.FaultPlan — spawned parties deliver through
                  an in-path ChaosProxy applying the plan's scripted
                  connection faults, and a coordinator-kill fault (if
                  scheduled) fires in the journal-append window.

    After each round, ``round_report`` holds the dropout AND recovery
    accounting the session surfaces as ``meta["socket"]``.
    """
    name = "socket"
    streams = True

    @staticmethod
    def _expected_domains(parties, X_public) -> Dict[int, Any]:
        """party_id -> the VoteDomain each party's binding derives over
        the server-side query slice — what the coordinator validates
        arriving declarations against at ACK time.  Host work only
        (hashes and shapes): no CUDA call."""
        Xpub = np.asarray(X_public)
        doms: Dict[int, Any] = {}
        fp_by_tq: Dict[int, Any] = {}    # hash each query slice once
        for p in parties:
            _, tq = query_budget(p.cfg, len(Xpub))
            if tq not in fp_by_tq:
                fp_by_tq[tq] = fingerprint_queries(Xpub[:tq])
            doms[int(p.party_id)] = learner_domain(
                p.student_learner, Xpub[:tq], p.cfg.num_classes,
                fingerprint=fp_by_tq[tq])
        return doms

    def __init__(self, parallelism: Optional[int] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 deadline_s: Optional[float] = None,
                 min_parties: Optional[int] = None, spawn: bool = True,
                 connect_retries: int = 8, backoff_s: float = 0.05,
                 io_timeout_s: float = 60.0,
                 journal_path: Optional[str] = None,
                 resume: bool = False, chaos_plan=None):
        self.parallelism = parallelism
        self.host, self.port = host, port
        self.deadline_s = deadline_s
        self.min_parties = min_parties
        self.spawn = spawn
        self.connect_retries = connect_retries
        self.backoff_s = backoff_s
        self.io_timeout_s = io_timeout_s
        self.journal_path = journal_path
        self.resume = resume
        self.chaos_plan = chaos_plan
        self.round_report: Dict[str, Any] = {}

    def stream_round(self, parties, keys, X_public, num_queries,
                     engine) -> Iterator[PartyUpdate]:
        """Yields decoded PartyUpdates in ARRIVAL order, as they land.
        The consumer folds each into the streaming aggregate; this
        generator never accumulates updates.  Replayed journal records
        are yielded first (they were queued before the socket bound);
        their parties are neither re-spawned nor waited for."""
        expected = [int(p.party_id) for p in parties]
        fault_hook = (self.chaos_plan.coordinator_hook()
                      if self.chaos_plan is not None else None)
        coord = Coordinator(
            expected, host=self.host, port=self.port,
            expected_domains=self._expected_domains(parties, X_public),
            journal_path=self.journal_path, resume=self.resume,
            fault_hook=fault_hook,
        ).start()
        replayed = set(coord.replayed)
        proxy = None
        deliver_port = coord.port
        if self.chaos_plan is not None:
            proxy = ChaosProxy(self.host, coord.port,
                               self.chaos_plan).start()
            deliver_port = proxy.port
        workers = min(max(1, len(parties) - len(replayed)),
                      self.parallelism or 8)
        pool: Optional[ThreadPoolExecutor] = None
        failed: Dict[int, str] = {}
        failed_lock = threading.Lock()
        t0 = time.monotonic()
        try:
            if self.spawn:
                pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="fedkt-party")
                Xpub = np.asarray(X_public)

                def _done(pid):
                    def cb(fut):
                        if fut.cancelled():
                            return
                        err = fut.exception()
                        if err is not None:
                            with failed_lock:
                                failed[pid] = repr(err)
                    return cb

                for party, key in zip(parties, keys):
                    if int(party.party_id) in replayed:
                        continue         # its update already folded
                    fut = pool.submit(
                        _ship_round, party, key, Xpub, num_queries,
                        engine, self.host, deliver_port,
                        self.connect_retries, self.backoff_s,
                        self.io_timeout_s)
                    fut.add_done_callback(_done(int(party.party_id)))

            arrived: List[int] = []
            arrival_s: Dict[int, float] = {}
            bytes_by_party: Dict[int, int] = {}
            quorum = (len(expected) if self.min_parties is None
                      else self.min_parties)
            while len(arrived) < len(expected):
                with failed_lock:
                    nfailed = len(failed)
                if len(arrived) + nfailed == len(expected):
                    break                     # nobody left to wait for
                elapsed = time.monotonic() - t0
                late = (self.deadline_s is not None
                        and elapsed >= self.deadline_s)
                try:
                    # at the deadline, still drain updates that already
                    # landed — only parties with nothing delivered drop
                    upd = coord.updates.get_nowait() if late \
                        else coord.updates.get(timeout=0.05)
                except queue.Empty:
                    if late:
                        break                 # deadline: quorum decides
                    continue
                arrived.append(int(upd.party_id))
                arrival_s[int(upd.party_id)] = round(
                    time.monotonic() - t0, 3)
                bytes_by_party[int(upd.party_id)] = \
                    upd.meta["encoded_bytes"]
                yield upd

            dropped = sorted(set(expected) - set(arrived))
            with failed_lock:
                report_failed = dict(failed)
            if proxy is not None:
                # a relay records some faults (a duplicate's re-ACK)
                # after the coordinator has the frame: join the relays
                # before the report copies the plan's log
                proxy.stop()
                proxy = None
            self.round_report = {
                "port": coord.port,
                "expected": len(expected),
                "arrived": arrived,            # arrival order
                "dropped": dropped,
                "failed": report_failed,       # party_id -> error
                "deadline_s": self.deadline_s,
                "min_parties": self.min_parties,
                "quorum": quorum,
                "framed_bytes": bytes_by_party,
                "arrival_s": arrival_s,
                "rejected": list(coord.errors),
                "journal": self.journal_path,
                "resumed": (coord.journal.resumed
                            if coord.journal is not None else False),
                "replayed_parties": sorted(replayed),
                "corrupt_records_dropped": coord.corrupt_records_dropped,
                "re_acked": dict(coord.re_acked),
                "coordinator_killed": coord.killed,
            }
            if self.chaos_plan is not None:
                self.round_report["chaos"] = list(self.chaos_plan.log)
            if len(arrived) < quorum:
                raise QuorumError(
                    f"round ended with {len(arrived)}/{len(expected)} "
                    f"updates (quorum {quorum}); missing parties "
                    f"{dropped}"
                    + (f"; failures: {report_failed}" if report_failed
                       else ""))
        finally:
            if proxy is not None:
                proxy.stop()
            coord.stop()
            if pool is not None:
                # never block the round on stragglers we already
                # dropped: queued parties are cancelled, running ones
                # get connection-refused when they try to deliver
                pool.shutdown(wait=False, cancel_futures=True)

    def run_round(self, parties, keys, X_public, num_queries, engine):
        """List form of the round for the non-streaming server path
        (Transport contract: party order)."""
        updates = list(self.stream_round(parties, keys, X_public,
                                         num_queries, engine))
        return sorted(updates, key=lambda u: u.party_id)
