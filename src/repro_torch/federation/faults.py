"""Deterministic fault injection for the socket federation
(``repro.federation.faults``; this package's own copy: the same plans
from the same seeds).

The crash-safety layer (journal.py + the resumable coordinator in
net.py) is only trustworthy if the failure modes it claims to survive
are actually exercised.  This module makes them reproducible:

  Fault       : one scripted failure — what goes wrong on one
                party->coordinator connection, or inside the
                coordinator itself.
  FaultPlan   : connection-ordinal -> Fault, either scripted (pass the
                dict) or seeded-random (``FaultPlan.random``) so a
                chaos soak replays identically from its seed.  At most
                one coordinator-side kill rides alongside.
  ChaosProxy  : an in-path TCP proxy between party clients and the
                real coordinator.  Each inbound connection is assigned
                the next ordinal and its fault (if any) is applied to
                the bytes in flight.

Connection faults and how the stack absorbs them:

  kill_after  : the proxy forwards only the first ``at_byte`` bytes
                and closes both sides — the coordinator sees a
                truncated frame, the party sees a dead socket and
                retries (send-until-ACK).
  corrupt     : byte ``at_byte`` of the frame is flipped in flight —
                the codec's crc32 trailer catches it, the coordinator
                NAKs with reason ``corrupt`` (retryable), the party
                retransmits.
  delay       : the frame is held ``delay_s`` before forwarding —
                exercises deadline/quorum interplay.
  drop_ack    : the frame is delivered and accepted but the ACK never
                reaches the party — the party retransmits identical
                bytes and the coordinator re-ACKs them (idempotent
                delivery; never double-folded).
  duplicate   : after the normal exchange, the SAME frame is delivered
                again on a fresh connection — the coordinator must
                re-ACK without re-folding.

``kill_coordinator`` is not a proxy action: FaultPlan wires it into
the coordinator as a hook that fires AFTER the journal append and
BEFORE the ACK/fold — the exact window crash recovery must cover.  The
coordinator dies without replying; a restart with ``resume=True``
replays the journaled frame and re-ACKs the party's retransmit.

Every fault that fires is recorded in ``plan.log`` (thread-appended),
so a soak run reports what actually happened, not what was scheduled.
A retransmit rides a NEW connection with a new ordinal, so unless the
plan faults that ordinal too, the retry passes clean — every
connection fault above is recoverable by the client's retry loop.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

_LEN = struct.Struct("<I")

CONNECTION_FAULTS = ("kill_after", "corrupt", "delay", "drop_ack",
                     "duplicate")


@dataclass(frozen=True)
class Fault:
    """One scripted failure.

    kind    : one of CONNECTION_FAULTS.
    at_byte : kill_after — forward only this many bytes; corrupt —
              flip this byte of the frame (clamped past the 4-byte
              length prefix: mangling the framing would hang the
              reader, which is a different fault than corruption).
    delay_s : delay — seconds to hold the frame.
    """
    kind: str
    at_byte: int = 0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in CONNECTION_FAULTS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"available: {list(CONNECTION_FAULTS)}")


class FaultPlan:
    """A seeded, scriptable failure schedule for one round.

    faults : connection ordinal (0-based, in proxy accept order) ->
             Fault.  Ordinals not named pass clean — including the
             retransmits earlier faults provoke.
    kill_coordinator_on_party : party id whose journal append kills
             the coordinator (the append->ACK/fold crash window);
             None disables.  Used by the scripted recovery tests, not
             by ``random`` — a dead coordinator ends the round rather
             than degrading it.
    """

    def __init__(self, faults: Mapping[int, Fault] = (), *,
                 kill_coordinator_on_party: Optional[int] = None):
        self.faults: Dict[int, Fault] = dict(faults or {})
        self.kill_coordinator_on_party = kill_coordinator_on_party
        self.log: List[str] = []
        self._log_lock = threading.Lock()

    @classmethod
    def random(cls, seed: int, n_connections: int, *,
               fault_rate: float = 0.25,
               max_delay_s: float = 0.2) -> "FaultPlan":
        """A reproducible chaos schedule: each of the first
        ``n_connections`` ordinals independently draws a connection
        fault with probability ``fault_rate``.  Same seed, same plan —
        a failing soak replays exactly."""
        rng = random.Random(seed)
        faults: Dict[int, Fault] = {}
        for i in range(int(n_connections)):
            if rng.random() < fault_rate:
                kind = CONNECTION_FAULTS[
                    rng.randrange(len(CONNECTION_FAULTS))]
                faults[i] = Fault(kind,
                                  at_byte=8 + rng.randrange(256),
                                  delay_s=rng.random() * max_delay_s)
        return cls(faults)

    def fault_for(self, ordinal: int) -> Optional[Fault]:
        return self.faults.get(int(ordinal))

    def record(self, msg: str) -> None:
        with self._log_lock:
            self.log.append(msg)

    def coordinator_hook(self) -> Optional[Callable[[str, int], bool]]:
        """The coordinator-side injection point: called as
        ``hook(event, party_id)`` at named protocol points; returning
        True at "journaled" kills the coordinator before it ACKs or
        folds (net.Coordinator)."""
        if self.kill_coordinator_on_party is None:
            return None
        target = int(self.kill_coordinator_on_party)

        def hook(event: str, party_id: int) -> bool:
            if event == "journaled" and int(party_id) == target:
                self.record(f"kill_coordinator: party {target} "
                            f"journaled; dying before ACK/fold")
                return True
            return False
        return hook


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_reply(sock: socket.socket) -> bytes:
    """The coordinator's reply: 1 byte (ACK) or 2 (NAK + reason)."""
    first = sock.recv(1)
    if not first:
        return b""
    rest = b""
    if first != b"\x06":
        try:
            rest = sock.recv(1)
        except OSError:
            rest = b""
    return first + rest


class ChaosProxy:
    """In-path TCP chaos proxy for party->coordinator frames.

    Listens on its own ephemeral port; each accepted connection relays
    exactly one length-prefixed frame upstream and the 1-2 byte reply
    back, with the connection's scheduled fault (``plan``) applied in
    flight.  The protocol is strictly request-reply, so the relay is
    sequential per connection — no duplex pumps, fully deterministic
    for scripted plans.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: FaultPlan, *, host: str = "127.0.0.1",
                 port: int = 0, io_timeout_s: float = 60.0):
        self.upstream = (upstream_host, int(upstream_port))
        self.plan = plan
        self.host, self._req_port = host, port
        self.io_timeout_s = io_timeout_s
        self.port: Optional[int] = None
        self.connections = 0
        self._lock = threading.Lock()
        self._stopping = False
        self._lsock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._relays: List[threading.Thread] = []

    def start(self) -> "ChaosProxy":
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.host, self._req_port))
        self._lsock.listen(128)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="fedkt-chaos-proxy")
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                      # listener closed: stop()
            with self._lock:
                ordinal = self.connections
                self.connections += 1
                relay = threading.Thread(target=self._relay,
                                         args=(conn, ordinal),
                                         daemon=True,
                                         name="fedkt-chaos-relay")
                self._relays.append(relay)
            relay.start()

    def _relay(self, party: socket.socket, ordinal: int) -> None:
        fault = self.plan.fault_for(ordinal)
        try:
            party.settimeout(self.io_timeout_s)
            with party, socket.create_connection(
                    self.upstream, timeout=self.io_timeout_s) as coord:
                head = _recv_exact(party, _LEN.size)
                frame = head + _recv_exact(party,
                                           _LEN.unpack(head)[0])
                if fault is not None and fault.kind == "delay":
                    self.plan.record(f"conn {ordinal}: delay "
                                     f"{fault.delay_s:.3f}s")
                    time.sleep(fault.delay_s)
                if fault is not None and fault.kind == "kill_after":
                    cut = max(0, min(fault.at_byte, len(frame) - 1))
                    self.plan.record(f"conn {ordinal}: kill_after "
                                     f"{cut} of {len(frame)} bytes")
                    coord.sendall(frame[:cut])
                    return                  # both sides closed
                if fault is not None and fault.kind == "corrupt":
                    # clamp past the length prefix: mangled framing
                    # hangs the reader instead of testing the crc
                    k = max(_LEN.size,
                            min(fault.at_byte, len(frame) - 1))
                    self.plan.record(f"conn {ordinal}: corrupt byte "
                                     f"{k}")
                    frame = frame[:k] + bytes([frame[k] ^ 0xFF]) \
                        + frame[k + 1:]
                coord.sendall(frame)
                reply = _recv_reply(coord)
                if fault is not None and fault.kind == "drop_ack":
                    self.plan.record(f"conn {ordinal}: drop_ack "
                                     f"(swallowed {reply!r})")
                    return                  # party never sees the ACK
                if reply:
                    party.sendall(reply)
                if fault is not None and fault.kind == "duplicate":
                    # redeliver the SAME (uncorrupted) bytes on a fresh
                    # upstream connection: idempotent delivery means a
                    # re-ACK, and never a double fold
                    with socket.create_connection(
                            self.upstream,
                            timeout=self.io_timeout_s) as dup:
                        dup.sendall(frame)
                        dup_reply = _recv_reply(dup)
                    self.plan.record(f"conn {ordinal}: duplicate "
                                     f"delivery -> {dup_reply!r}")
        except OSError as err:
            self.plan.record(f"conn {ordinal}: relay ended ({err!r})")

    def stop(self) -> None:
        """Closes the listener, then joins the accept thread and every
        relay it started, all within 5 s.  Once it returns, the plan's
        log holds every record a finished relay made (a duplicate's
        re-ACK lands after the coordinator has the frame)."""
        deadline = time.monotonic() + 5.0
        self._stopping = True
        if self._lsock is not None:
            try:
                # wakes the accept() blocked in the proxy thread: on
                # Linux, close() alone leaves it blocked, and the join
                # below would wait out its whole timeout
                self._lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            relays = list(self._relays)
        for relay in relays:
            relay.join(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False
