"""Durable round journal: the coordinator's write-ahead log of frames
(``repro.federation.journal``; this package's own copy, byte for byte
the same file format).

The one-shot protocol's single round is its single point of failure: a
coordinator crash after k of n parties delivered means every silo's
teacher grid retrains.  The journal removes that cliff — each accepted
PartyUpdate's RAW codec frame is appended here, flushed, and fsync'd
BEFORE the coordinator ACKs the party or folds the update, so at every
instant the journal holds every update the protocol has acknowledged.
Because integer vote folding commutes (the invariant the socket path
is built on), replaying the journal reconstructs the streaming
aggregate bit-identically in any order: a restarted coordinator refolds
the journaled parties and waits only for the missing ones
(federation/net.py, tests/test_torch_faults.py).

File format (little-endian throughout):

    header  : magic b"FKTJRNL1"
    record  : uint32 party_id | uint32 crc32(frame) | uint32 nbytes
              | frame (nbytes raw codec bytes, crc trailer included)

Replay semantics (``resume=True``):

  torn tail     : a record cut short by the crash (header or frame
                  bytes missing) is TRUNCATED off the file, so later
                  appends extend the valid prefix — never interleave
                  with garbage.
  corrupt record: a structurally complete record whose frame fails its
                  crc32 is skipped and counted
                  (``corrupt_records_dropped``); its party is NOT
                  marked seen, so a fresh delivery re-journals it.
  duplicates    : the first valid record per party wins; later ones
                  are counted in ``duplicate_records_dropped`` (they
                  can only appear after a corrupt-record recovery).

Idempotent delivery rides on ``frame_matches``: a retransmitted frame
whose bytes equal the journaled ones (exact read-back comparison, not
just the crc) is the lost-ACK case — the coordinator re-ACKs it instead
of NAKing a duplicate, so a party may safely send-until-ACK.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Tuple

MAGIC = b"FKTJRNL1"
_REC = struct.Struct("<III")     # party_id, crc32(frame), nbytes


class JournalError(ValueError):
    """The file is not a round journal, or an append is invalid."""


class JournalExistsError(JournalError):
    """The journal already holds records and ``resume`` was not set —
    refusing to silently fold a previous round's frames."""


class RoundJournal:
    """Append-only write-ahead journal of accepted update frames.

    ``RoundJournal(path)`` starts a FRESH round journal (the file may
    exist but must be empty or absent); ``resume=True`` additionally
    replays an existing file: ``records`` then holds the valid
    ``(party_id, frame)`` pairs in append order, the torn tail (if
    any) is truncated, and subsequent appends continue the same file.

    One writer per file.  ``append`` is called from the coordinator's
    accept loop under the round lock; it returns only after the record
    is flushed AND fsync'd — the caller may then ACK.
    """

    def __init__(self, path, *, resume: bool = False):
        self.path = str(path)
        self.records: List[Tuple[int, bytes]] = []
        self.corrupt_records_dropped = 0
        self.duplicate_records_dropped = 0
        self.truncated_tail = False
        self.resumed = False
        # party_id -> (frame offset, nbytes, crc32): the read-back
        # index for frame_matches — constant memory per party
        self._index: Dict[int, Tuple[int, int, int]] = {}
        size = os.path.getsize(self.path) \
            if os.path.exists(self.path) else 0
        if size:
            if not resume:
                raise JournalExistsError(
                    f"journal {self.path} already holds {size} bytes; "
                    f"pass resume=True (--resume) to replay it into "
                    f"this round, or remove the file to start fresh")
            self._scan(size)
            self.resumed = True
        self._f = open(self.path, "ab")
        if size == 0:
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- replay -----------------------------------------------------------
    def _scan(self, size: int) -> None:
        """Walks the file once: validates the header, crc-checks every
        record, stops at (and truncates) a torn tail."""
        with open(self.path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise JournalError(
                    f"{self.path} is not a FedKT round journal "
                    f"(bad magic)")
            valid_end = len(MAGIC)
            while True:
                rec = f.read(_REC.size)
                if len(rec) < _REC.size:
                    self.truncated_tail = len(rec) > 0
                    break
                pid, crc, nbytes = _REC.unpack(rec)
                frame = f.read(nbytes)
                if len(frame) < nbytes:
                    self.truncated_tail = True
                    break
                if zlib.crc32(frame) != crc:
                    self.corrupt_records_dropped += 1
                elif pid in self._index:
                    self.duplicate_records_dropped += 1
                else:
                    self._index[pid] = (valid_end + _REC.size,
                                        nbytes, crc)
                    self.records.append((pid, frame))
                valid_end += _REC.size + nbytes
        if valid_end < size:
            # torn tail: cut the file back to the last complete record
            # so this round's appends extend a clean prefix
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)

    # -- writing ----------------------------------------------------------
    def append(self, party_id: int, frame: bytes) -> None:
        """Journals one accepted frame; durable (fsync) on return."""
        pid = int(party_id)
        if pid in self._index:
            raise JournalError(f"party {pid} is already journaled; "
                               f"matching retransmits are re-ACKed, "
                               f"never re-appended")
        crc = zlib.crc32(frame)
        off = self._f.tell()
        self._f.write(_REC.pack(pid, crc, len(frame)))
        self._f.write(frame)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._index[pid] = (off + _REC.size, len(frame), crc)

    # -- idempotency ------------------------------------------------------
    @property
    def journaled_parties(self) -> List[int]:
        return sorted(self._index)

    def frame_matches(self, party_id: int, frame: bytes) -> bool:
        """True iff this exact frame is what the journal holds for the
        party — length and crc first (cheap), then an exact read-back
        byte comparison.  The read-back is the load-bearing step: a
        codec-v3 frame ends with the crc32 of its own body, so
        crc32(frame) is the SAME constant residue for every valid
        frame — the cheap check alone could never tell two same-length
        updates apart, and a re-ACK must never ride that."""
        ent = self._index.get(int(party_id))
        if ent is None:
            return False
        off, nbytes, crc = ent
        if len(frame) != nbytes or zlib.crc32(frame) != crc:
            return False
        with open(self.path, "rb") as f:
            f.seek(off)
            return f.read(nbytes) == frame

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RoundJournal":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
