"""Transports: HOW a PartyUpdate crosses the party/server boundary
(``repro.federation.transport``; the in-process transport).

Every update is routed through the wire codec — encode on the party
side, decode on the server side — so ``meta["encoded_bytes"]`` is the
measured wire size and the server sees exactly what would cross a
process or host boundary (numpy leaves, moved to the learner's device
when the server runs them).
"""
from __future__ import annotations

from typing import Any, List, Optional, Protocol, Sequence

from repro_torch.federation.codec import decode_update, encode_update
from repro_torch.federation.messages import PartyUpdate


class Transport(Protocol):
    """Pluggable party-execution + message-passing backend."""
    name: str

    def run_round(self, parties: Sequence[Any], keys: Sequence[Any],
                  X_public, num_queries: int,
                  engine) -> List[PartyUpdate]:
        ...

    def close(self) -> None:
        ...


class TransportBase:
    """Context-manager plumbing: ``close`` is idempotent and runs on
    ``with`` exit."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def _decode_annotated(buf: bytes) -> PartyUpdate:
    upd = decode_update(buf)
    upd.meta["encoded_bytes"] = len(buf)
    return upd


def _encoded_round(party, key, X_public, num_queries, engine) -> bytes:
    upd, _ = party.local_round(key, X_public, num_queries, engine)
    return encode_update(upd)


class InProcessTransport(TransportBase):
    """Parties run serially in the caller's process, each update
    through the codec round trip."""
    name = "inprocess"

    def __init__(self, parallelism: Optional[int] = None):
        if parallelism not in (None, 1):
            raise ValueError("the inprocess transport is serial")
        self.parallelism = 1

    def run_round(self, parties, keys, X_public, num_queries, engine):
        return [_decode_annotated(
                    _encoded_round(p, k, X_public, num_queries, engine))
                for p, k in zip(parties, keys)]


_TRANSPORTS = {"inprocess": InProcessTransport}


def get_transport(transport, parallelism: Optional[int] = None) -> Transport:
    """Transport instance from a name ("inprocess") or pass-through of
    an instance."""
    if isinstance(transport, str):
        if transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; "
                             f"available: {sorted(_TRANSPORTS)}")
        return _TRANSPORTS[transport](parallelism=parallelism)
    if parallelism is not None:
        raise ValueError("parallelism= only applies when the transport "
                         "is given by name")
    return transport
