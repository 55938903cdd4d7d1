"""Wire codec for the federation protocol: states <-> bytes.

The counterpart of ``repro.federation.codec``, frame for frame: a
PartyUpdate encoded here is byte-identical to the reference's encoding
of the same states, and each package decodes the other's frames.

    MAGIC "FKT" | version byte | uint32 header_len | header JSON
                | payload | uint32 crc32 trailer          (v3)

The header carries the tree structure (dict/list/tuple/None nesting,
leaves referenced by their '/'-joined key path) plus per-leaf
shape/dtype/offset; the payload is the raw leaf bytes in sorted-path
order.  Tensor leaves are copied to the host and written as their
numpy equivalents; decoded leaves come back as numpy arrays.  Frames
must be exact: a truncated, corrupted, padded or foreign-version frame
raises a typed ``CodecError`` (a ValueError).
"""
from __future__ import annotations

import functools
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.federation.domain import VoteDomain
from repro_torch.federation.messages import (PartyUpdate, ShapeDtype,
                                             TokenLabels, label_wire_bytes)
from repro_torch.tree_util import SEP, flatten_tree

MAGIC = b"FKT"
VERSION = 3          # v2 added the version byte itself; v3 the crc32
#                      trailer (v2 frames still decode — no trailer)
_DECODABLE = (2, VERSION)
_PREFIX = MAGIC + bytes([VERSION])
_LEN = struct.Struct("<I")
_CRC = struct.Struct("<I")
_CRC_CHUNK = 1 << 26   # bytes a worker's crc32 piece (a larger frame splits)


class CodecError(ValueError):
    """Base for every refusal to decode a frame."""


class TruncatedFrameError(CodecError):
    """The frame was cut short."""


class CorruptFrameError(CodecError):
    """The frame is the right length but its bytes are damaged."""


class VersionMismatchError(CodecError):
    """The frame speaks a codec version this peer cannot decode."""


def _host(leaf):
    """A leaf as something with a shape and a dtype: tensors are copied
    to the host, meta tensors (shapes only) become ShapeDtype stand-ins
    with their torch dtype, ShapeDtype stand-ins pass through, scalars
    become arrays."""
    if isinstance(leaf, torch.Tensor):
        if leaf.is_meta:
            return ShapeDtype(tuple(leaf.shape), leaf.dtype)
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, ShapeDtype):
        return leaf
    return np.asarray(leaf)


def _dtype_info(dtype) -> Tuple[str, int]:
    """(the header's dtype name, bytes an element) of a numpy or torch
    dtype: torch.bfloat16 is "bfloat16", as ml_dtypes names it in the
    reference's frames."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch."), dtype.itemsize
    dt = np.dtype(dtype)
    return dt.name, dt.itemsize


def _structure(tree, path: List[str]) -> Any:
    """JSON-able structure descriptor; leaves reference their path."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = list(tree)
        for k in keys:
            if not isinstance(k, str) or SEP in k:
                raise TypeError(f"codec requires {SEP!r}-free string "
                                f"dict keys, got {k!r}")
        return {"t": "dict", "k": keys,
                "c": [_structure(tree[k], path + [k]) for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"t": kind,
                "c": [_structure(v, path + [str(i)])
                      for i, v in enumerate(tree)]}
    return {"t": "leaf", "p": SEP.join(path)}


def _header(tree, extra: Dict[str, Any] = None) -> Tuple[bytes, list]:
    """(header bytes, [(path, leaf)] in payload order)."""
    flat = {p: _host(leaf) for p, leaf in flatten_tree(tree).items()}
    order = sorted(flat)
    leaves, off = [], 0
    for p in order:
        leaf = flat[p]
        shape = tuple(int(d) for d in leaf.shape)
        name, itemsize = _dtype_info(leaf.dtype)
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        leaves.append({"p": p, "shape": list(shape), "dtype": name,
                       "off": off, "n": n})
        off += n
    header = {"v": 1, "tree": _structure(tree, []), "leaves": leaves,
              **(extra or {})}
    return (json.dumps(header, sort_keys=True).encode("utf-8"),
            [(p, flat[p]) for p in order])


def _gf2_times(mat, vec: int) -> int:
    """A 32 x 32 GF(2) matrix (its columns, as ints) times a vector."""
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=None)
def _crc_shift(nbytes: int):
    """The operator that moves a crc32 past ``nbytes`` more bytes: the
    crc of a then b is ``_gf2_times(_crc_shift(len(b)), crc(a)) ^
    crc(b)`` (zlib's crc32_combine), from the one-bit operator by
    squaring."""
    result = [1 << i for i in range(32)]
    power = [0xEDB88320] + [1 << i for i in range(31)]
    n = 8 * nbytes
    while n:
        if n & 1:
            result = [_gf2_times(power, col) for col in result]
        n >>= 1
        if n:
            power = [_gf2_times(power, col) for col in power]
    return result


def _crc32(parts) -> int:
    """``zlib.crc32`` of the parts joined, without joining them: in
    pieces of ``_CRC_CHUNK`` bytes (the first takes the remainder),
    each on a worker thread (zlib releases the GIL), chained by
    ``_crc_shift``.  A frame of full-width students hashes on every
    core of the host."""
    views = [memoryview(p).cast("B") for p in parts]
    total = sum(len(v) for v in views)
    cuts = [total % _CRC_CHUNK or min(total, _CRC_CHUNK)]
    while cuts[-1] < total:
        cuts.append(cuts[-1] + _CRC_CHUNK)
    pieces, piece, start = [], [], 0
    for v in views:
        off = 0
        while off < len(v):
            take = min(len(v) - off, cuts[len(pieces)] - start)
            piece.append(v[off:off + take])
            off, start = off + take, start + take
            if start == cuts[len(pieces)]:
                pieces.append(piece)
                piece = []

    def crc_of(bufs):
        crc = 0
        for b in bufs:
            crc = zlib.crc32(b, crc)
        return crc

    if len(pieces) <= 1:
        return crc_of(pieces[0] if pieces else [])
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        crcs = list(pool.map(crc_of, pieces))
    shift = _crc_shift(_CRC_CHUNK)
    crc = crcs[0]
    for c in crcs[1:]:
        crc = _gf2_times(shift, crc) ^ c
    return crc


def encode(tree, extra_header: Dict[str, Any] = None) -> bytes:
    """Serializes a state into one self-describing buffer, crc32 of
    everything before it in the 4-byte trailer.  Each leaf's host copy
    is joined into the frame as it is (its bytes viewed, not copied
    again) and the crc32 runs over the parts (``_crc32``), so a frame
    of full-width students is copied once from the leaves."""
    hdr, ordered = _header(tree, extra_header)
    parts = [_PREFIX, _LEN.pack(len(hdr)), hdr]
    parts += [np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
              for _, leaf in ordered]
    return b"".join(parts + [_CRC.pack(_crc32(parts))])


def encoded_nbytes(tree, extra_header: Dict[str, Any] = None) -> int:
    """Exact wire size of ``encode(tree)``, from leaf shapes/dtypes only
    (ShapeDtype leaves price a message without its arrays)."""
    hdr, ordered = _header(tree, extra_header)
    payload = sum(int(np.prod(leaf.shape, dtype=np.int64))
                  * _dtype_info(leaf.dtype)[1] for _, leaf in ordered)
    return len(_PREFIX) + _LEN.size + len(hdr) + payload + _CRC.size


def decode(buf: bytes) -> Tuple[Any, Dict[str, Any]]:
    """Inverse of ``encode``: (state of numpy arrays, header dict).
    Raises a typed CodecError on a frame that is not ours, speaks a
    version this peer cannot decode, was cut short, carries trailing
    bytes, or fails its crc32."""
    if buf[:len(MAGIC)] != MAGIC:
        raise CodecError("not a federation codec buffer (bad magic)")
    if len(buf) < len(_PREFIX) + _LEN.size:
        raise TruncatedFrameError(
            f"truncated codec frame: {len(buf)} bytes is shorter than "
            f"the fixed prefix")
    version = buf[len(MAGIC)]
    if version not in _DECODABLE:
        raise VersionMismatchError(
            f"codec version mismatch: frame speaks v{version}, "
            f"this peer speaks v{VERSION} (and still decodes "
            f"v{_DECODABLE[0]})")
    trailer = _CRC.size if version >= 3 else 0
    hlen = _LEN.unpack_from(buf, len(_PREFIX))[0]
    start = len(_PREFIX) + _LEN.size
    if len(buf) < start + hlen + trailer:
        raise TruncatedFrameError(
            f"truncated codec frame: header says {hlen} bytes but only "
            f"{len(buf) - start} follow the prefix")
    try:
        header = json.loads(buf[start:start + hlen].decode("utf-8"))
    except ValueError as err:
        raise CorruptFrameError(
            f"corrupt codec frame: header is not parseable JSON "
            f"({err})") from err
    base = start + hlen
    try:
        payload = max((leaf["off"] + leaf["n"]
                       for leaf in header["leaves"]), default=0)
    except (KeyError, TypeError) as err:
        raise CorruptFrameError(
            f"corrupt codec frame: header carries no well-formed leaf "
            f"table ({err!r})") from err
    if len(buf) < base + payload + trailer:
        raise TruncatedFrameError(
            f"truncated codec frame: payload needs {payload} bytes "
            f"(+{trailer} trailer), frame carries {len(buf) - base}")
    if len(buf) != base + payload + trailer:
        raise CorruptFrameError(
            f"corrupt codec frame: {len(buf) - base - payload - trailer} "
            f"trailing bytes beyond the "
            f"{'crc trailer' if trailer else 'payload'}")
    if trailer:
        stored = _CRC.unpack_from(buf, base + payload)[0]
        computed = _crc32([memoryview(buf)[:base + payload]])
        if stored != computed:
            raise CorruptFrameError(
                f"corrupt codec frame: crc32 trailer says "
                f"0x{stored:08x} but the frame hashes to "
                f"0x{computed:08x}")
    arrays = {}
    for leaf in header["leaves"]:
        dtype = np.dtype(leaf["dtype"])
        count = int(np.prod(leaf["shape"], dtype=np.int64))
        arr = np.frombuffer(buf, dtype=dtype, count=count,
                            offset=base + leaf["off"])
        arrays[leaf["p"]] = arr.reshape(leaf["shape"]).copy()

    def rebuild(spec):
        t = spec["t"]
        if t == "none":
            return None
        if t == "dict":
            return {k: rebuild(c) for k, c in zip(spec["k"], spec["c"])}
        if t == "list":
            return [rebuild(c) for c in spec["c"]]
        if t == "tuple":
            return tuple(rebuild(c) for c in spec["c"])
        return arrays[spec["p"]]

    return rebuild(header["tree"]), header


# ---------------------------------------------------------------------------
# PartyUpdate framing
# ---------------------------------------------------------------------------
def _update_tree(update: PartyUpdate):
    return {"student_states": update.student_states,
            "vote_gaps": update.vote_gaps}


def _update_extra(update: PartyUpdate) -> Dict[str, Any]:
    domain = update.domain
    return {"kind": "PartyUpdate", "party_id": int(update.party_id),
            "num_examples": int(update.num_examples),
            "learner_kind": update.learner_kind,
            "domain": domain.to_wire() if domain is not None else None,
            "meta": dict(update.meta)}


def encode_update(update: PartyUpdate) -> bytes:
    """The PartyUpdate message: student states AND the vote-gap trace
    in the payload, scalar fields in the header."""
    return encode(_update_tree(update), _update_extra(update))


def decode_update(buf: bytes) -> PartyUpdate:
    tree, header = decode(buf)
    if header.get("kind") != "PartyUpdate":
        raise ValueError(f"expected a PartyUpdate message, "
                         f"got kind={header.get('kind')!r}")
    return PartyUpdate(party_id=header["party_id"],
                       student_states=tree["student_states"],
                       vote_gaps=tree["vote_gaps"],
                       num_examples=header["num_examples"],
                       learner_kind=header.get("learner_kind"),
                       domain=VoteDomain.from_wire(header.get("domain")),
                       meta=dict(header["meta"]))


def update_encoded_nbytes(update: PartyUpdate) -> int:
    """Measured wire size of one PartyUpdate (header + payload)."""
    return encoded_nbytes(_update_tree(update), _update_extra(update))


# ---------------------------------------------------------------------------
# TokenLabels framing (the vote-answer message kind)
# ---------------------------------------------------------------------------
def _labels_extra(msg: TokenLabels) -> Dict[str, Any]:
    return {"kind": "TokenLabels", "party_id": int(msg.party_id),
            "meta": dict(msg.meta)}


def encode_labels(msg: TokenLabels) -> bytes:
    """The vote-answer message: voted int32 labels in the payload."""
    return encode({"labels": msg.labels}, _labels_extra(msg))


def decode_labels(buf: bytes) -> TokenLabels:
    tree, header = decode(buf)
    if header.get("kind") != "TokenLabels":
        raise ValueError(f"expected a TokenLabels message, "
                         f"got kind={header.get('kind')!r}")
    return TokenLabels(party_id=header["party_id"], labels=tree["labels"],
                       meta=dict(header["meta"]))


def labels_encoded_nbytes(msg: TokenLabels) -> int:
    """Measured wire size of one TokenLabels message (header +
    payload); ShapeDtype labels price it without an array."""
    return encoded_nbytes({"labels": msg.labels}, _labels_extra(msg))


def lm_protocol_bytes(member_state, num_members: int, batch: int,
                      seq: int) -> Dict[str, int]:
    """Priced wire cost of the LM-scale one round, per member: its
    PartyUpdate-framed state upload (once) and the TokenLabels answer
    for a (batch, seq) public block.  ``member_state`` may be a tree of
    meta tensors (``Model.init_shapes``) or ShapeDtype leaves: every
    number is the codec's exact framed size (header included), equal
    to ``len(encode_*(...))`` of the real message."""
    upd = PartyUpdate(
        party_id=0, student_states=[member_state],
        vote_gaps=ShapeDtype((batch * seq,), np.float32),
        num_examples=0, meta={"num_teachers": num_members})
    lbl = TokenLabels(party_id=0,
                      labels=ShapeDtype((batch, seq), np.int32))
    return {
        "members": num_members,
        "update_bytes_per_member": update_encoded_nbytes(upd),
        "update_payload_bytes_per_member": upd.wire_bytes(),
        "label_bytes": labels_encoded_nbytes(lbl),
        "label_payload_bytes": label_wire_bytes(batch * seq),
    }
