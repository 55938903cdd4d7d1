"""Continuous-batching scheduler: padded buckets, slots, admission.

The port's own copy of ``repro.serving.scheduler`` (the reference file
is pure Python, and the port imports nothing of the reference).

Pure-python bookkeeping — no torch.  The ``Engine`` (engine.py) owns the
step functions; everything that decides WHICH requests run
WHERE lives here so the scheduling semantics can be property-tested
without touching a model:

  - pow2 ``(batch, prompt_len)`` buckets: prompts are right-padded to
    the next power of two (floor ``min_bucket``) and admission batches
    are padded to a power of two, so the engine's prefill only ever
    sees shapes from a small closed set, each warmed up once.
  - slot allocation: the decode cache has ``num_slots`` rows; a request
    holds exactly one slot from admission to eviction (EOS or token
    budget), and eviction frees exactly that slot.
  - overflow safety: a slot's position counter may never reach
    ``cache_len`` (global KV rows are linearly addressed), so the
    per-request token budget is clamped to ``cache_len - plen`` at
    submit time.

FIFO-with-bucket-match admission: the oldest waiting request fixes the
prompt-length bucket; every waiting request that rounds to the same
bucket joins (up to the free-slot count and ``max_batch``), later
requests in other buckets wait their turn.  Deterministic by
construction — the parity suite replays arrival orders against it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def round_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    if n < 1 or lo < 1:
        raise ValueError(f"round_pow2 needs positive sizes, got {n}/{lo}")
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass
class RequestState:
    """One generation request, from submit to eviction.

    ``tokens`` accumulates generated ids (the first comes from prefill,
    the rest from decode steps); timing fields are wall-clock seconds
    from the engine's injected clock.  ``pos`` of generated token k is
    ``plen + k`` — decode step k writes KV at ``plen + k - 1``.
    """
    rid: int
    prompt: np.ndarray                      # (plen,) int32
    max_tokens: int                         # clamped token budget
    status: str = "waiting"                 # waiting | running | done
    slot: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None     # "eos" | "length"
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def next_pos(self) -> int:
        """Cache position the next decode step writes: the last emitted
        token's absolute position."""
        return self.plen + len(self.tokens) - 1


@dataclass(frozen=True)
class Admission:
    """One prefill dispatch: ``reqs`` at rows 0..len(reqs)-1 of a
    (batch, bucket_len) padded bucket; rows past len(reqs) are padding
    and target the out-of-range slot id (dropped by the scatter)."""
    reqs: List[RequestState]
    bucket_len: int
    batch: int                              # pow2 >= len(reqs)


class SlotAllocator:
    """Lowest-free-first slot ids — deterministic across runs."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._free = list(range(num_slots))

    @property
    def free(self) -> List[int]:
        return sorted(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        self._free.sort()
        return self._free.pop(0)

    def release(self, slot: int):
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free (double release)")
        self._free.append(slot)


class Scheduler:
    """Waiting queue + slot bookkeeping for the serving engine."""

    def __init__(self, *, num_slots: int, cache_len: int,
                 max_batch: Optional[int] = None, min_bucket: int = 8):
        if num_slots < 1 or cache_len < min_bucket:
            raise ValueError("need >=1 slot and cache_len >= min_bucket")
        max_batch = max_batch or round_pow2(num_slots)
        if max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be pow2, got {max_batch}")
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        # prompts must leave room for at least one generated token
        self.max_prompt = cache_len - 1
        self.slots = SlotAllocator(num_slots)
        self.waiting: List[RequestState] = []
        self.running: List[RequestState] = []
        self._rid = itertools.count()

    # -- submit ----------------------------------------------------------
    def submit(self, prompt, max_tokens: int, now: float = 0.0,
               rid: Optional[int] = None) -> RequestState:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 1 <= prompt.shape[0] <= self.max_prompt:
            raise ValueError(
                f"prompt length {prompt.shape[0]} not in "
                f"[1, {self.max_prompt}] (cache_len {self.cache_len})")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        # overflow clamp: positions stay strictly below cache_len
        budget = min(max_tokens, self.cache_len - prompt.shape[0])
        req = RequestState(
            rid=next(self._rid) if rid is None else rid, prompt=prompt,
            max_tokens=budget, t_submit=now)
        self.waiting.append(req)
        return req

    # -- admission -------------------------------------------------------
    def bucket_of(self, plen: int) -> int:
        """pow2 rounding, capped at cache_len (the bucket must fit the
        slot rows; the cap only binds for non-pow2 cache lengths)."""
        return min(round_pow2(plen, self.min_bucket), self.cache_len)

    def next_admission(self) -> Optional[Admission]:
        """FIFO head fixes the bucket; same-bucket followers join."""
        free = len(self.slots.free)
        if not self.waiting or free == 0:
            return None
        bucket = self.bucket_of(self.waiting[0].plen)
        take = min(free, self.max_batch)
        reqs = [r for r in self.waiting
                if self.bucket_of(r.plen) == bucket][:take]
        for r in reqs:
            self.waiting.remove(r)
            r.slot = self.slots.acquire()
            r.status = "running"
            self.running.append(r)
        return Admission(reqs=reqs, bucket_len=bucket,
                         batch=round_pow2(len(reqs)))

    # -- eviction --------------------------------------------------------
    def evict(self, req: RequestState, reason: str):
        if req.status != "running":
            raise ValueError(f"evicting non-running request {req.rid}")
        req.status = "done"
        req.finish_reason = reason
        self.running.remove(req)
        self.slots.release(req.slot)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running
