"""Continuous-batching inference engine over the ring KV cache
(``repro.serving.engine``).

The one-shot FedKT artifact is a distilled student each silo then
serves to real traffic; this engine is that serving hot path.  It keeps
ONE persistent ``num_slots``-row KV cache (``Model.init_cache``: global
layers linear at ``cache_len``, sliding-window layers as
``window``-slot rings) and runs two steps against it:

  prefill  — new requests, right-padded into a pow2 ``(batch,
             prompt_len)`` bucket, prefill in one dispatch (on the card,
             every layer's attention is one flash-attention kernel
             launch); each request's KV rows are written into its slot
             (``Model.insert_cache``) and its first token is read at
             position ``plen - 1``.
  decode   — every step advances ALL slots at once with a (num_slots,)
             per-slot position vector; finished or empty slots decode
             garbage into their own row, which the next admission's
             insert overwrites.  EOS / token-budget eviction frees the
             slot for the next waiting request.

Both steps only ever see shapes from a closed set, the pow2 prefill
buckets and the single ``(num_slots, 1)`` decode; ``warmup`` runs each
once so that the kernels are built and cuBLAS is warm before traffic.
The cache is updated in place.  Scheduling (FIFO bucket admission, slot
allocation, overflow clamps) lives in ``scheduler.py``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ATTN, ATTN_LOCAL
from repro_torch.core.distill import make_bucket_prefill_step, make_decode_step
from repro_torch.serving.scheduler import RequestState, Scheduler


@dataclass(frozen=True)
class StreamResult:
    """Terminal view of one request: its generated stream + accounting.

    timing keys (seconds): ``ttft`` submit -> first token, ``queue``
    submit -> admission, ``total`` submit -> done; ``token_latencies``
    are per-token gaps (first token measured from admission).
    ``logits`` is the (num_tokens, V) float32 logits each token was read
    from, when the engine keeps them, else None.
    """
    rid: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str
    timing: Dict[str, Any]
    logits: Optional[torch.Tensor] = None

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)


def refusal(cfg) -> Optional[str]:
    """Why ``Engine`` refuses ``cfg`` (a model that ``serve_batch`` must
    serve instead), or None when it serves it: encoder-decoder and
    frontend models, and recurrent blocks, whose state has no length
    axis that a padded bucket's prefill could be corrected along."""
    if cfg.is_encoder_decoder or cfg.frontend_embeds:
        return ("Engine serves decoder-only token models; use "
                "serve_batch for encoder-decoder/frontend configs")
    bad = [k for k in cfg.pattern if k not in (ATTN, ATTN_LOCAL)]
    if bad:
        return (f"recurrent blocks {bad} cannot join padded-bucket "
                "prefill (state has no length axis to correct); use "
                "serve_batch")
    return None


class Engine:
    """Continuous-batching greedy-decode engine for one decoder model.

    Supported configs: decoder-only, attention blocks only (global
    and/or sliding-window), dense or MoE FFNs.  Recurrent blocks and
    encoder-decoder or frontend models are refused up front, as in the
    reference.  MoE configs run, but capacity dropping couples the rows
    of a batch (a token's expert slot depends on the tokens before it),
    so parity with solo ``serve_batch`` runs holds only where no token
    is dropped (a capacity factor of at least E / K), as in the
    reference.
    ``params`` must lie on ``device`` (the card unless "cpu" is asked
    for; asking for the card where there is none raises).
    ``keep_logits`` keeps every emitted token's logits row on the device
    for parity checks.
    """

    def __init__(self, model, params, *, num_slots: int = 8,
                 cache_len: int = 256, eos_id: Optional[int] = None,
                 device=D.DEFAULT, keep_logits: bool = False):
        self.device = D.resolve(device)
        cfg = model.cfg
        why = refusal(cfg)
        if why:
            raise NotImplementedError(why)
        if any(k == ATTN_LOCAL for k in cfg.pattern) \
                and cache_len < cfg.window:
            raise ValueError(
                f"cache_len {cache_len} < window {cfg.window}: the ring "
                "would slide earlier than serve_batch's")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params.device != self.device:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}")

        self.model = model
        self.params = params
        self.eos_id = eos_id
        self.clock = time.perf_counter
        self.keep_logits = keep_logits
        self.scheduler = Scheduler(num_slots=num_slots, cache_len=cache_len)
        self._prefill = make_bucket_prefill_step(model)
        self._decode = make_decode_step(model)
        self._cache = model.init_cache(num_slots, cache_len,
                                       device=self.device)
        # host mirrors of the per-slot decode inputs
        self._slot_tok = np.zeros((num_slots,), np.int64)
        self._slot_pos = np.zeros((num_slots,), np.int64)
        self._logits: Dict[int, List[torch.Tensor]] = defaultdict(list)
        self._steps = 0
        # dispatch counts and the host wall time of every admission
        # (prefill + insert + first-token readback) by (batch, bucket)
        self.dispatches = {"prefill": 0, "decode": 0}
        self.prefill_seconds: Dict[tuple, List[float]] = defaultdict(list)

    # -- introspection ---------------------------------------------------
    @property
    def num_slots(self) -> int:
        return self.scheduler.num_slots

    @property
    def cache_len(self) -> int:
        return self.scheduler.cache_len

    def warmup(self, buckets: Sequence[int] = ()) -> List[tuple]:
        """Runs the decode step and one prefill per (pow2-rounded)
        prompt-length bucket x pow2 batch size up to max_batch, so that
        live traffic never meets a first build or a cold library.
        Returns the (batch, bucket) shapes run.  Not counted in
        ``dispatches``."""
        sched = self.scheduler
        lens = sorted({sched.bucket_of(b) for b in buckets})
        batches = []
        b = 1
        while b <= sched.max_batch:
            batches.append(b)
            b *= 2
        shapes = [(bb, blen) for blen in lens for bb in batches]
        for bb, blen in shapes:
            toks = torch.zeros((bb, blen), dtype=torch.long,
                               device=self.device)
            plens = np.ones((bb,), np.int64)
            slots = np.full((bb,), self.num_slots)        # dropped
            tok, pc, _ = self._prefill(
                self.params, toks, torch.as_tensor(plens, device=self.device))
            self.model.insert_cache(self._cache, pc, slots, plens)
            tok.cpu()
            # before the next bucket's prefill: its cache and this one's
            # would be alive at once (an (8, 5120) bucket of gemma2-27b
            # beside a (4, 5120) one's 7.7 GB)
            del tok, pc
        if lens:  # any warm cache state will do
            out, _, _ = self._decode(self.params, self._tokens(),
                                     self._cache, self._positions())
            out.cpu()
        return shapes

    # -- request API -----------------------------------------------------
    def submit(self, prompt, max_tokens: int = 64) -> RequestState:
        return self.scheduler.submit(prompt, max_tokens,
                                     now=self.clock())

    def step(self) -> List[StreamResult]:
        """One scheduler iteration: admit (at most one bucket) + one
        decode sweep over the slots.  Returns requests finished now."""
        done: List[RequestState] = []
        self._admit(done)
        self._decode_sweep(done)
        self._steps += 1
        return [self._result(r) for r in done]

    def run(self, max_steps: Optional[int] = None) -> List[StreamResult]:
        """Steps until every submitted request finished; results in
        submit (rid) order."""
        out: List[StreamResult] = []
        while not self.scheduler.idle:
            out.extend(self.step())
            if max_steps is not None and self._steps >= max_steps:
                raise RuntimeError(f"not idle after {max_steps} steps")
        return sorted(out, key=lambda r: r.rid)

    def serve(self, prompts, max_tokens: int = 64) -> List[StreamResult]:
        """Convenience closed loop: submit all, run to completion."""
        for p in prompts:
            self.submit(p, max_tokens)
        return self.run()

    # -- internals -------------------------------------------------------
    def _tokens(self):
        return torch.as_tensor(self._slot_tok[:, None], device=self.device)

    def _positions(self):
        return torch.as_tensor(self._slot_pos, device=self.device)

    def _admit(self, done: List[RequestState]):
        adm = self.scheduler.next_admission()
        if adm is None:
            return
        t0 = time.perf_counter()
        b, blen = adm.batch, adm.bucket_len
        toks = np.zeros((b, blen), np.int64)
        plens = np.ones((b,), np.int64)
        # padding rows target the out-of-range slot id -> dropped
        slots = np.full((b,), self.num_slots)
        for i, r in enumerate(adm.reqs):
            toks[i, :r.plen] = r.prompt
            plens[i] = r.plen
            slots[i] = r.slot
        first, pcache, logits = self._prefill(
            self.params, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(plens, device=self.device))
        self.model.insert_cache(self._cache, pcache, slots, plens)
        first = first.cpu().numpy()
        self.dispatches["prefill"] += 1
        self.prefill_seconds[(b, blen)].append(time.perf_counter() - t0)
        now = self.clock()
        for i, r in enumerate(adm.reqs):
            r.t_admit = now
            self._emit(r, int(first[i]), logits[i], now, done)

    def _decode_sweep(self, done: List[RequestState]):
        live = self.scheduler.running
        if not live:
            return
        for r in live:
            self._slot_tok[r.slot] = r.tokens[-1]
            self._slot_pos[r.slot] = r.next_pos
        nxt, self._cache, logits = self._decode(
            self.params, self._tokens(), self._cache, self._positions())
        nxt = nxt.cpu().numpy()[:, 0]
        self.dispatches["decode"] += 1
        now = self.clock()
        for r in list(live):
            self._emit(r, int(nxt[r.slot]), logits[r.slot], now, done)

    def _emit(self, req: RequestState, token: int, logits, now: float,
              done: List[RequestState]):
        req.tokens.append(token)
        req.token_times.append(now)
        if self.keep_logits:
            self._logits[req.rid].append(logits)
        if req.t_first is None:
            req.t_first = now
        finished = (self.eos_id is not None and token == self.eos_id)
        reason = "eos" if finished else "length"
        if finished or len(req.tokens) >= req.max_tokens:
            self.scheduler.evict(req, reason)
            req.t_done = now
            done.append(req)

    def _result(self, req: RequestState) -> StreamResult:
        times = [req.t_admit] + req.token_times
        kept = self._logits.pop(req.rid, None)
        return StreamResult(
            rid=req.rid, prompt_len=req.plen, tokens=list(req.tokens),
            finish_reason=req.finish_reason,
            timing={"ttft": req.t_first - req.t_submit,
                    "queue": req.t_admit - req.t_submit,
                    "total": req.t_done - req.t_submit,
                    "token_latencies": [b - a for a, b
                                        in zip(times, times[1:])]},
            logits=torch.stack(kept) if kept else None)
