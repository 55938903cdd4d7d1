"""The serve steps of ``repro.core.distill``: prefill and greedy decode
for a trained model (the label and train steps are not ported yet).

Each step runs under ``torch.inference_mode`` and returns, beside the
reference's outputs, the float32 logits its tokens were read from, so
that parity checks can measure how far two runs' logits are apart.
Greedy argmax takes the first of equal maxima, as ``jnp.argmax``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import Model, transformer


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill(params, batch):
        """Returns (last-position logits (B, 1, V), linear cache)."""
        logits, cache = model.logits(params, batch, mode="prefill")
        return logits[:, -1:], cache

    return prefill


def make_decode_step(model: Model) -> Callable:
    """Greedy decode step.  ``pos`` may be an int (every row at the same
    position — the fixed-batch ``serve_batch`` path) or a (B,) integer
    tensor of per-row positions (the continuous-batching engine).  The
    cache is updated in place."""
    @torch.inference_mode()
    def decode(params, token, cache, pos):
        """Returns (next token (B, 1), cache, logits (B, V))."""
        logits, cache = model.logits(params, {"tokens": token},
                                     mode="decode", cache=cache, pos=pos)
        logits = logits[:, -1]
        return torch.argmax(logits, dim=-1)[:, None], cache, logits

    return decode


def make_bucket_prefill_step(model: Model) -> Callable:
    """Prefill over a right-padded (b, Pb) prompt bucket.

    Each row's true prompt length ``plens[i] <= Pb`` picks the hidden
    state the first generated token is read from: with causal attention
    position plens[i]-1 never attends a pad.  Returns (first token (b,),
    the linear prefill cache with all Pb entries, logits (b, V)); the
    engine's ``Model.insert_cache`` places the cache."""
    @torch.inference_mode()
    def prefill(params, tokens, plens):
        h, cache = model.hidden(params, {"tokens": tokens}, mode="prefill")
        last = h[torch.arange(h.shape[0], device=h.device), plens - 1]
        logits = transformer.logits_fn(model.cfg, params, last[:, None])[:, 0]
        return torch.argmax(logits, dim=-1), cache, logits

    return prefill
