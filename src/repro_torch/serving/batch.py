"""Fixed-batch serial serving: the engine's parity reference
(``repro.serving.batch``).

``serve_batch`` prefills a (B, P) prompt batch and greedy-decodes
``gen`` steps with every row at the same position.  ``compare_stream``
holds an engine stream to its serial reference under the port's parity
rule (see its docstring).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distill import make_decode_step, make_prefill_step


def effective_tokens(tokens: np.ndarray,
                     eos_id: Optional[int]) -> np.ndarray:
    """Per-row count of generated tokens up to and INCLUDING the first
    EOS (everything after it is decode-loop exhaust, not output)."""
    B, G = tokens.shape
    if eos_id is None:
        return np.full((B,), G, np.int64)
    hit = tokens == eos_id
    first = np.where(hit.any(1), hit.argmax(1), G - 1)
    return first + 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(model, params, prompts: np.ndarray, gen: int,
                eos_id: Optional[int] = None, verbose: bool = True,
                keep_logits: bool = False):
    """prompts: (B, P) integers.  Runs on the parameters' device.
    Returns ((B, gen) generated tokens, stats dict).

    stats: prefill_s / decode_s wall times (host clock after a
    synchronise), generated (EOS-masked token count across the batch),
    tok_per_s (generated / decode_s), and the per-row effective lengths;
    with ``keep_logits``, also "logits": the (B, gen, V) float32 logits
    each token was read from.  The decode loop always runs ``gen`` fixed
    steps; EOS only masks the throughput accounting.
    """
    B, P = prompts.shape
    dev = params.device
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    tokens_in = torch.as_tensor(np.asarray(prompts), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens_in})
    cache = model.grow_cache(cache, gen)
    logits = logits[:, -1]
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out, kept = [], []
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        kept.append(logits)
        tok, cache, logits = decode(params, tok, cache, P + i)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1).cpu().numpy()
    eff = effective_tokens(tokens, eos_id)
    generated = int(eff.sum())
    stats = {
        "batch": B, "prompt_len": P, "gen": gen,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "generated": generated,
        "tok_per_s": generated / max(t_decode, 1e-9),
        "effective_lens": eff.tolist(),
    }
    if keep_logits:
        stats["logits"] = torch.stack(kept, dim=1)
    if verbose:
        print(f"prefill {B}x{P}: {t_prefill:.2f}s; "
              f"decode {gen} steps: {t_decode:.2f}s "
              f"({stats['tok_per_s']:.1f} tok/s over {generated} "
              "EOS-masked tokens)")
    return tokens, stats


def compare_stream(tokens, logits, ref_tokens, ref_logits):
    """Holds a stream to its serial reference, token by token.

    Two runs of the same greedy stream agree up to their logits: a
    product of one row and the same row inside a product of many rows
    round differently (on the CPU and in cuBLAS alike), so the engine's
    logits differ from a solo run's in the last bits, and where the
    solo run's top-1 and top-2 logits are closer than that difference
    the two runs may pick different tokens.  Both runs are identical
    until such a step, and may differ after it (their histories differ).

    ``tokens``/``ref_tokens``: the streams; ``logits``/``ref_logits``:
    (n, V) float32 rows each token was read from.  Returns a dict:
    ``match`` (the streams are identical over the shorter length),
    ``step`` (the first differing step, or None), ``max_diff`` (max |a -
    b| of the logits over the steps up to and including ``step``),
    ``gap`` (the reference's top-1 minus top-2 logit at ``step``) and
    ``explained`` (``gap <= 2 * diff`` at that step, where ``diff`` is
    that step's max |a - b|: the bound within which a flip between the
    two argmaxes is possible at all).
    """
    n = min(len(tokens), len(ref_tokens))
    step = next((i for i in range(n) if tokens[i] != ref_tokens[i]), None)
    upto = n if step is None else step + 1
    a = torch.as_tensor(logits[:upto]).float().cpu()
    b = torch.as_tensor(ref_logits[:upto]).float().cpu()
    diffs = (a - b).abs().amax(dim=-1)
    out = {"match": step is None, "step": step,
           "max_diff": float(diffs.max()) if upto else 0.0,
           "gap": None, "explained": step is None}
    if step is not None:
        top2 = torch.topk(b[step], 2).values
        gap = float(top2[0] - top2[1])
        out["gap"] = gap
        out["explained"] = gap <= 2 * float(diffs[step])
    return out
