"""LM-scale FedKT steps (``repro.core.distill``): training, labelling
and serving.

  train_step — student / final model update on (voted) labels: CE,
               AdamW, global-norm clip, warmup-cosine schedule, with
               optional gradient accumulation over microbatches.
  label_step — the teacher/student ensemble greedily predicts the
               public batch, member by member, and the token vote folds
               the predictions (the vote kernel on the card).
  serve steps — prefill / decode for the trained final model.

Parameters are float32 trees (``models.transformer``); the train step
casts them to ``cfg.dtype`` inside the differentiated function, as the
reference's ``pregather_params`` does without a mesh, so the gradients
land on the float32 masters.  The gradients are clipped in place and
the update is written into the tree and the optimizer state in place
(``Optimizer.update_``): the step returns the same objects it was
given.

The serve steps run under ``torch.inference_mode`` and return, beside
the reference's outputs, the float32 logits their tokens were read
from, so that parity checks can measure how far two runs' logits are
apart.  Greedy argmax takes the first of equal maxima, as
``jnp.argmax``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.voting import token_teacher_vote
from repro_torch.models import Model, transformer
from repro_torch.optim import clip_scale, get as get_opt, warmup_cosine
from repro_torch.tree_util import tree_leaves, tree_map


def _leaf_grads(loss, tree):
    """d loss / d every leaf of ``tree``, as a tree; zeros for a leaf
    the loss does not read (a parallel block's norm2), as ``jax.grad``
    gives."""
    leaves = tree_leaves(tree)
    by_leaf = {id(t): g for t, g in
               zip(leaves, torch.autograd.grad(loss, leaves,
                                               materialize_grads=True))}
    return tree_map(lambda t: by_leaf[id(t)], tree)


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """(train_step, optimizer).  ``train_step(params, opt_state, batch)``
    -> (params, opt_state, {"loss", "grad_norm", "lr"}), ``params`` a
    float32 tree and ``batch`` {"tokens", "labels"[, "mask"][, "frames"
    or "embeds"]} tensors on its device.  ``tcfg.microbatches`` m > 1
    splits every entry of the batch into m row blocks and averages
    their losses and gradients, taken with respect to ONE cast copy of
    the parameters (as the reference, which accumulates in
    ``cfg.dtype`` and promotes to float32 once)."""
    opt = get_opt(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    sched = warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps,
                          max(tcfg.steps, 1))
    dtypes = transformer.param_dtypes(model.cfg)
    m = tcfg.microbatches

    def apply(grads, loss, params, opt_state):
        scale, gnorm = clip_scale(grads, tcfg.grad_clip)
        with torch.no_grad():
            for g in tree_leaves(grads):
                g.mul_(scale)
        lr = sched(opt_state.step + 1)   # the step counts from 0
        params, opt_state = opt.update_(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": gnorm, "lr": lr}

    def train_step(params, opt_state, batch):
        if m <= 1:
            leaves = _requiring_grad(params)
            loss = model.loss(leaves, batch, remat=tcfg.remat)
            grads = _leaf_grads(loss, leaves)
            del leaves
            return apply(grads, loss, params, opt_state)
        # one cast copy, differentiated microbatch by microbatch
        pc = tree_map(lambda t, dt: t.detach().to(dt).requires_grad_(True),
                      params, dtypes)
        mbs = [{k: x.chunk(m)[i] for k, x in batch.items()}
               for i in range(m)]
        loss, acc = torch.zeros((), device=batch["tokens"].device), None
        for mb in mbs:
            lm = model.loss(pc, mb, remat=tcfg.remat)
            g = _leaf_grads(lm, pc)
            loss = loss + lm.detach() / m
            acc = tree_map(lambda x: x / m, g) if acc is None else \
                tree_map(lambda a, x: a + x / m, acc, g)
        del pc
        grads = tree_map(lambda g: g.to(torch.float32), acc)
        return apply(grads, loss, params, opt_state)

    return train_step, opt


def make_label_step(model: Model, num_members: int,
                    gamma: float = 0.0) -> Callable:
    """FedKT vote step over ``num_members`` parameter sets (a sequence
    of trees or modules).  ``label_step(members, batch, key=None)`` ->
    (labels (B, S) int32, clean gaps (B, S) float32).  The members
    predict one after another: a ctypes kernel cannot be batched by
    ``torch.func.vmap``, and the reference's contract is bit-for-bit
    the serial per-member predicts anyway."""
    from repro_torch.federation.domain import token_domain

    def label_step(members, batch, key=None):
        if len(members) != num_members:
            raise ValueError(f"label step built for {num_members} members, "
                             f"got {len(members)}")
        preds = torch.stack([model.predict(p, batch) for p in members])
        dom = token_domain(preds.shape[1] * preds.shape[2],
                           model.cfg.vocab_size)
        return token_teacher_vote(preds, dom, gamma=gamma, key=key)

    return label_step


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
        h, cache, _ = model.hidden(params, {"tokens": tokens},
                                   mode="prefill")
        last = h[torch.arange(h.shape[0], device=h.device), plens - 1]
        logits = transformer.logits_fn(model.cfg, params, last[:, None])[:, 0]
        return torch.argmax(logits, dim=-1), cache, logits

    return prefill
