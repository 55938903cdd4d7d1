"""Uniform model interface (``repro.models.registry``) for the decoder
LMs the port serves and trains (attention, RG-LRU and RWKV layers,
dense or MoE FFNs).  Batches are plain dicts with ``tokens`` (B, S), and
for ``loss`` ``labels`` (B, S) and an optional float ``mask`` (B, S),
integer tensors on the parameters' device; a frontend model (llava) may
add ``embeds`` (B, Se, D), prepended to the token embeddings, whose
positions ``loss``, ``predict`` and train-mode ``logits`` drop.
``params`` is a serving ``Transformer`` or a float32 parameter tree
(``transformer.view``): ``loss`` differentiates with respect to a
tree's leaves."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device=D.DEFAULT) -> transformer.Transformer:
        """Random parameters on ``device`` (the card unless "cpu" is
        asked for; raises where there is none), drawn from
        ``generator``, a ``torch.Generator`` on that device (seed 0 when
        None)."""
        dev = D.resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return transformer.init_params(self.cfg, generator, dev)

    def init_tree(self, key, device=D.DEFAULT):
        """A float32 parameter tree from the threefry ``key``, split for
        split as the reference's ``Model.init(key)``."""
        return transformer.init_tree(self.cfg, key, D.resolve(device))

    def hidden(self, params, batch: Dict[str, Any], *, mode="train",
               cache=None, pos=None, remat=False):
        """(hidden (B, S, D), new_cache, aux): S counts the frontend
        positions of ``batch["embeds"]`` too."""
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   embeds=batch.get("embeds"), mode=mode,
                                   cache=cache, pos=pos, remat=remat)

    def loss(self, params, batch, *, remat=True):
        """Mean next-token (or distillation) cross-entropy of a batch,
        plus the MoE blocks' load-balance loss."""
        params = transformer.view(self.cfg, params)
        h, _, aux = self.hidden(params, batch, mode="train", remat=remat)
        h = self._text_hidden(h, batch)
        loss = transformer.lm_loss(self.cfg, params, h, batch["labels"],
                                   batch.get("mask"))
        return loss + aux if self.cfg.moe else loss

    def predict(self, params, batch):
        """Greedy per-token predictions (B, S) int32: the teacher vote."""
        with torch.no_grad():
            params = transformer.view(self.cfg, params)
            h, _, _ = self.hidden(params, batch, mode="train")
            h = self._text_hidden(h, batch)
            return transformer.predict_argmax(self.cfg, params, h)

    def logits(self, params, batch, *, mode="train", cache=None, pos=None):
        """(float32 logits (B, S, V), new_cache); train mode drops the
        frontend positions, prefill keeps them (they are in the
        cache)."""
        h, new_cache, _ = self.hidden(params, batch, mode=mode, cache=cache,
                                      pos=pos)
        if mode == "train":
            h = self._text_hidden(h, batch)
        return transformer.logits_fn(self.cfg, params, h), new_cache

    @staticmethod
    def _text_hidden(h, batch):
        """``h`` without the frontend positions, aligned with the
        tokens and labels."""
        if batch.get("embeds") is not None:
            return h[:, batch["embeds"].shape[1]:]
        return h

    def grow_cache(self, cache, extra_tokens: int):
        """``cache`` with every KV buffer grown by ``extra_tokens`` slots
        (sliding-window layers become rings; recurrent state passes
        through)."""
        return transformer.grow_cache(self.cfg, cache, extra_tokens)

    def insert_cache(self, slot_cache, prefill_cache, slots, plens):
        """Writes each request of a padded-bucket prefill cache into its
        row of the continuous-batching slot cache, in place (see
        ``transformer.insert_cache``)."""
        return transformer.insert_cache(self.cfg, slot_cache, prefill_cache,
                                        slots, plens)

    def init_cache(self, batch_size, cache_len, dtype=None,
                   device=D.DEFAULT):
        return transformer.init_cache(self.cfg, batch_size, cache_len,
                                      dtype, D.resolve(device))

