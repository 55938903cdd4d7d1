"""Uniform model interface (``repro.models.registry``) over the archs
the port serves and trains: decoder LMs (attention, RG-LRU and RWKV
layers, dense or MoE FFNs) and the encoder-decoder (``encdec``).
Batches are plain dicts with ``tokens`` (B, S), and for ``loss``
``labels`` (B, S) and an optional float ``mask`` (B, S), integer tensors
on the parameters' device; a frontend model (llava) may add ``embeds``
(B, Se, D), prepended to the token embeddings, whose positions
``loss``, ``predict`` and train-mode ``logits`` drop; an
encoder-decoder (whisper) takes ``frames`` (B, Sf, D), the encoder's
input.  ``params`` is a serving module or a float32 parameter tree
(``transformer.view``): ``loss`` differentiates with respect to a
tree's leaves."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device=D.DEFAULT) -> torch.nn.Module:
        """Random parameters on ``device`` (the card unless "cpu" is
        asked for; raises where there is none), drawn from
        ``generator``, a ``torch.Generator`` on that device (seed 0 when
        None)."""
        dev = D.resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if self.cfg.is_encoder_decoder:
            return encdec.init_params(self.cfg, generator, dev)
        return transformer.init_params(self.cfg, generator, dev)

    def init_tree(self, key, device=D.DEFAULT):
        """A parameter tree in ``cfg.param_dtype`` from the threefry
        ``key``, split for split as the reference's ``Model.init(key)``."""
        if self.cfg.is_encoder_decoder:
            return encdec.init_tree(self.cfg, key, D.resolve(device))
        return transformer.init_tree(self.cfg, key, D.resolve(device))

    def init_shapes(self):
        """``init_tree``'s tree with meta tensors for leaves: shapes and
        dtypes only (``jax.eval_shape(model.init)``)."""
        return transformer.init_shapes(self.cfg)

    def cache_shapes(self, batch_size, cache_len, dtype=None):
        """``init_cache``'s cache with meta tensors for leaves (an
        encoder-decoder's cross K/V at the encoder's length)."""
        return self.init_cache(batch_size, cache_len, dtype, device="meta")

    def hidden(self, params, batch: Dict[str, Any], *, mode="train",
               cache=None, pos=None, remat=False):
        """(hidden (B, S, D), new_cache, aux): S counts the frontend
        positions of ``batch["embeds"]`` too.  An encoder-decoder
        encodes ``batch["frames"]`` when the batch has them (train and
        prefill; a decode step reads the cross K/V from its cache)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            params = transformer.view(cfg, params)
            frames = batch.get("frames")
            enc_out = None if frames is None else \
                encdec.encode(cfg, params, frames)
            return encdec.decode_forward(cfg, params, batch["tokens"],
                                         enc_out, mode=mode, cache=cache,
                                         pos=pos, remat=remat)
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
        through; an encoder-decoder's cross K/V never grow)."""
        if self.cfg.is_encoder_decoder:
            return encdec.grow_cache(self.cfg, cache, extra_tokens)
        return transformer.grow_cache(self.cfg, cache, extra_tokens)

    def insert_cache(self, slot_cache, prefill_cache, slots, plens):
        """Writes each request of a padded-bucket prefill cache into its
        row of the continuous-batching slot cache, in place (see
        ``transformer.insert_cache``); decoder-only models only."""
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError("slot-cache serving is decoder-only")
        return transformer.insert_cache(self.cfg, slot_cache, prefill_cache,
                                        slots, plens)

    def init_cache(self, batch_size, cache_len, dtype=None, enc_out=None,
                   params=None, device=D.DEFAULT):
        """Zero caches of ``cache_len`` slots on ``device``; an
        encoder-decoder's also holds the cross K/V of ``enc_out`` (with
        ``params``; zeros without), on ``enc_out``'s device."""
        if self.cfg.is_encoder_decoder:
            dev = enc_out.device if enc_out is not None else \
                D.resolve(device)
            params = None if params is None else \
                transformer.view(self.cfg, params)
            return encdec.init_dec_cache(self.cfg, batch_size, cache_len,
                                         enc_out, params, dtype, dev)
        return transformer.init_cache(self.cfg, batch_size, cache_len,
                                      dtype, D.resolve(device))



def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
