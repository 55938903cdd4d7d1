"""Meta-device input stand-ins for every (arch x input-shape) pair
(``repro.launch.inputs``).

Nothing is allocated here: every leaf is a tensor on the meta device,
which has a shape and a dtype and no data.  These are the inputs the
dry-run traces its steps on.  Modality frontends are stubbed as in the
reference: llava gets pre-projected ``embeds`` (its anyres patches),
whisper gets ``frames`` (the conv frontend's output, (B, 1500, d)); the
embeds take part of the nominal sequence budget.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as D
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import Model
from repro_torch.models.layers import dtype_of
from repro_torch.tree_util import tree_map


def sds(shape, dtype):
    """A meta tensor of ``shape`` and ``dtype`` (a torch dtype or its
    name): the port's ``jax.ShapeDtypeStruct``."""
    dt = dtype_of(dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dt, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.dtype)
    batch: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        batch["frames"] = sds((B, cfg.encoder_seq_len, cfg.d_model), act)
        batch["tokens"] = sds((B, S), torch.int32)
        batch["labels"] = sds((B, S), torch.int32)
    elif cfg.frontend_embeds:
        St = S - cfg.frontend_embeds
        if St <= 0:
            raise ValueError("sequence shorter than frontend embeds")
        batch["embeds"] = sds((B, cfg.frontend_embeds, cfg.d_model), act)
        batch["tokens"] = sds((B, St), torch.int32)
        batch["labels"] = sds((B, St), torch.int32)
    else:
        batch["tokens"] = sds((B, S), torch.int32)
        batch["labels"] = sds((B, S), torch.int32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape):
    b = train_batch_specs(cfg, shape)
    b.pop("labels", None)
    return b


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(token, cache, pos) stand-ins for one decode step with a
    ``seq_len`` cache (window-bounded ring caches for local-attention
    layers; recurrent layers carry O(1) states)."""
    B, S = shape.global_batch, shape.seq_len
    cache = Model(cfg).cache_shapes(B, S, dtype=dtype_of(cfg.dtype))
    token = sds((B, 1), torch.int32)
    pos = sds((), torch.int32)
    return token, cache, pos


def concrete_like(spec_tree, seed=0, device=D.DEFAULT):
    """Zeros matching a spec tree, on ``device`` (the card unless the
    caller names another; tests pass "cpu").  ``seed`` is the
    reference's argument, unused there too."""
    dev = D.resolve(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=dev), spec_tree)
