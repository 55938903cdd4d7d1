"""States carried across between the JAX reference and this package.

A reference state is nested tuples, lists and dicts of arrays (numpy,
or anything numpy can read through ``np.asarray``); the port's state is
the same structure with tensors.  For the tree learners that is an RF
``((split_feat, split_bin, leaf), edges)`` or a GBDT ``(trees, edges)``.
Both directions keep the tree structure and the dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.tree_util import tree_map


def from_reference(tree, device=D.DEFAULT):
    """Reference state -> the port's: every leaf a tensor on
    ``device`` with its dtype."""
    dev = D.resolve(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(dev), tree)


def to_reference(tree):
    """The port's state -> a reference state of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------
def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: torch cannot read it
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _layers(cfg, tree):
    """The reference's per-layer subtrees in layer order: the periods
    (every leaf stacked on axis 0 by ``jax.vmap``), then the unrolled
    tail.  MoE's ``head_blocks`` are not ported."""
    n = len(cfg.pattern)
    out = []
    for p in range(cfg.num_periods):
        for j in range(n):
            out.append(tree_map(lambda a, p=p: np.asarray(a)[p],
                                tree["periods"][f"b{j}"]))
    return out + list(tree["tail"])


def _fill(module, tree):
    """Copies a reference dict subtree into the module attributes of the
    same names, each cast to the attribute's dtype."""
    for name, sub in tree.items():
        target = getattr(module, name)
        if isinstance(sub, dict):
            _fill(target, sub)
        else:
            target.data.copy_(_tensor(sub).to(target.dtype))


def lm_params_from_reference(cfg, params, device=D.DEFAULT):
    """The reference's decoder-LM parameter pytree (arrays numpy can
    read) -> the port's ``Transformer`` on ``device``.  Periods (and a
    recurrent tail, as recurrentgemma's) are unstacked into layers;
    every matrix keeps its ``x @ W`` orientation.  Each parameter takes
    the dtype of the port's module: ``cfg.dtype`` where the reference
    casts it to the activations' dtype at each use, float32 where it
    reads it in float32 (RG-LRU's w_a, w_x, lam; RWKV's w0, u,
    ln_scale), ``cfg.param_dtype`` for norm parameters."""
    from repro_torch.models.transformer import Transformer
    dev = D.resolve(device)
    if params.get("head_blocks"):
        raise NotImplementedError("MoE head blocks are not ported yet")
    model = Transformer(cfg, dev)
    _fill(model.embed, params["embed"])
    _fill(model.final_norm, params["final_norm"])
    if "lm_head" in params:
        _fill(model.lm_head, params["lm_head"])
    for block, tree in zip(model.blocks, _layers(cfg, params)):
        _fill(block, tree)
    return model


def lm_cache_from_reference(cfg, cache, device=D.DEFAULT):
    """The reference's decoder-LM cache -> the port's list of per-layer
    dicts on ``device``: {"k", "v"} for attention, {"h", "conv"} for
    RG-LRU, {"wkv", "shift_t", "shift_c"} for RWKV."""
    dev = D.resolve(device)
    return [{n: _tensor(t).to(dev) for n, t in c.items()}
            for c in _layers(cfg, cache)]
