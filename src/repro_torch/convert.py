"""States carried across between the JAX reference and this package.

A reference state is nested tuples, lists and dicts of arrays (numpy,
or anything numpy can read through ``np.asarray``); the port's state is
the same structure with tensors.  For the tree learners that is an RF
``((split_feat, split_bin, leaf), edges)`` or a GBDT ``(trees, edges)``.
Both directions keep the tree structure and the dtypes.  LMs convert
both ways between the reference's parameter pytree (or its
checkpoint's path-keyed arrays) and the port's module (a
``Transformer``, or an encoder-decoder's ``EncDec``) or float32
parameter tree.  The reference stacks an encoder-decoder's ``enc`` and
``dec`` layers on axis 0 (``jax.vmap``); the port lists them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.tree_util import flatten_tree, tree_map


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
    """The reference's per-layer subtrees in layer order: the dense head
    blocks, the periods (every leaf stacked on axis 0 by ``jax.vmap``),
    then the unrolled tail."""
    fkd, nper, _ = cfg.layer_plan()
    out = list(tree.get("head_blocks", []))
    for p in range(nper):
        for j in range(len(cfg.pattern)):
            out.append(tree_map(lambda a, p=p: np.asarray(a)[p],
                                tree["periods"][f"b{j}"]))
    return out + list(tree["tail"])


# an encoder-decoder's layer lists, stacked on axis 0 in the reference
_STACKED = ("enc", "dec")


def _ref_path(cfg, name):
    """The reference's checkpoint path of the port's parameter ``name``
    ("blocks.5.attn.wq"), and its index along the stacked axis (None
    where there is none): layer i < fkd is head block i; layer fkd + i
    of the periods is block b{i % len(pattern)} of period i //
    len(pattern); the tail follows.  An encoder-decoder's "enc.i.x" and
    "dec.i.x" are "enc/x" and "dec/x" at index i."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return "/".join(parts), None
    layer, rest = int(parts[1]), "/".join(parts[2:])
    fkd, nper, _ = cfg.layer_plan()
    n = len(cfg.pattern)
    if layer < fkd:
        return f"head_blocks/{layer}/{rest}", None
    layer -= fkd
    if layer < nper * n:
        return f"periods/b{layer % n}/{rest}", layer // n
    return f"tail/{layer - nper * n}/{rest}", None


def _port_named(params):
    """(dotted name, tensor) of a ``Transformer`` or a parameter tree."""
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return [(k.replace("/", "."), t)
            for k, t in flatten_tree(params).items()]


def _flat_reference(params):
    """A reference parameter pytree (nested) or its checkpoint's flat
    path -> array mapping (an ``np.load`` of the .npz reads each array
    on first access), as a path -> array mapping."""
    if "embed" in params:
        return flatten_tree(params)
    return params


def _reference_leaves(cfg, flat, names):
    """(name, tensor) of each port parameter in ``names``, read from the
    reference's path mapping one path at a time: a checkpoint's stacked
    period array is read from the file once for all its layers, not
    once a layer."""
    by_path = {}
    for name in names:
        path, idx = _ref_path(cfg, name)
        by_path.setdefault(path, []).append((name, idx))
    for path, users in by_path.items():
        a = np.asarray(flat[path])
        for name, idx in users:
            yield name, _tensor(a if idx is None else a[idx])


def lm_params_to_reference(cfg, params):
    """The port's LM parameters (a module or a tree) -> the reference's
    checkpoint layout: {path: float32 numpy array}, paths as
    ``checkpoint.flatten_tree`` writes the reference's pytree
    ("embed/table", "head_blocks/0/...", "periods/b0/attn/wq" and
    "periods/b0/ffn/router" stacked over the periods, "tail/0/...",
    "final_norm/scale", "lm_head/w"; an encoder-decoder's "enc/attn/wq"
    and "dec/xattn/wq" stacked over its layers, "enc_norm/scale").
    Saved as it is, it is a checkpoint the reference restores."""
    grouped = {}
    for name, t in _port_named(params):
        path, idx = _ref_path(cfg, name)
        a = t.detach().to(torch.float32).cpu().numpy()
        grouped.setdefault(path, {})[idx] = a
    return {path: (parts[None] if None in parts
                   else np.stack([parts[i] for i in range(len(parts))]))
            for path, parts in grouped.items()}


def lm_params_from_reference(cfg, params, device=D.DEFAULT):
    """The reference's LM parameters (its pytree, or a checkpoint's flat
    path mapping) -> the port's module on ``device`` (``new_module``).
    Head blocks, periods (MoE leaves included) and a tail (as
    recurrentgemma's), or an encoder-decoder's stacked encoder and
    decoder layers, are unstacked into layers; every matrix keeps
    its ``x @ W`` orientation.  Each parameter takes the dtype of the port's module:
    ``cfg.dtype`` where the reference casts it to the activations' dtype
    at each use, float32 where it reads it in float32 (RG-LRU's w_a,
    w_x, lam; RWKV's w0, u, ln_scale), ``cfg.param_dtype`` for norm
    parameters."""
    from repro_torch.models.transformer import new_module
    dev = D.resolve(device)
    flat = _flat_reference(params)
    model = new_module(cfg, dev)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in _reference_leaves(cfg, flat, named):
            named[name].copy_(t.to(named[name].dtype))
    return model


def lm_tree_from_reference(cfg, params, device=D.DEFAULT):
    """The reference's LM parameters (pytree or flat checkpoint mapping)
    -> the port's float32 parameter tree on ``device`` (the masters a
    training run updates)."""
    from repro_torch.models.transformer import LAYER_LISTS, param_dtypes
    dev = D.resolve(device)
    flat = _flat_reference(params)
    names = [k.replace("/", ".") for k in flatten_tree(param_dtypes(cfg))]
    tree: dict = {}
    for name, t in _reference_leaves(cfg, flat, names):
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.to(torch.float32).to(dev)
    for key in LAYER_LISTS:
        if key in tree:
            tree[key] = [tree[key][str(i)] for i in range(len(tree[key]))]
    return tree


def lm_cache_from_reference(cfg, cache, device=D.DEFAULT):
    """The reference's LM cache -> the port's, on ``device``: a decoder's
    list of per-layer dicts, {"k", "v"} for attention, {"h", "conv"} for
    RG-LRU, {"wkv", "shift_t", "shift_c"} for RWKV; an
    encoder-decoder's {"self": [...], "cross": [...]}, one {"k", "v"} a
    decoder layer each (the reference stacks them on axis 0)."""
    dev = D.resolve(device)
    if cfg.is_encoder_decoder:
        return {part: [{n: _tensor(np.asarray(t)[i]).to(dev)
                        for n, t in cache[part].items()}
                       for i in range(cfg.num_layers)]
                for part in ("self", "cross")}
    return [{n: _tensor(t).to(dev) for n, t in c.items()}
            for c in _layers(cfg, cache)]
