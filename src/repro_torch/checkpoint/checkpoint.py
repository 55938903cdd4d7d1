"""Checkpointing (``repro.checkpoint``): a tree <-> .npz with path-keyed
arrays + a JSON manifest, in the reference's file format.

Each leaf is saved under its '/'-joined key path (``flatten_tree``), and
``<path>.json`` records the step, the metrics and the sorted leaf paths,
so either package restores the other's files.  A decoder LM is saved in
the reference's own parameter layout (``convert.lm_params_to_reference``:
periods stacked on a leading axis) and comes back through
``convert.lm_params_from_reference`` (a serving ``Transformer``) or
``convert.lm_tree_from_reference`` (float32 training masters).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree_util import SEP, flatten_tree


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _array(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, step: Optional[int] = None,
         metrics: Optional[Dict[str, Any]] = None):
    """Writes ``<path>.npz`` (every leaf under its path) and
    ``<path>.json`` (step, metrics, sorted leaf paths)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {p: _array(leaf) for p, leaf in flatten_tree(tree).items()}
    np.savez(_npz(path), **flat)
    manifest = {"step": step, "metrics": metrics or {},
                "leaves": sorted(flat)}
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load(path: str):
    """The checkpoint's path -> array mapping; each array is read from
    the file when it is first looked up."""
    return np.load(_npz(path))


def restore(path: str, like):
    """Restores into the structure of ``like`` (a tree template): each
    leaf the saved array at its path, as a tensor on the template
    leaf's device and in its dtype where the template leaf is a
    tensor, else as a numpy array."""
    flat = load(path)

    def rebuild(node, keys):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(v, keys + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [rebuild(c, keys + [str(i)]) for i, c in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        a = np.array(flat[SEP.join(keys)])
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(a).to(node.device, node.dtype)
        return a

    return rebuild(like, [])


def manifest(path: str) -> Dict[str, Any]:
    with open(path.removesuffix(".npz") + ".json") as f:
        return json.load(f)
