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
