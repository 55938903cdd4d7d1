"""Nested-container helpers over model states.

States in this package are nested tuples, lists and dicts whose leaves
are tensors or numpy arrays; None is an empty subtree, as in JAX's
pytrees.  ``flatten_tree`` is this package's copy of the reference's
``checkpoint.flatten_tree``: each leaf under its '/'-joined key path
(dict keys and sequence indices), the paths the wire codec records.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

SEP = "/"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *children) for children in zip(tree, *rest)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in JAX's flattening order (dict keys sorted)."""
    return list(_leaves(tree))


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for child in tree:
            yield from _leaves(child)
    else:
        yield tree


def flatten_tree(tree) -> Dict[str, Any]:
    """Path-keyed leaves: each leaf under its '/'-joined key path."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (tuple, list)):
            for i, child in enumerate(node):
                walk(child, path + [str(i)])
        else:
            flat[SEP.join(path)] = node

    walk(tree, [])
    return flat
