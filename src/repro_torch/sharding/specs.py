"""Name-based sharding rules: params -> PartitionSpec
(``repro.sharding.specs``).

The layout is the reference's:
  - tensor parallel over "model": column weights shard their output dim,
    row weights shard their input dim (Megatron pairing, so the pair
    needs one reduce per block)
  - FSDP over "data": the *other* matmul dim of every large weight is
    sharded over the data axis (ZeRO-3 style); optimizer state inherits
    the param spec
  - "pod" is pure data parallelism (batch + gradient all-reduce)

Specs are right-aligned to leaf rank, so the reference's scan-stacked
(periods) leaves pick up a leading None that the port's per-layer
leaves do not have: a port leaf's spec is the reference's for the same
path with that None dropped.  Any axis that does not divide the dim is
dropped (e.g. 24 heads on a 16-way model axis -> the flattened
head*dh dim is sharded instead, which always divides).

**The torch.distributed scope.**  The port runs one process per card
and shards nothing at run time: a model is held whole on one H100, and
the machine the port is measured on has one.  These rules exist so the
dry-run can price a mesh of H100s (``launch/analysis.py``: the resident
shard bytes of every leaf, and the collectives this layout implies).
``placements`` maps a spec onto ``torch.distributed.tensor`` ``Shard``
and ``Replicate`` placements over a ``DeviceMesh`` with the same axis
names, for code that would distribute a tree with ``distribute_tensor``;
no path of the port calls it yet.  ``set_activation_mesh``,
``constrain``, ``shard_heads`` and ``pregather_params`` keep the
reference's names and its behaviour without a mesh, whatever mesh is
set: the port pins no activation layout (there is no GSPMD to pin it
for), and the pre-gather is the per-step cast to the compute dtype.

``Mesh`` is any object with a ``shape`` mapping of axis name to size
(``launch/mesh.py``'s description, or a test's stand-in); ``P`` is a
tuple of axis entries, and ``NamedSharding`` pairs it with its mesh as
the reference's does (a leaf of a tree, so ``tree_map`` stops at it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim import OptState
from repro_torch.tree_util import tree_leaves, tree_map

# weight-name classes (last path component)
COLUMN = {"wq", "wk", "wv", "w_up", "w_gate", "w_in", "w_a", "w_x",
          "w_r", "w_k", "w_v", "w_g", "cm_w_up", "cm_w_r", "w_lora_b"}
ROW = {"wo", "w_down", "w_out", "cm_w_down"}
VEC_MODEL = {"conv_b", "lam", "w0"}        # (…, D)-vectors in sharded space
HEAD_MAJOR = {"u", "ln_scale"}             # (…, H, dh)
REPLICATED = {"scale", "bias", "router", "mu_r", "mu_k", "mu_v", "mu_w",
              "mu_g", "cm_mu_k", "cm_mu_r", "w_lora_a", "conv_w"}

Mesh = Any


class P(tuple):
    """A PartitionSpec: one entry a dim, each None, a mesh axis name or
    a tuple of names (a tuple of one name is that name, as JAX's
    PartitionSpec normalises it); equal to the tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple)
                                     and len(a) == 1 else a for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on its mesh (a leaf of a sharding tree, as in JAX)."""
    mesh: Mesh
    spec: P


def _axis_fits(dim: int, mesh: Mesh, name: str) -> bool:
    return name in mesh.shape and dim % mesh.shape[name] == 0


def _spec(shape, mesh, *, model_dim=None, data_dim=None):
    """Builds a PartitionSpec placing 'model'/'data' at the given
    (negative) dims when divisible."""
    ndim = len(shape)
    axes = [None] * ndim
    if model_dim is not None and _axis_fits(shape[model_dim], mesh, "model"):
        axes[model_dim] = "model"
    if data_dim is not None and axes[data_dim] is None \
            and _axis_fits(shape[data_dim], mesh, "data"):
        axes[data_dim] = "data"
    return P(*axes)


def spec_for_param(path: Tuple[str, ...], shape, mesh: Mesh) -> P:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name == "table":                      # embedding (V, D)
        return _spec(shape, mesh, model_dim=-2, data_dim=-1)
    if name == "w" and parent == "lm_head":  # (D, V)
        return _spec(shape, mesh, model_dim=-1, data_dim=-2)
    if name in COLUMN:
        return _spec(shape, mesh, model_dim=-1, data_dim=-2)
    if name in ROW:
        return _spec(shape, mesh, model_dim=-2, data_dim=-1)
    if name in VEC_MODEL:
        return _spec(shape, mesh, model_dim=-1)
    if name in HEAD_MAJOR:
        return _spec(shape, mesh, model_dim=-2)
    return P()                               # replicated


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree; paths are tuples
    of strings (list indices as their decimal string)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def param_shardings(param_shapes, mesh: Mesh):
    """param_shapes: a tree of tensors or meta tensors (``init_shapes``)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, spec_for_param(path, tuple(leaf.shape), mesh)),
        param_shapes)


def _dp(mesh: Mesh):
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return dp_axes, int(np.prod([mesh.shape[a] for a in dp_axes]))


def batch_parts(mesh: Mesh, batch_size: int) -> int:
    """How many parts ``batch_sharding`` splits a batch of
    ``batch_size`` rows into: the data-parallel size where it divides
    the rows, else 1."""
    _, dp = _dp(mesh)
    return dp if dp > 1 and batch_size % dp == 0 else 1


def batch_sharding(batch_shapes, mesh: Mesh):
    """Shard the leading (batch) dim over pod+data when divisible."""
    dp_axes, dp = _dp(mesh)

    def f(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % dp == 0 and dp > 1:
            return NamedSharding(mesh, P(dp_axes))
        return NamedSharding(mesh, P())
    return tree_map(f, batch_shapes)


def cache_sharding(cache_shapes, mesh: Mesh, batch_size: int):
    """KV caches (…, B, L, KV, dh) / recurrent states: batch dim (located
    by size match) over pod+data; kv-heads (or head_dim) over model."""
    dp_axes, dp = _dp(mesh)
    msize = mesh.shape.get("model", 1)

    def f(leaf):
        axes = [None] * leaf.ndim
        bdim = None
        if dp > 1 and batch_size % dp == 0 and batch_size >= dp:
            for d in range(leaf.ndim):
                if leaf.shape[d] == batch_size:
                    axes[d] = dp_axes
                    bdim = d
                    break
        if msize > 1:
            for d in (leaf.ndim - 2, leaf.ndim - 1):
                if 0 <= d < leaf.ndim and d != bdim \
                        and leaf.shape[d] % msize == 0 \
                        and leaf.shape[d] >= msize:
                    axes[d] = "model"
                    break
        return NamedSharding(mesh, P(*axes))
    return tree_map(f, cache_shapes)


def opt_state_sharding(opt_shapes, pspec_tree, mesh: Mesh):
    """Adam mu/nu inherit the param spec; step is replicated."""
    return OptState(replicated(mesh), pspec_tree, pspec_tree)


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def spec_axes(spec: P) -> set:
    """The mesh axes ``spec`` names, on any dim."""
    return {name for entry in spec
            for name in (entry if isinstance(entry, tuple) else (entry,))
            if name is not None}


def shard_bytes(leaf, spec: P, mesh: Mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``: its bytes
    over the product of the sizes of the axes the spec names."""
    parts = int(np.prod([mesh.shape[n] for n in spec_axes(spec)]))
    return leaf.numel() * leaf.element_size() // parts


def resident_bytes(tree, shardings) -> int:
    """One device's bytes of ``tree`` under ``shardings`` (a tree of
    NamedSharding of the same structure)."""
    return sum(shard_bytes(t, s.spec, s.mesh)
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def placements(spec: P, device_mesh):
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh
    dim of ``device_mesh`` (a ``DeviceMesh``, or anything with
    ``mesh_dim_names`` or ``axis_names``): ``Shard(d)`` where the spec
    puts that axis on tensor dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = getattr(device_mesh, "mesh_dim_names", None) or \
        device_mesh.axis_names
    where = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


# ---------------------------------------------------------------------------
# Activation sharding constraints (the reference's no-mesh behaviour)
# ---------------------------------------------------------------------------
_ACT_MESH: list = [None]


def set_activation_mesh(mesh: Optional[Mesh]):
    """Records the launcher's mesh, as the reference's launchers install
    theirs.  The port pins no activation layout with it (module
    docstring: the torch.distributed scope)."""
    _ACT_MESH[0] = mesh


def constrain(x, *axes):
    """The reference's ``constrain`` without a mesh: ``x`` itself."""
    return x


DP = ("pod", "data")  # canonical data-parallel axis group


def pregather_params(params, dtype):
    """ZeRO-3's 'gather once per step' without a mesh: every floating
    leaf cast to the compute dtype ``dtype`` (inside autograd, so the
    gradient lands on the float32 master)."""
    return tree_map(lambda p: p.to(dtype) if torch.is_floating_point(p)
                    else p, params)


def shard_heads(x):
    """The reference's attention-layout pin without a mesh: ``x``."""
    return x
