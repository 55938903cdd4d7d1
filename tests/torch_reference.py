"""Shared pieces of the port's dry-run tests (test_torch_dryrun,
test_torch_sharding, test_torch_public_names), which import them:

    from torch_reference import cache_ref_path, ref_flat, reference_module

``reference_module`` imports a module of the reference package without
the side effect two of them have; the path helpers map a leaf of the
port's parameter tree or cache onto the reference's stacked layout
(``convert._ref_path``'s mapping: layers of the periods are rows of one
stacked leaf).
"""
import importlib
import os

import jax

from repro_torch import convert


def reference_module(name):
    """``import name`` from the reference, with ``XLA_FLAGS`` as it was:
    ``repro.launch.dryrun`` and ``repro.launch.fedkt_dryrun`` ask for 512
    host devices when imported, which would reach every later JAX
    backend start in this test worker."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _names(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def ref_flat(tree):
    """{'/'-joined path: leaf} of a reference pytree (leaves may be
    ShapeDtypeStructs, shardings or specs)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_names(kp): leaf for kp, leaf in leaves}


def param_ref_path(cfg, path):
    """(reference path, stacked index or None) of the port's parameter
    at '/'-joined ``path``."""
    return convert._ref_path(cfg, path.replace("/", "."))


def cache_ref_path(cfg, path):
    """(reference path, stacked index or None) of the port's cache leaf
    at ``path``: "i/name" of a decoder's layer i, or "self/i/k" and
    "cross/i/k" of an encoder-decoder's (stacked on axis 0 there)."""
    parts = path.split("/")
    if cfg.is_encoder_decoder:
        return f"{parts[0]}/{parts[2]}", int(parts[1])
    return convert._ref_path(cfg, f"blocks.{parts[0]}.{parts[1]}")
