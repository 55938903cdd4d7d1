"""The port keeps the reference's public names, module for module
(ROADMAP, "Rules of the port": Layout), and the names it once lacked
(ROADMAP §3, P1) behave as the reference's.

The guard: for every module that exists in both packages, each public
name of the reference's module exists in the port's.  A public name is
one without a leading underscore that is a function or class defined in
that module (or, in a package's ``__init__``, re-exported from inside
the package), or an upper-case module constant.  ``ALLOWED`` lists, with
their reasons, the names the port lacks on purpose or has not ported
yet.

P1's names against the reference on the CPU: single RF trees and
forests exact under integer (bootstrap) weights; a GBDT's regression
trees by routing and leaves within 1e-5 (one-ulp g/h differences can
break a near-tie in the gain at a few dozen rows: ROADMAP §3, port
notes); the learner-kind registry through ``learner_kind`` and the
codec's ``learner_kind`` field; ``build``.
"""
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trees as jtrees
from repro.federation import bindings as jbindings
from repro_torch.core import trees
from torch_reference import reference_module

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# (module, name): reference names the port lacks, each with its reason
ALLOWED = {
    # the reference's backend knobs: the port dispatches on the tensors'
    # device instead (ROADMAP, "Rules of the port": Dispatch)
    ("kernels.ops", "CONFIG"), ("kernels.ops", "configure"),
    ("kernels.ops", "resolve_impl"),
}


def _shared_modules():
    """Dotted names (relative to the package) of every module of the
    port that the reference also has ("" for the package itself)."""
    out = []
    for p in sorted((SRC / "repro_torch").rglob("*.py")):
        parts = list(p.relative_to(SRC / "repro_torch").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        rel = ".".join(parts)
        ref = SRC / "repro" / pathlib.Path(*parts) if parts else \
            SRC / "repro"
        if ref.with_suffix(".py").exists() or (ref / "__init__.py").exists():
            out.append(rel)
    return out


def _public(mod):
    package = hasattr(mod, "__path__")
    names = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(v):
            continue
        if inspect.isfunction(v) or inspect.isclass(v):
            home = getattr(v, "__module__", "") or ""
            if home == mod.__name__ or (package and
                                        home.startswith("repro.")):
                names.add(name)
        elif name.isupper():
            names.add(name)
    return names


def _module(pkg, rel):
    return reference_module(pkg + ("." + rel if rel else ""))


@pytest.mark.parametrize("rel", _shared_modules(), ids=lambda r: r or "pkg")
def test_port_has_the_reference_public_names(rel):
    ref, port = _module("repro", rel), _module("repro_torch", rel)
    missing = {n for n in _public(ref) - set(vars(port))
               if (rel, n) not in ALLOWED}
    assert not missing, f"repro_torch.{rel} lacks {sorted(missing)}"


def test_allow_list_names_only_missing_names():
    """Every allowed name is still absent from the port and present in
    the reference: the list shrinks as the names are ported."""
    for rel, name in ALLOWED:
        assert name in _public(_module("repro", rel)), (rel, name)
        assert not hasattr(_module("repro_torch", rel), name), (rel, name)


# ---------------------------------------------------------------------------
# P1: the single tree fits
# ---------------------------------------------------------------------------
def _binned(seed, N=300, F=6, C=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int32) + \
        (X[:, 2] > 1).astype(np.int32) * (C - 2)
    edges = jtrees.make_bins(X)
    xb = np.array(jtrees.binize(jnp.asarray(X), jnp.asarray(edges)))
    return rng, xb, y


def test_fit_tree_gini_and_forest_exact():
    rng, xb, y = _binned(0)
    N, F = xb.shape
    w = rng.integers(0, 3, N).astype(np.float32)      # bootstrap counts
    fm = np.ones(F, np.float32)
    fm[3] = 0.0
    want = jtrees.fit_tree_gini(jnp.asarray(xb), jnp.asarray(y),
                                jnp.asarray(w), jnp.asarray(fm), depth=4,
                                num_classes=3)
    got = trees.fit_tree_gini(torch.from_numpy(xb), torch.from_numpy(y),
                              torch.from_numpy(w), torch.from_numpy(fm),
                              depth=4, num_classes=3)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    T = 5
    W = rng.integers(0, 3, (T, N)).astype(np.float32)
    FM = (rng.uniform(size=(T, F)) < 0.7).astype(np.float32)
    FM[:, 0] = 1.0
    want = jtrees.fit_forest(jnp.asarray(xb), jnp.asarray(y),
                             jnp.asarray(W), jnp.asarray(FM), depth=3,
                             num_classes=3)
    got = trees.fit_forest(torch.from_numpy(xb), torch.from_numpy(y),
                           torch.from_numpy(W), torch.from_numpy(FM),
                           depth=3, num_classes=3)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _routes(tree, xb):
    """Each row's leaf row under ``tree`` (one tree), as numpy."""
    sf, sb, leaf = (torch.as_tensor(np.asarray(a)) for a in tree)
    return trees.tree_apply((sf[None], sb[None], leaf[None]),
                            torch.from_numpy(xb)[None])[0].numpy()


def test_fit_tree_gh_and_gbdt_by_routing_and_leaves():
    rng, xb, y = _binned(1, C=2)
    N = xb.shape[0]
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.1, 0.3, N).astype(np.float32)
    want = jtrees.fit_tree_gh(jnp.asarray(xb), jnp.asarray(g),
                              jnp.asarray(h), depth=3)
    got = trees.fit_tree_gh(torch.from_numpy(xb), torch.from_numpy(g),
                            torch.from_numpy(h), depth=3)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    np.testing.assert_allclose(_routes(got, xb), _routes(want, xb),
                               rtol=1e-5, atol=1e-5)
    w = np.ones(N, np.float32)
    w[-20:] = 0.0                                     # padding rows
    want = jtrees.fit_gbdt(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w),
                           0.3, num_rounds=4, depth=3)
    got = trees.fit_gbdt(torch.from_numpy(xb), torch.from_numpy(y),
                         torch.from_numpy(w), 0.3, num_rounds=4, depth=3)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    for r in range(4):
        np.testing.assert_allclose(
            _routes(tuple(a[r] for a in got), xb),
            _routes(tuple(np.asarray(a)[r] for a in want), xb),
            rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the layers' init functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,module,fn", [
    ("phi4-mini-3.8b", "layers", "init_norm"),
    ("phi4-mini-3.8b", "layers", "init_attn"),
    ("phi4-mini-3.8b", "layers", "init_mlp"),
    ("deepseek-moe-16b", "moe", "init_moe"),
    ("recurrentgemma-2b", "rglru", "init_rglru"),
    ("rwkv6-7b", "rwkv", "init_rwkv")])
def test_init_functions_draw_as_the_reference(arch, module, fn):
    """Each of the reference's per-layer init functions, from one
    threefry key: the same leaves and shapes in ``cfg.param_dtype``,
    values within 3e-7 + 3e-7 |x| (``prng.normal`` against
    ``jax.random.normal``)."""
    import jax
    from repro.configs import get_smoke as jget_smoke
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.tree_util import flatten_tree
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jmod = importlib.import_module(f"repro.models.{module}")
    mod = importlib.import_module(f"repro_torch.models.{module}")
    args = (jcfg,) if fn == "init_norm" else (jcfg, jax.random.PRNGKey(3))
    want = flatten_tree(jax.tree.map(np.asarray, getattr(jmod, fn)(*args)))
    args = (cfg,) if fn == "init_norm" else (cfg, prng.PRNGKey(3))
    got = flatten_tree(getattr(mod, fn)(*args))
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.float32 and tuple(t.shape) == \
            want[name].shape, name
        np.testing.assert_allclose(t.numpy(), want[name], rtol=3e-7,
                                   atol=3e-7, err_msg=name)
    from repro.models.layers import dense_init as jdense
    from repro_torch.models.layers import dense_init
    got = dense_init(prng.PRNGKey(5), (64, 32), "bfloat16", 0.02)
    want = jdense(jax.random.PRNGKey(5), (64, 32), jnp.bfloat16, 0.02)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# P1: the learner-kind registry, build
# ---------------------------------------------------------------------------
def test_register_learner_kind_round_trips():
    from repro_torch.federation import (learner_kind, register_learner_kind,
                                        registered_learner_kinds)
    from repro_torch.federation import codec
    from repro_torch.federation.messages import PartyUpdate

    class KNNLearner:
        pass

    assert learner_kind(KNNLearner()) == "knnlearner"
    assert registered_learner_kinds() == \
        jbindings.registered_learner_kinds() == ["gbdt", "lm", "nn", "rf"]
    register_learner_kind("KNNLearner", "knn")
    try:
        assert learner_kind(KNNLearner()) == "knn"
        assert "knn" in registered_learner_kinds()
        up = PartyUpdate(party_id=3, student_states=[np.zeros(4, np.int32)],
                         vote_gaps=np.zeros(3, np.float32), num_examples=10,
                         learner_kind=learner_kind(KNNLearner()))
        back = codec.decode_update(codec.encode_update(up))
        assert back.learner_kind == "knn"
    finally:
        from repro_torch.federation import bindings
        bindings._KIND_BY_CLASS.pop("KNNLearner")


def test_build_gives_a_model():
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model, build
    from repro_torch.models.registry import build as build_
    assert build is build_
    cfg = get_smoke("phi4-mini-3.8b")
    assert build(cfg) == Model(cfg)
