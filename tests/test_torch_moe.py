"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``) on the CPU, in float32.

Parameters come from the reference's ``init_moe`` and are carried
across leaf by leaf; inputs are numpy-seeded.  At the smokes' own
capacity factor the inputs share a direction, so that the router sends
many tokens to the same experts and picks drop.  Tolerances: y within
1e-5 of its largest |value| (the same float32 products summed in
another order), the auxiliary loss within 1e-6; the dispatch (each
token's experts, which (expert, slot) holds which token, which picks
drop) exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as JM
from repro_torch import prng
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import moe as M
from repro_torch.models.transformer import _moe_np
from repro_torch.tree_util import flatten_tree

CASES = [("mixtral-8x7b", "swiglu"), ("deepseek-moe-16b", "swiglu"),
         ("deepseek-moe-16b", "geglu"), ("deepseek-moe-16b", "gelu")]


def port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(kw["moe"]))
    return ModelConfig(**kw)


def _setup(arch, mlp, capacity_factor=None):
    jcfg = jget_smoke(arch).replace(dtype="float32", param_dtype="float32",
                                    mlp=mlp)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    jp = JM.init_moe(jcfg, jax.random.PRNGKey(3))
    cfg = port_config(jcfg)
    p = M.MoE(cfg, "cpu")
    flat = flatten_tree(jax.tree.map(np.asarray, jp))
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(flat[name.replace(".", "/")])))
    assert len(flat) == len(list(p.parameters()))
    return jcfg, jp, cfg, p


def _inputs(cfg, S=32, shared=2.0, seed=1):
    """(2, S, D) float32 tokens sharing one direction (scaled by
    ``shared``), so that they crowd the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, S, cfg.d_model)) \
        + shared * rng.normal(0, 1, (1, 1, cfg.d_model))
    return x.astype(np.float32)


def _reference_dispatch(jcfg, jp, x):
    """The reference's routing decisions, by its own expressions
    (``repro/models/moe.py:64-92``, which ``moe_apply`` keeps inside):
    (idx (T, K), slot_tok (E, C), slot_gate (E, C), dropped (T*K,))."""
    m = jcfg.moe
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, K = m.num_experts, m.top_k
    xf = jnp.asarray(x).reshape(T, D)
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), -1)
    gate, idx = jax.lax.top_k(probs, K)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    C = int(-(-T * K * m.capacity_factor // E))
    flat_e = idx.reshape(T * K)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(
        jnp.cumsum(onehot, axis=0), flat_e[:, None], axis=1)[:, 0] - 1
    valid = pos < C
    pos = jnp.where(valid, pos, C)
    tok = jnp.arange(T * K) // K
    slot_tok = jnp.zeros((E, C + 1), jnp.int32).at[flat_e, pos].set(tok)
    slot_gate = jnp.zeros((E, C + 1), jnp.float32).at[flat_e, pos].set(
        jnp.where(valid, gate.reshape(T * K), 0.0))
    return (np.asarray(idx), np.asarray(slot_tok[:, :C]),
            np.asarray(slot_gate[:, :C]), ~np.asarray(valid))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


@pytest.mark.parametrize("arch,mlp", CASES)
def test_moe_apply_matches_the_reference_with_drops(arch, mlp):
    jcfg, jp, cfg, p = _setup(arch, mlp)
    x = _inputs(cfg)
    jy, jaux = JM.moe_apply(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        y, aux = M.moe_apply(cfg, p, torch.from_numpy(x))
        r = M.route(cfg, p, torch.from_numpy(x).reshape(-1, cfg.d_model))
    idx, slot_tok, slot_gate, dropped = _reference_dispatch(jcfg, jp, x)
    C = slot_tok.shape[1]
    assert dropped.sum() > 0               # the smoke's capacity drops
    assert C == M.capacity(cfg, x.shape[0] * x.shape[1])
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.slot_tok.numpy(), slot_tok)
    np.testing.assert_array_equal(r.slot_gate.numpy() == 0, slot_gate == 0)
    np.testing.assert_array_equal(r.pos.numpy().reshape(-1) == C, dropped)
    np.testing.assert_allclose(r.slot_gate.numpy(), slot_gate, rtol=1e-6,
                               atol=1e-7)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    _close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch,mlp", CASES)
def test_no_drop_dispatch_equals_the_dense_oracles(arch, mlp):
    """At capacity factor 8.0 nothing drops: the dispatch equals both
    packages' dense oracles (``tests/test_archs.py``'s check)."""
    jcfg, jp, cfg, p = _setup(arch, mlp, capacity_factor=8.0)
    x = _inputs(cfg, S=16, shared=0.5, seed=4)
    with torch.no_grad():
        y, _ = M.moe_apply(cfg, p, torch.from_numpy(x))
        y_ref = M.moe_ref(cfg, p, torch.from_numpy(x))
    _close(y, y_ref.numpy())
    _close(y, JM.moe_ref(jcfg, jp, jnp.asarray(x)))
    _close(y_ref, JM.moe_apply(jcfg, jp, jnp.asarray(x))[0])


def test_top_k_breaks_ties_toward_the_lower_expert():
    """``jax.lax.top_k``'s order on rows with equal probabilities."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.0, 0.5]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    v, i = M._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("T,K,E,cf", [(32, 2, 4, 1.5), (7, 6, 64, 1.25),
                                      (4096, 6, 64, 11.0), (3, 2, 8, 1.0),
                                      (4608, 2, 8, 1.25)])
def test_capacity_is_the_reference_expression(T, K, E, cf):
    cfg = ModelConfig(moe=MoEConfig(num_experts=E, top_k=K,
                                    capacity_factor=cf))
    assert M.capacity(cfg, T) == int(-(-T * K * cf // E))
    # no-drop at cf >= E / K: every expert can hold every token
    if cf >= E / K:
        assert M.capacity(cfg, T) >= T


def test_moe_init_draws_the_reference_leaves():
    """``_moe_np`` against ``init_moe`` (key reuse included), within the
    normal draw's 3e-7 + 3e-7|x|."""
    jcfg = jget_smoke("deepseek-moe-16b")
    cfg = port_config(jcfg)
    key = jax.random.PRNGKey(7)
    want = flatten_tree(jax.tree.map(np.asarray, JM.init_moe(jcfg, key)))
    got = flatten_tree(_moe_np(cfg, prng.PRNGKey(7)))
    assert set(got) == set(want)
    for n in want:
        assert got[n].shape == want[n].shape and got[n].dtype == np.float32
        assert (np.abs(got[n] - want[n])
                <= 3e-7 + 3e-7 * np.abs(want[n])).all(), n
    # the reused key: router and shared.w_down are one normal draw
    Fs = cfg.moe.num_shared_experts * cfg.d_ff
    np.testing.assert_allclose(got["shared/w_down"].reshape(-1)[:8]
                               * Fs ** 0.5,
                               got["router"].reshape(-1)[:8] / 0.02,
                               rtol=1e-5)
