"""The port's nets, optimisers and ``digits`` against the reference's.

Tolerances: ``digits`` arrays are equal; each net's logits on params
carried across by ``convert.from_reference`` are within 1e-5 of the
largest logit (float32 products and convolutions in another order);
the port's own init is within 2.5e-7 + 1.2e-7 |w| of the reference's
(``prng.normal``); one optimiser update, ``clip_by_global_norm`` and
``prox_grads`` on the same tensors are within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import digits as j_digits
from repro.models import smallnets as JS
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import prox_grads as j_prox
from repro.optim import sgd as j_sgd
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch import optim, prng
from repro_torch.convert import from_reference, to_reference
from repro_torch.data.synthetic import digits
from repro_torch.models import smallnets as S
from repro_torch.tree_util import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401

NETS = {
    "mlp": (S.MLP(14, 2), JS.MLP(14, 2), (50, 14)),
    "mlp_h16": (S.MLP(14, 2, hidden=16), JS.MLP(14, 2, hidden=16), (9, 14)),
    "cnn16": (S.PaperCNN(16, 1, 10), JS.PaperCNN(16, 1, 10), (20, 16, 16, 1)),
    "cnn28": (S.PaperCNN(28, 1, 10), JS.PaperCNN(28, 1, 10), (12, 28, 28, 1)),
    "cnn32_rgb": (S.PaperCNN(32, 3, 10), JS.PaperCNN(32, 3, 10),
                  (4, 32, 32, 3)),
    "vgg9": (S.VGG9Lite(16, 3, 2, width=8), JS.VGG9Lite(16, 3, 2, width=8),
             (4, 16, 16, 3)),
}


@pytest.mark.parametrize("seed", [0, 3])
def test_digits_arrays_equal(seed):
    got = digits(n=600, image_size=16, seed=seed)
    want = j_digits(n=600, image_size=16, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", sorted(NETS))
def test_apply_matches_reference_on_carried_params(name):
    port, ref, shape = NETS[name]
    params = jax.jit(ref.init)(jax.random.PRNGKey(1))
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(x)))
    got = port.apply(from_reference(params, "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("name", sorted(NETS))
def test_init_matches_reference_tree(name):
    """The same tree (paths, shapes, float32), each leaf within
    ``prng.normal``'s tolerance; each layer's dict in the key order the
    reference's states leave ``jax.jit`` with (sorted)."""
    port, ref, _ = NETS[name]
    got = port.init(prng.PRNGKey(5), "cpu")
    want = jax.jit(ref.init)(jax.random.PRNGKey(5))
    fg, fw = flatten_tree(to_reference(got)), flatten_tree(want)
    assert list(fg) == list(fw)
    for path in fw:
        assert fg[path].dtype == np.float32 and fg[path].shape == \
            fw[path].shape, path
        np.testing.assert_allclose(fg[path], np.asarray(fw[path]),
                                   rtol=1.2e-7, atol=2.5e-7)
    assert [list(v) for v in got.values()] == \
        [list(v) for v in want.values()]


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)


def _close(got, want, atol=1e-6):
    for a, b in zip(jax.tree.leaves(to_reference(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("opt", ["adamw", "adamw_wd", "sgd", "sgdm"])
def test_optimizer_steps_match_reference(opt):
    """Three updates from the same params and gradients (the bias
    corrections at t = 1, 2, 3)."""
    make = {"adamw": (lambda: optim.adamw(), lambda: j_adamw()),
            "adamw_wd": (lambda: optim.adamw(weight_decay=1e-2),
                         lambda: j_adamw(weight_decay=1e-2)),
            "sgd": (lambda: optim.sgd(), lambda: j_sgd()),
            "sgdm": (lambda: optim.get("sgdm"),
                     lambda: j_sgd(momentum=0.9))}[opt]
    popt, jopt = make[0](), make[1]()
    jp = JS.MLP(14, 2).init(jax.random.PRNGKey(2))
    pp = from_reference(jp, "cpu")
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(3):
        g = _grads_like(jp, step)
        jp, js = jopt.update(g, js, jp, 1e-2)
        pp, ps = popt.update(from_reference(g, "cpu"), ps, pp, 1e-2)
        _close(pp, jp)
        _close(ps.mu, js.mu)
    assert int(ps.step) == int(js.step) == 3
    assert ps.step.dtype == torch.int32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_prox_match_reference(max_norm):
    jp = JS.MLP(14, 2).init(jax.random.PRNGKey(3))
    jg = _grads_like(jp, 7)
    jgp = _grads_like(jp, 8)
    want, want_norm = j_clip(jg, max_norm)
    got, got_norm = optim.clip_by_global_norm(from_reference(jg, "cpu"),
                                              max_norm)
    _close(got, want)
    assert float(got_norm) == pytest.approx(float(want_norm), rel=1e-6)
    _close(optim.prox_grads(from_reference(jg, "cpu"),
                            from_reference(jp, "cpu"),
                            from_reference(jgp, "cpu"), 0.1),
           j_prox(jg, jp, jgp, 0.1))


def test_schedules_match_reference():
    j_f = j_warmup_cosine(1e-3, 10, 100)
    p_f = optim.warmup_cosine(1e-3, 10, 100)
    for step in (0, 5, 10, 50, 100, 150):
        assert float(p_f(step)) == pytest.approx(float(j_f(step)),
                                                 rel=1e-6)
        assert float(p_f(torch.tensor(step))) == float(p_f(step))
    assert float(optim.constant(3e-4)(7)) == pytest.approx(3e-4)
