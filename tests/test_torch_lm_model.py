"""The port's LM training forward against the JAX reference on the CPU:
``init_tree``, ``lm_loss`` / ``Model.loss``, autograd gradients,
``predict_argmax`` and the attention backward.

The tiny LM (``conftest.tiny_lm_config``) and the phi4-mini and gemma2
SMOKE configs in float32 run through both packages with the reference's
parameters carried across (``convert.lm_tree_from_reference``).
Tolerances (the same float32 arithmetic summed in another order):
  - losses within 1e-6 relative;
  - gradients within 1e-5 of each leaf's largest |gradient|, with the
    blocks recomputed in the backward (remat) and without;
  - greedy predictions exact;
  - ``init_tree`` within 3e-7 + 3e-7 |x| of the reference's init (its
    normal draws are within 2.5e-7 of ``jax.random.normal``'s);
  - the plain attention backward within 1e-5 of the largest |gradient|
    of autograd of ``attention_plain`` and of ``jax.vjp`` of the
    reference's attention (its xla path, which the reference trains
    through off the TPU).
The recurrent smokes' gradients through the plain recurrences (what
the CPU runs) are held within 1e-4 of each leaf's largest |gradient|
(the reference's RG-LRU takes an associative scan on the CPU); on the
card the same layers train through the backward kernels N2a and N2b,
held to the plain backwards in ``test_torch_recurrent_grad.py`` and
``test_torch_cuda_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model, tiny_lm_config
from repro.checkpoint import flatten_tree as jflatten
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_to_reference, lm_tree_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.tree_util import flatten_tree, tree_map
from torch_threads import one_torch_thread  # noqa: F401

ATTN_ARCHS = ["tiny", "phi4-mini-3.8b", "gemma2-27b"]
RECURRENT_ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _ref_model(name):
    if name == "tiny":
        jcfg = tiny_lm_config()
        return jcfg, JModel(jcfg)
    return smoke_model(name, dtype="float32", param_dtype="float32")


def _setup(name, B=2, S=80, seed=0):
    jcfg, jm = _ref_model(name)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    tree = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return cfg, Model(cfg), tree, jm, jp, batch


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def pair(request):
    return _setup(request.param)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(model, tree, batch, remat):
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      tree)
    loss = model.loss(leaves, _tbatch(batch), remat=remat)
    flat = flatten_tree(leaves)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, dict(zip(flat, grads))


def _close_grads(cfg, got, jgrads, tol):
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()) + 1e-12, (name, err)


@pytest.mark.parametrize("name", ATTN_ARCHS + RECURRENT_ARCHS)
def test_init_tree_matches_reference_init(name):
    jcfg, jm = _ref_model(name)
    cfg = port_config(jcfg)
    want = jflatten(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))))
    got = lm_params_to_reference(cfg, Model(cfg).init_tree(prng.PRNGKey(3),
                                                           "cpu"))
    assert set(got) == set(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], rtol=3e-7, atol=3e-7,
                                   err_msg=path)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "deepseek-moe-16b",
                                  *RECURRENT_ARCHS])
def test_init_draws_on_a_device_match_host_draws(name):
    """``init_tree`` off the CPU draws its normals on the device
    (``prng.normal_tensor``): the block builders and the embedding's
    draw, asked for a device (here the CPU itself), give the host
    draws' values, bit for bit but where float64 log1p rounds otherwise
    (a last float32 bit of the draw, at most 3 ulps once scaled), for
    an attention and MLP block, an MoE block with shared experts, an
    RG-LRU block and an RWKV block."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers, transformer
    cfg = get_smoke(name)
    key = prng.PRNGKey(4)
    moe = cfg.moe is not None
    host = {"block": transformer._block_np(cfg, key, cfg.pattern[-1], moe),
            "embed": layers._normal(key, (cfg.vocab_size, cfg.d_model), 0.02)}
    dev = {"block": transformer._block_np(cfg, key, cfg.pattern[-1], moe,
                                          device=torch.device("cpu")),
           "embed": layers._normal(key, (cfg.vocab_size, cfg.d_model), 0.02,
                                   torch.device("cpu"))}
    want = flatten_tree(host)
    got = {p: np.asarray(torch.as_tensor(a)) for p, a in
           flatten_tree(dev).items()}
    assert set(got) == set(want)
    same = total = 0
    for p, a in got.items():
        w = np.asarray(want[p])
        assert a.dtype == w.dtype == np.float32 and a.shape == w.shape, p
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(w)))
        np.testing.assert_array_less(np.abs(a - w), 3.01 * ulp, err_msg=p)
        same, total = same + int((a == w).sum()), total + a.size
    assert same >= 0.999 * total


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(pair, remat):
    cfg, model, tree, jm, jp, batch = pair
    loss, grads = _grads(model, tree, batch, remat)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), remat=remat))(jp)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    _close_grads(cfg, grads, jgrads, 1e-5)


def test_predict_matches_reference(pair):
    cfg, model, tree, jm, jp, batch = pair
    got = model.predict(tree, {"tokens": torch.from_numpy(batch["tokens"])})
    want = jm.predict(jp, {"tokens": jnp.asarray(batch["tokens"])})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [1024, 600], ids=["two_chunks", "ragged"])
def test_chunked_head_matches_reference(S):
    """HEAD_CHUNK = 512: S 1024 runs the head in two chunks, S 600 falls
    back to one chunk of all positions, as the reference does."""
    cfg, model, tree, jm, jp, batch = _setup("tiny", B=1, S=S)
    loss = model.loss(tree, _tbatch(batch), remat=True)
    jloss = jm.loss(jp, _jbatch(batch), remat=True)
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    got = model.predict(tree, {"tokens": torch.from_numpy(batch["tokens"])})
    want = jm.predict(jp, {"tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gemma2_loss_and_grads_past_its_window_match_reference():
    """The gemma2 smoke at B 1 x S 1024, as gemma2_train runs gemma2-27b
    at its own context: its window 64 binds on the local layer, both
    soft-caps (attention 50, head 30) and the tied embedding are on, and
    the head runs two ``HEAD_CHUNK`` chunks, each recomputed in the
    backward.  Loss within 1e-6 relative and gradients (remat) within
    1e-5 of each leaf's largest |gradient| of ``jax.grad`` of the
    reference's loss."""
    from repro_torch.models import transformer
    cfg, model, tree, jm, jp, batch = _setup("gemma2-27b", B=1, S=1024)
    assert cfg.window == 64 and "attn_local" in cfg.layer_kinds
    assert cfg.attn_softcap == 50.0 and cfg.final_softcap == 30.0
    assert cfg.tie_embeddings and "lm_head" not in tree
    assert transformer._chunks(1024) == (2, transformer.HEAD_CHUNK)
    loss, grads = _grads(model, tree, batch, remat=True)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), remat=True))(jp)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    _close_grads(cfg, grads, jgrads, 1e-5)


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_recurrent_grads_on_cpu_match_reference(name):
    """On the CPU the recurrent archs train through the plain
    recurrences (the card's run the backward kernels N2a and N2b)."""
    cfg, model, tree, jm, jp, batch = _setup(name, S=48)
    loss, grads = _grads(model, tree, batch, remat=True)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), remat=True))(jp)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close_grads(cfg, grads, jgrads, 1e-4)


ATTN_SETTINGS = [  # (causal, window, softcap, H, KV)
    (True, 0, 0.0, 4, 4), (True, 16, 0.0, 4, 2), (True, 0, 30.0, 4, 1),
    (True, 16, 50.0, 6, 2), (False, 0, 0.0, 4, 2)]


@pytest.mark.parametrize("causal,window,softcap,H,KV", ATTN_SETTINGS)
def test_attention_backward_plain(causal, window, softcap, H, KV):
    B, S, dh = 2, 70, 32
    rng = np.random.default_rng(H * 10 + KV + window)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in
                   ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh),
                    (B, S, H, dh)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = ref.attention_plain(tq, tk, tv, return_lse=True, **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    plain = ref.attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(),
        torch.from_numpy(do), lse.detach(), **kw)
    jo, vjp = jax.vjp(lambda a, b, c: jops.attention(a, b, c, impl="xla",
                                                     **kw), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=1e-5)
    for p, a, j in zip(plain, auto, jgrads):
        scale = float(np.abs(np.asarray(j)).max())
        assert float((p - a).abs().max()) <= 1e-5 * scale
        assert float(np.abs(p.numpy() - np.asarray(j)).max()) <= 1e-5 * scale


@pytest.mark.parametrize("window", [0, 16], ids=["causal", "window"])
def test_attention_backward_plain_at_head_dim_80(window):
    """``ref.attention_backward_plain`` at stablelm-3b's head dim 80
    (MHA, causal, with and without a window) against ``jax.vjp`` of the
    reference's xla attention and autograd of the plain forward, within
    1e-5 of the largest |gradient|, as at dh 32."""
    B, S, H, dh = 2, 70, 4, 80
    rng = np.random.default_rng(80 + window)
    q, k, v, do = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
                   for _ in range(4))
    kw = dict(causal=True, window=window, softcap=0.0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = ref.attention_plain(tq, tk, tv, return_lse=True, **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    plain = ref.attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(),
        torch.from_numpy(do), lse.detach(), **kw)
    jo, vjp = jax.vjp(lambda a, b, c: jops.attention(a, b, c, impl="xla",
                                                     **kw), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=1e-5)
    for p, a, j in zip(plain, auto, jgrads):
        assert p.shape == (B, S, H, dh)
        scale = float(np.abs(np.asarray(j)).max())
        assert float((p - a).abs().max()) <= 1e-5 * scale
        assert float(np.abs(p.numpy() - np.asarray(j)).max()) <= 1e-5 * scale


# (B, Skv, H, KV, dh, splits on 132 SMs): recurrentgemma's train shape
# (32 dK/dV tiles: 5 splits of 2 heads) and its long row; groups the count
# does not divide; a granite-like 48:1 group at dh 256 and at its own dh
# 128 (16 tiles: 9 splits); dh <= 128 splits by the same rule, and not
# where the tiles fill the card (stablelm-3b's train shape at dh 80:
# 1024 dK/dV CTAs, MHA 32:32)
HEAD_SPLITS = [(4, 512, 10, 1, 256, 5), (1, 4096, 10, 1, 256, 3),
               (1, 1000, 10, 1, 256, 9), (2, 620, 12, 2, 256, 4),
               (1, 777, 20, 2, 256, 6), (1, 256, 48, 1, 256, 33),
               (16, 4096, 10, 1, 256, 1), (1, 1024, 48, 1, 128, 9),
               (4, 512, 32, 32, 80, 1)]


@pytest.mark.parametrize("B,Skv,H,KV,dh,want", HEAD_SPLITS)
def test_bwd_head_splits_fill_the_card(B, Skv, H, KV, dh, want):
    """N1's dK/dV split count gives the launch at least one CTA an SM, at
    most one q head a split, at every head dim; the kernel's split sp
    walks heads [sp G / n, (sp + 1) G / n) of a group of G: every head
    once, the splits' sizes at most one apart."""
    from repro_torch.kernels import flash_attention as fa
    n = fa.bwd_head_splits(B, Skv, KV, H, dh, 132)
    assert n == want
    G = H // KV
    bounds = [sp * G // n for sp in range(n + 1)]
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    assert bounds[0] == 0 and bounds[-1] == G and min(sizes) >= 1
    assert max(sizes) - min(sizes) <= 1
    if n < G:
        assert -(-Skv // 64) * KV * B * n >= 132


def test_recurrences_stay_differentiable_on_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32))
    la = -torch.rand(2, 9, 8)
    x.requires_grad_(True)
    h, _ = ops.rglru(x, la)
    (gx,) = torch.autograd.grad(h.sum(), x)
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0
    r, k, v, w = (torch.randn(1, 5, 2, 4, requires_grad=True)
                  for _ in range(4))
    o, _ = ops.wkv(r, k, v, torch.sigmoid(w), torch.randn(2, 4))
    grads = torch.autograd.grad(o.sum(), (r, k, v, w))
    assert all(torch.isfinite(g).all() for g in grads)
