"""The port's LM training steps and their data against the JAX
reference on the CPU: ``TrainConfig``, ``synthetic.tokens`` and the
token pipeline (bit for bit), ``make_train_step`` (three steps from the
reference's init carried across, at one and two microbatches),
``make_label_step`` and ``token_teacher_vote`` (bit for bit).

Tolerances: train-step losses, gradient norms and every parameter
within 1e-5 (relative to the reference's value, or to the leaf's largest
|value|): the same float32 arithmetic summed in another order.  Votes,
labels and gaps are integers and exact; the Laplace noise's uniform
draws are the reference's bits (``prng``), its ``log1p`` within an ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_lm_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import voting as jvoting
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.federation.domain import token_domain as jtoken_domain
from repro.models import Model as JModel
from repro_torch import prng
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import lm_tree_from_reference
from repro_torch.core import distill, voting
from repro_torch.data import pipeline, synthetic
from repro_torch.federation.domain import token_domain
from repro_torch.models import Model
from repro_torch.tree_util import flatten_tree, tree_map
from torch_threads import one_torch_thread  # noqa: F401


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def test_train_config_fields_and_defaults():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())


@pytest.mark.parametrize("kw", [dict(n_seqs=64, seq_len=17, vocab=64),
                                dict(n_seqs=100, seq_len=9, vocab=512,
                                     seed=3)])
def test_tokens_and_pipeline_bit_for_bit(kw):
    got, want = synthetic.tokens(**kw), jsynthetic.tokens(**kw)
    for split in ("train", "public", "test"):
        np.testing.assert_array_equal(got[split], want[split])
    assert got["vocab"] == want["vocab"]
    seqs = got["train"]
    np.testing.assert_array_equal(pipeline.sequence_proxy_labels(seqs),
                                  jpipeline.sequence_proxy_labels(seqs))
    a = pipeline.lm_session_data(seqs, got["public"], got["test"])
    b = jpipeline.lm_session_data(seqs, got["public"], got["test"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    labels = np.arange(len(seqs) * (seqs.shape[1] - 1)).reshape(
        len(seqs), -1)
    for lab in (None, labels):
        for x, y in zip(pipeline.TokenDataset(seqs, 5).batches(4, 7, lab),
                        jpipeline.TokenDataset(seqs, 5).batches(4, 7, lab)):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    for x, y in zip(pipeline.party_token_datasets(seqs, 3, 0.5, 1),
                    jpipeline.party_token_datasets(seqs, 3, 0.5, 1)):
        np.testing.assert_array_equal(x.seqs, y.seqs)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg = tiny_lm_config()
    jm, cfg = JModel(jcfg), port_config(jcfg)
    kw = dict(batch_size=4, seq_len=16, steps=3, learning_rate=3e-3,
              warmup_steps=1, microbatches=microbatches)
    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(Model(cfg), TrainConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    jstate, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jstep)
    data = synthetic.tokens(n_seqs=32, seq_len=17, vocab=64)["train"]
    for b in pipeline.TokenDataset(data, 0).batches(4, steps=3):
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                             for k, v in b.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            want = float(jm_[name])
            assert abs(float(m[name]) - want) <= 1e-5 * abs(want), name
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))
    for name, t in flatten_tree(params).items():
        w = want[name]
        assert float((t - w).abs().max()) <= 1e-5 * float(w.abs().max())
    assert int(state.step) == 3


def test_stablelm_train_step_at_head_dim_80_matches_reference():
    """A narrow stablelm whose heads are stablelm-3b's 80 wide (2 layers,
    d_model 320, 4 MHA heads; its parallel block, partial rotary and
    LayerNorm), float32, from the reference's init carried across: the
    loss within 1e-6 relative and its gradients (the blocks recomputed
    in the backward) within 1e-5 of each leaf's largest |gradient|, as
    ``test_torch_archs.py`` holds the smokes; then two
    ``make_train_step`` steps (AdamW, remat), whose loss, gradient norm
    and learning rate agree within 1e-5 relative.  (The parameters
    after AdamW are not compared element by element: AdamW moves an
    element by about lr whatever the size of its gradient, so a
    gradient near 0 whose sign the summation order flips parts the two
    by about 2 lr, ROADMAP §3.)"""
    from conftest import smoke_model
    jcfg = smoke_model("stablelm-3b", dtype="float32", param_dtype="float32",
                       d_model=320, num_heads=4, num_kv_heads=4, d_ff=640,
                       vocab_size=256)[0]
    assert jcfg.d_model // jcfg.num_heads == 80
    jm, cfg = JModel(jcfg), port_config(jcfg)
    model = Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    data = synthetic.tokens(n_seqs=8, seq_len=25, vocab=256, seed=3)["train"]
    batches = list(pipeline.TokenDataset(data, 0).batches(2, steps=2))

    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    loss = model.loss(leaves, {k: torch.from_numpy(v)
                               for k, v in batches[0].items()})
    flat = flatten_tree(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), materialize_grads=True)))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batches[0].items()})))(jp)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()) + 1e-12, (name, err)

    kw = dict(batch_size=2, seq_len=24, steps=2, learning_rate=3e-3,
              warmup_steps=1)
    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(model, TrainConfig(**kw))
    jstate, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jstep)
    for b in batches:
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                             for k, v in b.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            want = float(jm_[name])
            assert abs(float(m[name]) - want) <= 1e-5 * abs(want), name


@pytest.mark.parametrize("vocab,gamma", [(64, 0.0), (64, 0.1),
                                         (4096, 0.0), (4096, 0.5)],
                         ids=["hist", "hist_noise", "sort", "vocab_noise"])
def test_token_teacher_vote_bit_for_bit(vocab, gamma):
    rng = np.random.default_rng(vocab)
    # few distinct tokens, so the members agree often and gaps vary
    preds = rng.integers(0, 6, (5, 2, 24)).astype(np.int32)
    key = prng.split(prng.PRNGKey(7))[1]
    labels, gap = voting.token_teacher_vote(
        torch.from_numpy(preds), token_domain(48, vocab), gamma=gamma,
        key=key)
    jlabels, jgap = jvoting.token_teacher_vote(
        jnp.asarray(preds), jtoken_domain(48, vocab), gamma=gamma,
        key=jnp.asarray(key))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(gap.numpy(), np.asarray(jgap))


def test_label_step_matches_reference():
    jcfg = tiny_lm_config()
    jm, cfg = JModel(jcfg), port_config(jcfg)
    members = [jm.init(jax.random.PRNGKey(s)) for s in range(3)]
    toks = synthetic.tokens(n_seqs=4, seq_len=17, vocab=64,
                            seed=2)["train"][:, :-1]
    key = prng.PRNGKey(11)
    bank = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    jl, jg = jax.jit(jdistill.make_label_step(jm, 3, gamma=0.2))(
        bank, {"tokens": jnp.asarray(toks)}, jnp.asarray(key))
    trees = [lm_tree_from_reference(cfg, jax.tree.map(np.asarray, p), "cpu")
             for p in members]
    labels, gap = distill.make_label_step(Model(cfg), 3, gamma=0.2)(
        trees, {"tokens": torch.from_numpy(toks)}, key)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(gap.numpy(), np.asarray(jg))
