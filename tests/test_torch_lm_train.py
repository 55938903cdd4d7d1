"""The port's LM training steps and their data against the JAX
reference on the CPU: ``TrainConfig``, ``synthetic.tokens`` and the
token pipeline (bit for bit), ``make_train_step`` (three steps from the
reference's init carried across, at one and two microbatches),
``make_label_step`` and ``token_teacher_vote`` (bit for bit).

Tolerances: train-step losses, gradient norms and every parameter
within 1e-5 (relative to the reference's value, or to the leaf's largest
|value|): the same float32 arithmetic summed in another order; an MoE
step with drops holds its AdamW parameters by the sign split its test
states.  Votes, labels and gaps are integers and exact; the Laplace
noise's uniform draws are the reference's bits (``prng``), its
``log1p`` within an ulp.
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


def test_moe_train_step_with_drops_matches_reference_and_repeats():
    """deepseek-moe's smoke layout, its dense head block and two MoE
    blocks (4 experts, top-2, one shared expert), in float32 at
    deepseek-moe-16b's capacity factor 1.25, so that picks drop: three
    ``make_train_step`` steps (AdamW, remat) against the reference's
    from its init carried across.  Loss, gradient norm and learning rate
    within 1e-5 relative at every step, and the first step's gradients
    within 1e-5 of each leaf's largest |gradient|, as
    ``test_train_step_matches_reference`` holds them.  The parameters
    are held as ``chip_smoke.lm_card_vs_cpu`` holds two devices' AdamW
    runs: AdamW's first step moves an element by the learning rate times
    the SIGN of its gradient, and a gradient that is a cancelling sum
    near 0 takes either sign under another summation order (lm_head's
    part by 3.2e-3 of its largest after one step).  An element whose
    first-step gradient has one sign in both packages and |g| >= 1e-2 of
    its leaf's largest is within 1e-4 of the leaf's largest |value|
    (3.0e-5 at worst: the later steps' gradients carry the free
    elements' parting); every other element within ``adam_free_bound``
    plus that 1e-4.  Then, from one init on one batch, one step's loss
    and gradients taken twice (``chip_smoke.train_step_repeat``, as the
    card's run takes them) and the whole step twice: equal bit for
    bit."""
    import chip_smoke
    from conftest import smoke_model
    from test_torch_moe import port_config as moe_port_config
    jcfg = smoke_model("deepseek-moe-16b", dtype="float32",
                       param_dtype="float32", num_layers=3)[0]
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=1.25))
    jm, cfg = JModel(jcfg), moe_port_config(jcfg)
    assert cfg.moe.first_k_dense == 1 and cfg.num_layers == 3
    model = Model(cfg)
    kw = dict(batch_size=4, seq_len=16, steps=3, learning_rate=3e-3,
              warmup_steps=1)
    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(model, TrainConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    init = tree_map(torch.clone, params)
    data = synthetic.tokens(n_seqs=32, seq_len=17, vocab=512,
                            seed=4)["train"]
    jbatches = list(pipeline.TokenDataset(data, 0).batches(4, steps=3))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in jbatches]

    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      init)
    flat = flatten_tree(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        model.loss(leaves, batches[0]), list(flat.values()),
        materialize_grads=True)))
    jgrads = flatten_tree(lm_tree_from_reference(cfg, jax.tree.map(
        np.asarray, jax.grad(lambda p: jm.loss(p, {
            k: jnp.asarray(v) for k, v in jbatches[0].items()}))(jp)), "cpu"))
    for name, g in grads.items():
        w = jgrads[name]
        assert float((g - w).abs().max()) <= \
            1e-5 * float(w.abs().max()) + 1e-12, name

    jstate, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jstep)
    lrs = []
    with chip_smoke.DropCount() as drops:
        for jb, b in zip(jbatches, batches):
            jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                                 for k, v in jb.items()})
            params, state, m = step(params, state, b)
            for name in ("loss", "grad_norm", "lr"):
                want = float(jm_[name])
                assert abs(float(m[name]) - want) <= 1e-5 * abs(want), name
            lrs.append(float(m["lr"]))
    assert drops.share > 0.0
    free = chip_smoke.adam_free_bound(lrs)
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))
    for name, t in flatten_tree(params).items():
        w, g, jg = want[name], grads[name], jgrads[name]
        tol = 1e-4 * float(w.abs().max())
        diff = (t - w).abs()
        fixed = (torch.sign(g) == torch.sign(jg)) & (
            jg.abs() >= chip_smoke.ADAMW_GRAD_FLOOR * jg.abs().max())
        assert not bool((diff[fixed] > tol).any()), name
        assert not bool((diff[~fixed] > free + tol).any()), name

    rep = chip_smoke.train_step_repeat(model, init, batches[0])
    assert rep["identical"] and rep["finite"], rep
    assert rep["leaves"] == len(flatten_tree(init))
    runs = []
    for _ in range(2):
        p = tree_map(torch.clone, init)
        p, _, m = step(p, opt.init(p), batches[0])
        runs.append((m, flatten_tree(p)))
    (m1, p1), (m2, p2) = runs
    for name in ("loss", "grad_norm"):
        assert torch.equal(torch.as_tensor(m1[name]),
                           torch.as_tensor(m2[name])), name
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


def test_gemma2_train_step_past_its_window_matches_reference_and_repeats():
    """The gemma2 smoke in float32 (window 64, soft-caps 50 and 30, tied
    embeddings) trained as chip_smoke's gemma2_train trains gemma2-27b's
    cut, at rows longer than its window (B 2 x S 256): two
    ``make_train_step`` steps (AdamW, remat) against the reference's
    from its init carried across, loss, gradient norm and learning rate
    within 1e-5 relative at each step; then one step's loss and
    gradients taken twice from that init on one batch
    (``chip_smoke.train_step_repeat``): equal bit for bit."""
    import chip_smoke
    from conftest import smoke_model
    jcfg = smoke_model("gemma2-27b", dtype="float32",
                       param_dtype="float32")[0]
    jm, cfg = JModel(jcfg), port_config(jcfg)
    assert cfg.window == 64 and cfg.tie_embeddings
    model = Model(cfg)
    kw = dict(batch_size=2, seq_len=256, steps=2, learning_rate=3e-3,
              warmup_steps=1)
    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(model, TrainConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    init = tree_map(torch.clone, params)
    data = synthetic.tokens(n_seqs=16, seq_len=257, vocab=cfg.vocab_size,
                            seed=5)["train"]
    jbatches = list(pipeline.TokenDataset(data, 0).batches(2, steps=2))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in jbatches]
    jstate, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jstep)
    for jb, b in zip(jbatches, batches):
        jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                             for k, v in jb.items()})
        params, state, m = step(params, state, b)
        for name in ("loss", "grad_norm", "lr"):
            want = float(jm_[name])
            assert abs(float(m[name]) - want) <= 1e-5 * abs(want), name
    rep = chip_smoke.train_step_repeat(model, init, batches[0])
    assert rep["identical"] and rep["finite"], rep
    assert rep["leaves"] == len(flatten_tree(init))


# (arch, capacity factor for an MoE smoke): granite's smoke (8 q heads
# on one kv head), mixtral's (top-2 of 4, no shared expert) at mixtral's
# own capacity 1.25, llava's (16 stub embeddings before the tokens)
NEW_TRAIN_ARCHS = [("granite-20b", None), ("mixtral-8x7b", 1.25),
                   ("llava-next-mistral-7b", None)]


@pytest.mark.parametrize("arch,capacity", NEW_TRAIN_ARCHS,
                         ids=[a for a, _ in NEW_TRAIN_ARCHS])
def test_new_arch_train_step_matches_reference_and_repeats(arch, capacity):
    """The smokes of the archs chip_smoke trains at its granite, mixtral
    and llava cuts, in float32, trained as those paths train (AdamW,
    remat): two ``make_train_step`` steps against the reference's from
    its init carried across, at B 2 x S 96 tokens; llava's batches carry
    one seeded numpy array of stub embeddings, merged into each batch as
    ``train_lm``'s ``extra_batch`` is in both packages.  Loss, gradient
    norm and learning rate within 1e-5 relative at each step (mixtral's
    picks dropping at capacity 1.25); then one step's loss and gradients
    taken twice from that init on one batch
    (``chip_smoke.train_step_repeat``): equal bit for bit."""
    import chip_smoke
    from conftest import smoke_model
    from test_torch_moe import port_config as moe_port_config
    jcfg = smoke_model(arch, dtype="float32", param_dtype="float32")[0]
    if capacity is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity))
    jm, cfg = JModel(jcfg), moe_port_config(jcfg)
    model = Model(cfg)
    kw = dict(batch_size=2, seq_len=96, steps=2, learning_rate=3e-3,
              warmup_steps=1)
    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(model, TrainConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    init = tree_map(torch.clone, params)
    data = synthetic.tokens(n_seqs=16, seq_len=97, vocab=cfg.vocab_size,
                            seed=6)["train"]
    extra = {}
    if cfg.frontend_embeds:
        extra["embeds"] = np.random.default_rng(7).normal(
            0, 1, (2, cfg.frontend_embeds, cfg.d_model)).astype(np.float32)
    jbatches = [{**b, **extra} for b in
                pipeline.TokenDataset(data, 0).batches(2, steps=2)]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in jbatches]
    jstate, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jstep)
    with chip_smoke.DropCount() as drops:
        for jb, b in zip(jbatches, batches):
            jp, jstate, jm_ = jstep(jp, jstate, {k: jnp.asarray(v)
                                                 for k, v in jb.items()})
            params, state, m = step(params, state, b)
            for name in ("loss", "grad_norm", "lr"):
                want = float(jm_[name])
                assert abs(float(m[name]) - want) <= 1e-5 * abs(want), name
    assert (drops.share > 0.0) == (capacity is not None)
    rep = chip_smoke.train_step_repeat(model, init, batches[0])
    assert rep["identical"] and rep["finite"], rep
    assert rep["leaves"] == len(flatten_tree(init))


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
