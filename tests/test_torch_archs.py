"""The five decoder archs of the MoE slice — mixtral-8x7b and
deepseek-moe-16b (MoE, deepseek with a dense head block and shared
experts), stablelm-3b (parallel blocks, partial rotary, layer norm),
granite-20b (MQA, 8 q heads on one kv head at smoke width) and
llava-next-mistral-7b (frontend embeddings) — against the JAX reference
on the CPU, at their SMOKE widths in float32.

Both packages run the same numpy-seeded inputs with the reference's
parameters carried across by ``convert``.  Tolerances, as
``test_torch_models.py`` and ``test_torch_lm_model.py`` hold the dense
archs (the same float32 arithmetic summed in another order):
  - ``init_tree`` within 3e-7 + 3e-7 |x| of the reference's init;
  - logits within 1e-5 of the reference's largest |logit|, KV caches
    within 1e-5 absolute; greedy tokens exact;
  - ``Model.loss`` (with the MoE auxiliary loss) within 1e-6 relative,
    gradients within 1e-5 of each leaf's largest |gradient|.
The MoE smokes run at their own capacity factor against the reference
(the same drops on both sides); the decode-against-forward check (a
port-only property) runs at a no-drop capacity, as
``tests/test_archs.py`` does.  Mixtral's prompts pass its window of 64
keys, so the ring conversion is covered.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro import checkpoint as jcheckpoint
from repro.checkpoint import flatten_tree as jflatten
from repro.core import distill as jdistill
from repro_torch import checkpoint, prng
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference,
                                 lm_tree_from_reference)
from repro_torch.core import distill
from repro_torch.models import Model
from repro_torch.tree_util import flatten_tree, tree_map
from test_torch_moe import port_config
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["mixtral-8x7b", "deepseek-moe-16b", "stablelm-3b", "granite-20b",
         "llava-next-mistral-7b"]
MOE_ARCHS = ARCHS[:2]
RTOL = 1e-5


def no_drop(jcfg):
    """``jcfg`` at capacity factor 8.0 (>= E / K: nothing drops)."""
    return jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=8.0))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, port Model, serving params, float32 tree, jax Model, jax
    params)."""
    jcfg, jm = smoke_model(request.param, dtype="float32",
                           param_dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    npp = jax.tree.map(np.asarray, jp)
    return (cfg, Model(cfg), lm_params_from_reference(cfg, npp, "cpu"),
            lm_tree_from_reference(cfg, npp, "cpu"), jm, jp)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _embeds(cfg, B, seed=5):
    return np.random.default_rng(seed).normal(
        0, 1, (B, cfg.frontend_embeds, cfg.d_model)).astype(np.float32)


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), err


def _jdecode_logits(jm):
    """The reference's decode-mode logits, jitted: (params, tokens,
    cache, pos) -> (logits (B, 1, V), cache)."""
    return jax.jit(lambda p, t, c, pos: jm.logits(
        p, {"tokens": t}, mode="decode", cache=c, pos=pos))


def _close_cache(cfg, got, want):
    want = lm_cache_from_reference(cfg, jax.tree.map(np.asarray, want),
                                   device="cpu")
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        for n in w:
            assert g[n].shape == w[n].shape and g[n].dtype == w[n].dtype
            torch.testing.assert_close(g[n], w[n], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_init_tree_matches_reference_init(pair):
    cfg, model, _, _, _, jp = pair
    want = jflatten(jax.tree.map(np.asarray, jp))
    got = lm_params_to_reference(cfg, model.init_tree(prng.PRNGKey(0),
                                                      "cpu"))
    assert set(got) == set(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], rtol=3e-7, atol=3e-7,
                                   err_msg=path)


def test_layer_plan_is_the_references():
    """deepseek's first block is a dense head block (d_ff x 4 at smoke
    width) of the pattern's kind; the periods and the tail follow."""
    from repro.models.transformer import _layer_plan
    for arch in ARCHS + ["recurrentgemma-2b", "gemma2-27b"]:
        jcfg = smoke_model(arch)[0]
        cfg = port_config(jcfg)
        assert cfg.layer_plan() == _layer_plan(jcfg)
    cfg = port_config(smoke_model("deepseek-moe-16b")[0])
    mod = Model(cfg).init(device="cpu")
    assert mod.blocks[0].ffn.w_up.shape == (256, 128 * 4)
    assert not hasattr(mod.blocks[0].ffn, "router")
    assert mod.blocks[1].ffn.w_up.shape == (4, 256, 128)
    assert mod.blocks[1].ffn.shared.w_gate.shape == (256, 128)


# ---------------------------------------------------------------------------
# serving paths
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache_match(pair):
    cfg, model, params, _, jm, jp = pair
    toks = _tokens(cfg, (2, 80), 0)      # crosses mixtral-smoke's window
    jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend_embeds:
        e = _embeds(cfg, 2)
        jb["embeds"], pb["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    jl, jc = jm.logits(jp, jb, mode="prefill")
    with torch.inference_mode():
        pl, pc = model.logits(params, pb, mode="prefill")
    assert pl.shape == (2, 80 + cfg.frontend_embeds, cfg.vocab_size)
    _close_logits(pl, jl)
    _close_cache(cfg, pc, jc)


def test_grow_cache_and_decode_match(pair):
    """serve_batch's path (tokens only, as the CLIs serve llava):
    prefill, grow (mixtral's sliding-window cache past its window
    becomes a ring), then greedy decode steps at scalar positions."""
    cfg, model, params, _, jm, jp = pair
    P = 70
    toks = _tokens(cfg, (2, P), 1)
    jl, jc = jax.jit(jdistill.make_prefill_step(jm))(
        jp, {"tokens": jnp.asarray(toks)})
    jc = jm.grow_cache(jc, 4)
    pl, pc = distill.make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks)})
    pc = model.grow_cache(pc, 4)
    _close_logits(pl, jl)
    _close_cache(cfg, pc, jc)
    if "attn_local" in cfg.pattern:
        assert pc[0]["k"].shape[1] == cfg.window     # the ring
    decode = distill.make_decode_step(model)
    jdecode = _jdecode_logits(jm)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ptok = torch.argmax(pl[:, -1], dim=-1)[:, None]
    for i in range(4):
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        jlog, jc = jdecode(jp, jtok, jc, jnp.int32(P + i))
        jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        ptok, pc, plog = decode(params, ptok, pc, P + i)
        _close_logits(plog, jlog[:, -1])
    _close_cache(cfg, pc, jc)


def test_bucket_prefill_insert_and_per_row_decode_match(pair):
    """The engine's path: a padded bucket prefill, its rows written into
    a slot cache (a dropped padding row; mixtral's rings converted with
    each request's true length), then decode steps with per-row
    positions."""
    cfg, model, params, _, jm, jp = pair
    num_slots, cache_len, Pb = 3, 128, 96
    plens = np.array([90, 30, 70, 1], np.int32)
    slots = np.array([2, 0, 1, num_slots], np.int32)    # last row dropped
    toks = _tokens(cfg, (4, Pb), 2)
    for i, n in enumerate(plens):
        toks[i, n:] = 0
    jtok, jpc = jax.jit(jdistill.make_bucket_prefill_step(jm))(
        jp, jnp.asarray(toks), jnp.asarray(plens))
    jslot = jm.insert_cache(jm.init_cache(num_slots, cache_len), jpc,
                            jnp.asarray(slots), jnp.asarray(plens))
    ptok, ppc, _ = distill.make_bucket_prefill_step(model)(
        params, torch.from_numpy(toks), torch.from_numpy(plens).long())
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    pslot = model.insert_cache(
        model.init_cache(num_slots, cache_len, device="cpu"), ppc, slots,
        plens)
    _close_cache(cfg, pslot, jslot)
    pos = np.zeros(num_slots, np.int32)
    cur = np.zeros(num_slots, np.int32)
    for i in range(3):
        pos[slots[i]] = plens[i]
        cur[slots[i]] = ptok[i]
    decode = distill.make_decode_step(model)
    jdecode = _jdecode_logits(jm)
    jcur, pcur = jnp.asarray(cur)[:, None], torch.from_numpy(cur)[:, None]
    for step in range(3):
        p = pos + step
        jlog, jslot = jdecode(jp, jcur, jslot, jnp.asarray(p))
        jcur = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        pcur, pslot, plog = decode(params, pcur, pslot,
                                   torch.from_numpy(p).long())
        _close_logits(plog, jlog[:, -1])
        np.testing.assert_array_equal(pcur.numpy(), np.asarray(jcur))
    _close_cache(cfg, pslot, jslot)


def test_llava_embeds_prefill_then_decode_match():
    """llava's frontend path: a prefill over Se stub embeddings + P
    tokens, then decode steps at positions Se + P + i, against the
    reference; the train-mode logits drop the Se frontend positions."""
    jcfg, jm = smoke_model("llava-next-mistral-7b", dtype="float32",
                           param_dtype="float32")
    jp = jm.init(jax.random.PRNGKey(1))
    cfg = port_config(jcfg)
    model = Model(cfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                      "cpu")
    Se, P = cfg.frontend_embeds, 24
    toks, e = _tokens(cfg, (2, P + 3), 3), _embeds(cfg, 2, 6)
    jfull, _ = jm.logits(jp, {"tokens": jnp.asarray(toks),
                              "embeds": jnp.asarray(e)})
    with torch.inference_mode():
        full, _ = model.logits(params, {"tokens": torch.from_numpy(toks),
                                        "embeds": torch.from_numpy(e)})
        assert full.shape == (2, P + 3, cfg.vocab_size)
        _close_logits(full, jfull)
        _, jc = jm.logits(jp, {"tokens": jnp.asarray(toks[:, :P]),
                               "embeds": jnp.asarray(e)}, mode="prefill")
        _, pc = model.logits(params, {"tokens": torch.from_numpy(toks[:, :P]),
                                      "embeds": torch.from_numpy(e)},
                             mode="prefill")
        assert pc[0]["k"].shape[1] == Se + P
        jc, pc = jm.grow_cache(jc, 3), model.grow_cache(pc, 3)
        for i in range(3):
            t = toks[:, P + i:P + i + 1]
            jl, jc = jm.logits(jp, {"tokens": jnp.asarray(t)}, mode="decode",
                               cache=jc, pos=jnp.int32(Se + P + i))
            pl, pc = model.logits(params, {"tokens": torch.from_numpy(t)},
                                  mode="decode", cache=pc, pos=Se + P + i)
            _close_logits(pl, jl)
            # decode continues the embeds + tokens sequence
            _close_logits(pl[:, 0], full[:, P + i].numpy())
    _close_cache(cfg, pc, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_full_forward_without_drops(arch):
    """At a no-drop capacity the routing of a token does not depend on
    the others: prefill(S) + one decode step gives the full forward's
    logits at S (``tests/test_archs.py``'s check, on the port)."""
    jcfg, _ = smoke_model(arch, dtype="float32", param_dtype="float32")
    cfg = port_config(no_drop(jcfg))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    S = 24
    toks = torch.from_numpy(_tokens(cfg, (2, S + 1), 1))
    with torch.inference_mode():
        full, _ = model.logits(params, {"tokens": toks})
        _, cache = model.logits(params, {"tokens": toks[:, :S]},
                                mode="prefill")
        cache = model.grow_cache(cache, 8)
        lg, _ = model.logits(params, {"tokens": toks[:, S:]}, mode="decode",
                             cache=cache, pos=S)
    assert float((lg[:, 0] - full[:, S]).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_reference(pair):
    """``Model.loss`` (cross-entropy + the MoE auxiliary loss; llava's
    loss over its token positions behind the embeddings) and its
    gradients, with the blocks recomputed in the backward, against
    ``jax.value_and_grad`` of the reference's."""
    cfg, model, _, tree, jm, jp = pair
    toks = _tokens(cfg, (2, 33), 4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend_embeds:
        batch["embeds"] = _embeds(cfg, 2)
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      tree)
    loss = model.loss(leaves, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    flat = flatten_tree(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), materialize_grads=True)))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()) + 1e-12, (name, err)
    if cfg.parallel_block:      # norm2 is held, never read
        assert float(grads["blocks/0/norm2/scale"].abs().max()) == 0.0
    if cfg.moe:                 # the aux loss reaches the router
        assert float(grads["blocks/1/ffn/router"].abs().max()) > 0.0


def test_moe_aux_loss_is_in_the_loss():
    """``Model.loss`` = cross-entropy + the MoE blocks' load-balance
    losses (deepseek's dense head block adds none)."""
    from repro_torch.models import transformer
    cfg = port_config(smoke_model("deepseek-moe-16b")[0].replace(
        dtype="float32", param_dtype="float32"))
    model = Model(cfg)
    tree = model.init_tree(prng.PRNGKey(2), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 7))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        h, _, aux = model.hidden(tree, batch)
        ce = transformer.lm_loss(cfg, transformer.view(cfg, tree), h, toks)
        total = model.loss(tree, batch)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert float(total) == float(ce + aux)


def test_dense_forward_makes_no_aux_tensor():
    """A model without MoE blocks returns the Python float 0.0 as its
    aux loss (no device tensor a layer), and its loss is the bare
    cross-entropy."""
    from repro_torch.models import transformer
    cfg = port_config(smoke_model("stablelm-3b")[0].replace(
        dtype="float32", param_dtype="float32"))
    model = Model(cfg)
    tree = model.init_tree(prng.PRNGKey(2), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 7))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        h, _, aux = model.hidden(tree, batch)
        ce = transformer.lm_loss(cfg, transformer.view(cfg, tree), h, toks)
        total = model.loss(tree, batch)
    assert type(aux) is float and aux == 0.0
    assert torch.equal(total, ce)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoints_cross_packages(arch, tmp_path):
    """An MoE model's checkpoint written by the reference restores into
    the port, and the port's into the reference, leaf for leaf."""
    jcfg, jm = smoke_model(arch)
    cfg = port_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    jcheckpoint.save(str(tmp_path / "ref"), jp, step=1)
    tree = lm_tree_from_reference(cfg, checkpoint.load(str(tmp_path / "ref")),
                                  "cpu")
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jp), "cpu"))
    for name, t in flatten_tree(tree).items():
        assert torch.equal(t, want[name]), name
    mine = Model(cfg).init_tree(prng.PRNGKey(5), "cpu")
    checkpoint.save(str(tmp_path / "port"),
                    lm_params_to_reference(cfg, mine), step=2)
    back = jflatten(jax.tree.map(np.asarray, jcheckpoint.restore(
        str(tmp_path / "port"), jp)))
    for path, a in lm_params_to_reference(cfg, mine).items():
        np.testing.assert_array_equal(back[path], a)
    assert set(back) == set(lm_params_to_reference(cfg, mine))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,path", [("deepseek-moe-16b", "engine"),
                                       ("llava-next-mistral-7b", "serial")])
def test_serve_cli_on_the_cpu(arch, path, capsys):
    """``launch.serve --arch``: the engine serves the MoE arch; it
    refuses llava's frontend, and the CLI serves its tokens through
    ``serve_batch``, as the reference's CLI does."""
    from repro_torch.launch import serve
    from repro_torch.serving import Engine
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--concurrent", "3", "--prompt-len", "20",
                      "--max-tokens", "4", "--cache-len", "64"])
    text = capsys.readouterr().out
    if path == "engine":
        assert len(out) == 3 and all(r.num_tokens == 4 for r in out)
        assert "3 streams, 12 tokens" in text
    else:
        assert "serial fixed-batch path" in text and "decoder-only" in text
        assert out["generated"] == 12
        cfg = port_config(smoke_model(arch)[0])
        model = Model(cfg)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            Engine(model, model.init(device="cpu"), device="cpu")


def test_head_dim_80_pads_to_128_exactly():
    """K3 launches stablelm's head dim 80 as it is; N1 pads it to 128,
    exactly: zero columns leave q·k and the output's first 80 columns
    as they are, given the true dim's scale (here folded into q for the
    plain version, which takes its scale from the head dim)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    assert [fa.padded_head_dim(d) for d in (16, 32, 48, 80, 128, 200, 256,
                                             257)] == \
        [32, 32, 64, 80, 128, 256, 256, None]
    assert fa.padded_head_dim(80, fa.BWD_HEAD_DIMS) == 128
    assert fa.padded_head_dim(256, fa.BWD_HEAD_DIMS) is None
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, n, 80), generator=g) for n in (4, 2, 2))
    want = ref.attention_plain(q, k, v, causal=True, window=16)
    qp, kp, vp = fa._pad_heads((q * (128 / 80) ** 0.5, k, v), 128)
    got = ref.attention_plain(qp, kp, vp, causal=True, window=16)
    assert got.shape[-1] == 128 and float(got[..., 80:].abs().max()) == 0
    torch.testing.assert_close(got[..., :80], want, atol=1e-6, rtol=1e-6)


def test_chip_smoke_arch_phases_on_cpu():
    """chip_smoke.py's serve_batch phase (granite's smoke) and its
    card-vs-CPU parity phase (mixtral's smoke at the no-drop capacity),
    rehearsed on the CPU (their launch-count checks apply on the card);
    and the drop counter it wraps ``moe.route`` with."""
    import chip_smoke
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe as M
    m, launches = chip_smoke.phase_batch_serving(
        get_smoke("granite-20b"), device="cpu", batch=2, prompt_len=70,
        gen=3, reps=2, tag="dense")
    assert m["generated"] == 6 and m["logits_finite"]
    assert len(m["decode_step_ms_runs"]) == 2
    assert launches == {"rglru_scan": 0, "wkv6": 0, "flash_attention": 0}
    cfg = chip_smoke.no_drop(get_smoke("mixtral-8x7b"))
    assert cfg.moe.capacity_factor == 2.0          # ceil(E 4 / K 2)
    row = chip_smoke.phase_smoke_parity("mixtral-8x7b", device="cpu",
                                        cfg=cfg, tag="arch-parity")
    assert row["matched_whole"] == 3 and row["max_diff"] == 0.0
    route = M.route
    smoke = get_smoke("deepseek-moe-16b")
    model = Model(smoke)
    params = model.init(device="cpu")
    with chip_smoke.DropCount() as drops:
        with torch.inference_mode():
            model.logits(params, {"tokens": torch.zeros((2, 40),
                                                        dtype=torch.int32)})
    assert M.route is route
    # one dispatch (the one MoE layer): identical tokens crowd the same
    # experts, so all but C of each expert's 80 picks drop
    C = M.capacity(smoke, 80)
    assert drops.picks == 160 and drops.share == (160 - 2 * C) / 160
