"""The port's encoder-decoder (``models/encdec.py``, whisper-tiny's
config, cross attention, the Model branch, conversion, serving and one
train step) against the JAX reference on the CPU, at whisper's SMOKE
widths (2 + 2 layers, d 128) in float32, with the reference's 64 frames
and with 100 (a ragged last 64-key tile for K3 on the card).

Both packages run the same numpy-seeded inputs with the reference's
parameters carried across by ``convert``.  The reference runs as its
own tests run it on the CPU: ``impl="auto"`` resolves to its xla path.

The reference's padded keys: on its kernel path (the TPU) the reference
pads k and v with zeros to a multiple of 512, and its kernel's mask has
no ``kpos < Skv`` test, so under ``causal=False`` (whisper's encoder and
cross attention) the padded keys join the softmax with a zero value
(``repro/kernels/ops.py:87-90``, ``flash_attention.py:52-56``).  The
xla path masks nothing it has not got: it attends exactly the Skv keys.
The port follows the xla path (its K3 masks ``kpos < Skv``), and these
tests compare against the xla path.

Tolerances (the same float32 arithmetic summed in another order):
  - the sinusoid tables within 1e-6;
  - ``init_tree`` within 3e-7 + 3e-7 |x| of the reference's init
    (``prng.normal`` is within 2.5e-7 of ``jax.random.normal``, not bit
    for bit), every path and shape exactly; conversions exact;
  - the encoder output within 1e-5 of its largest |value|, logits within
    1e-5 of the largest |logit|, caches within 1e-5 absolute; greedy
    tokens exact; served streams by the gap rule
    (``serving.compare_stream``);
  - one AdamW step: loss within 1e-6 relative, first-step gradients
    within 1e-5 of each leaf's largest |gradient|, parameters by the
    AdamW split of ROADMAP §3;
  - the plain attention, non-causal over Sq != Skv, within 1e-6 of the
    reference's ``_attention_xla``; its plain backward within 1e-5 of
    ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.checkpoint import flatten_tree as jflatten
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.kernels import ops as jops
from repro.models import encdec as jencdec
from repro.serving import serve_batch as jserve_batch
from repro_torch import prng
from repro_torch.configs import TrainConfig, get_config, get_smoke
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference,
                                 lm_tree_from_reference)
from repro_torch.core import distill
from repro_torch.kernels import ref
from repro_torch.models import Model, encdec
from repro_torch.serving import compare_stream, serve_batch
from repro_torch.tree_util import flatten_tree, tree_map
from test_torch_moe import port_config
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
FRAMES = (64, 100)


@pytest.fixture(scope="module", params=FRAMES, ids=lambda n: f"frames{n}")
def pair(request):
    """(cfg, port Model, serving module, float32 tree, jax Model, jax
    params) at the smoke with ``request.param`` encoder frames."""
    n = request.param
    jcfg, jm = smoke_model("whisper-tiny", dtype="float32",
                           param_dtype="float32", encoder_seq_len=n,
                           frontend_embeds=n)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    npp = jax.tree.map(np.asarray, jp)
    return (cfg, Model(cfg), lm_params_from_reference(cfg, npp, "cpu"),
            lm_tree_from_reference(cfg, npp, "cpu"), jm, jp)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, B, seed=5):
    return np.random.default_rng(seed).normal(
        0, 1, (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), err


def _close_cache(cfg, got, want):
    want = lm_cache_from_reference(cfg, jax.tree.map(np.asarray, want),
                                   device="cpu")
    for part in ("self", "cross"):
        assert len(got[part]) == len(want[part]) == cfg.num_layers
        for g, w in zip(got[part], want[part]):
            for n in ("k", "v"):
                assert g[n].shape == w[n].shape and g[n].dtype == w[n].dtype
                torch.testing.assert_close(g[n], w[n], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# config, sinusoid, parameters, conversion
# ---------------------------------------------------------------------------
def test_model_interface_and_insert_cache_refusal():
    """whisper's Model has the reference's interface, and its slot-cache
    insert raises as the reference's."""
    cfg = get_smoke("whisper-tiny")
    model = Model(cfg)
    for name in ("init", "init_tree", "hidden", "loss", "predict", "logits",
                 "grow_cache", "init_cache"):
        assert callable(getattr(model, name))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        model.insert_cache(None, None, [0], [1])
    params = model.init(device="cpu")
    assert isinstance(params, encdec.EncDec)
    assert len(params.enc) == cfg.num_encoder_layers
    assert len(params.dec) == cfg.num_layers
    assert not hasattr(params, "lm_head")          # tied embeddings


@pytest.mark.parametrize("S,D", [(1500, 384), (64, 128),
                                 (encdec.DEC_POSITIONS, 384)])
def test_sinusoid_matches_reference(S, D):
    want = np.asarray(jencdec._sinusoid(S, D, jnp.float32))
    got = encdec._sinusoid(S, D, torch.float32, torch.device("cpu"))
    assert got.shape == (S, D)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6
    # built once per (S, D, dtype, device)
    assert encdec._sinusoid(S, D, torch.float32, torch.device("cpu")) is got
    bf = encdec._sinusoid(S, D, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_init_tree_matches_reference_init(pair):
    cfg, model, _, _, _, jp = pair
    want = jflatten(jax.tree.map(np.asarray, jp))
    got = lm_params_to_reference(cfg, model.init_tree(prng.PRNGKey(0),
                                                      "cpu"))
    assert set(got) == set(want)
    for path, a in got.items():
        assert a.shape == want[path].shape, path
        np.testing.assert_allclose(a, want[path], rtol=3e-7, atol=3e-7,
                                   err_msg=path)
        if "norm" in path:                           # ones and zeros
            np.testing.assert_array_equal(a, want[path])


def test_conversions_round_trip_exactly(pair):
    """Reference -> port -> reference, exactly: the parameters (module
    and tree) and a prefill cache (the cross K/V unstacked per layer)."""
    cfg, model, params, tree, jm, jp = pair
    want = jflatten(jax.tree.map(np.asarray, jp))
    for form in (params, tree):
        got = lm_params_to_reference(cfg, form)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])
    assert want["enc/attn/wq"].shape[0] == cfg.num_encoder_layers
    assert want["dec/xattn/wk"].shape[0] == cfg.num_layers
    toks, fr = _tokens(cfg, (2, 9), 3), _frames(cfg, 2)
    _, jc = jm.logits(jp, {"tokens": jnp.asarray(toks),
                           "frames": jnp.asarray(fr)}, mode="prefill")
    pc = lm_cache_from_reference(cfg, jax.tree.map(np.asarray, jc), "cpu")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            back = np.stack([c[name].numpy() for c in pc[part]])
            np.testing.assert_array_equal(back, np.asarray(jc[part][name]))
    assert pc["cross"][0]["k"].shape == (2, cfg.encoder_seq_len,
                                         cfg.num_kv_heads, cfg.head_dim_)
# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
def test_encode_and_train_logits_match(pair):
    cfg, model, params, _, jm, jp = pair
    toks, fr = _tokens(cfg, (2, 24), 0), _frames(cfg, 2)
    jenc = jencdec.encode(jm.cfg, jp, jnp.asarray(fr))
    with torch.no_grad():
        enc = encdec.encode(cfg, params, torch.from_numpy(fr))
        pl, _ = model.logits(params, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(fr)})
    _close(enc, jenc)
    jl, _ = jm.logits(jp, {"tokens": jnp.asarray(toks),
                           "frames": jnp.asarray(fr)})
    assert pl.shape == (2, 24, cfg.vocab_size)
    _close(pl, jl)


def test_prefill_and_decode_match_reference_and_full_forward(pair):
    """Prefill P tokens, grow by 8, then 8 teacher-forced decode steps:
    every step's logits within 1e-5 of the reference's and of the port's
    own full forward at that position (the reference's
    ``test_decode_matches_full_forward`` on the port); the caches as the
    reference's, the cross K/V never grown."""
    cfg, model, params, _, jm, jp = pair
    P, n = 16, 8
    toks, fr = _tokens(cfg, (2, P + n), 1), _frames(cfg, 2)
    jl, jc = jax.jit(jdistill.make_prefill_step(jm))(
        jp, {"tokens": jnp.asarray(toks[:, :P]), "frames": jnp.asarray(fr)})
    pl, pc = distill.make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks[:, :P]),
                 "frames": torch.from_numpy(fr)})
    _close(pl, jl)
    _close_cache(cfg, pc, jc)
    jc, pc = jm.grow_cache(jc, n), model.grow_cache(pc, n)
    assert pc["self"][0]["k"].shape[1] == P + n
    assert pc["cross"][0]["k"].shape[1] == cfg.encoder_seq_len
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": torch.from_numpy(toks),
                                        "frames": torch.from_numpy(fr)})
    jdecode = jax.jit(lambda p, t, c, pos: jm.logits(
        p, {"tokens": t}, mode="decode", cache=c, pos=pos))
    decode = distill.make_decode_step(model)
    for i in range(n):
        tok = toks[:, P + i:P + i + 1]
        jlog, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(P + i))
        _, pc, plog = decode(params, torch.from_numpy(tok), pc, P + i)
        _close(plog, jlog[:, -1])
        want = full[:, P + i]
        assert float((plog - want).abs().max()) <= \
            RTOL * float(want.abs().max())
    _close_cache(cfg, pc, jc)


def test_serve_batch_with_frames_holds_to_reference(pair):
    """``serve_batch`` with ``frames`` in ``extra`` and a ``cache_len``
    against the reference's: streams by the gap rule.  The reference's
    logits are those its tokens were read from, recomputed by one full
    forward over its stream."""
    cfg, model, params, _, jm, jp = pair
    P, gen = 12, 6
    toks, fr = _tokens(cfg, (2, P), 2), _frames(cfg, 2, seed=7)
    got, stats = serve_batch(model, params, toks, gen, cache_len=P + gen + 4,
                             extra={"frames": fr}, verbose=False,
                             keep_logits=True)
    jtoks, _ = jserve_batch(jm, jp, toks, gen, cache_len=P + gen + 4,
                            extra={"frames": jnp.asarray(fr)},
                            verbose=False)
    seq = np.concatenate([toks, jtoks[:, :-1]], axis=1)
    jfull, _ = jm.logits(jp, {"tokens": jnp.asarray(seq),
                              "frames": jnp.asarray(fr)})
    jlog = np.array(jfull)[:, P - 1:]
    assert got.shape == (2, gen) and stats["generated"] == 2 * gen
    for b in range(2):
        r = compare_stream(got[b], stats["logits"][b], jtoks[b], jlog[b])
        assert r["match"] or r["explained"], r
        assert r["max_diff"] <= RTOL * float(np.abs(jlog[b]).max()), r


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
ADAMW_GRAD_FLOOR = 1e-2


def _worst(x):
    return float(x.max()) if x.numel() else 0.0


def test_train_step_matches_reference(pair):
    """One ``make_train_step`` step (AdamW, remat) from the reference's
    init carried across, ``frames`` in the batch: the loss, the
    first-step gradients, and the parameters split as ROADMAP §3 holds
    AdamW (an element whose gradient sign is fixed with a margin within
    1e-4 of its leaf's largest |value|, any other within the bound of a
    free sign plus that)."""
    import chip_smoke
    cfg, model, _, tree, jm, jp = pair
    toks, fr = _tokens(cfg, (4, 17), 4), _frames(cfg, 4, seed=6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": fr}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(batch_size=4, seq_len=16, steps=3, learning_rate=3e-3,
              warmup_steps=1)
    jgrads = jax.jit(jax.grad(lambda p: jm.loss(p, jbatch)))(jp)
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      tree)
    flat = flatten_tree(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        model.loss(leaves, pbatch), list(flat.values()))))
    gwant = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu"))
    assert set(grads) == set(gwant)
    for name, g in grads.items():
        w = gwant[name]
        assert float((g - w).abs().max()) <= \
            1e-5 * float(w.abs().max()) + 1e-12, name

    jstep, jopt = jdistill.make_train_step(jm, JTrainConfig(**kw))
    step, opt = distill.make_train_step(model, TrainConfig(**kw))
    jp2, _, jmet = jax.jit(jstep)(jp, jopt.init(jp), jbatch)
    params = tree_map(lambda t: t.clone(), tree)
    params, state, met = step(params, opt.init(params), pbatch)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-6 * abs(float(jmet["loss"]))
    want = flatten_tree(lm_tree_from_reference(
        cfg, jax.tree.map(np.asarray, jp2), "cpu"))
    free = chip_smoke.adam_free_bound([float(met["lr"])])
    for name, t in flatten_tree(params).items():
        g, w = grads[name], gwant[name]
        diff = (t - want[name]).abs()
        tol = 1e-4 * float(want[name].abs().max())
        fixed = (torch.sign(g) == torch.sign(w)) & \
            (w.abs() >= ADAMW_GRAD_FLOOR * w.abs().max())
        assert _worst(diff[fixed]) <= tol, name
        assert _worst(diff[~fixed]) <= free + tol, name
    assert int(state.step) == 1


def test_train_step_splits_frames_over_microbatches():
    """At two microbatches the frames are split with their rows: the
    step's loss is the one-microbatch step's (equal halves, no mask)."""
    cfg = get_smoke("whisper-tiny").replace(dtype="float32",
                                            param_dtype="float32")
    model = Model(cfg)
    tree = model.init_tree(prng.PRNGKey(1), "cpu")
    toks, fr = _tokens(cfg, (4, 9), 8), _frames(cfg, 4, seed=9)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "frames": torch.from_numpy(fr)}
    losses = []
    for m in (1, 2):
        step, opt = distill.make_train_step(model, TrainConfig(
            batch_size=4, seq_len=8, steps=1, microbatches=m))
        params = tree_map(lambda t: t.clone(), tree)
        losses.append(float(step(params, opt.init(params), batch)[2]["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_serves_whisper_through_serve_batch(capsys):
    """The CLI's fallback: the engine refuses the encoder-decoder, and
    ``serve_batch`` serves the prompts with random stub frames."""
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "whisper-tiny", "--smoke", "--device",
                        "cpu", "--concurrent", "2", "--prompt-len", "12",
                        "--max-tokens", "3"])
    text = capsys.readouterr().out
    assert "serial fixed-batch path" in text and "encoder-decoder" in text
    assert stats["generated"] == 6 and stats["prompt_len"] == 12


# ---------------------------------------------------------------------------
# plain attention: non-causal, Sq != Skv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Skv,H,KV,dh", [(2, 65, 4, 4, 32),
                                            (24, 100, 4, 2, 32),
                                            (100, 100, 2, 2, 64),
                                            (64, 1500, 2, 2, 64)])
def test_plain_cross_attention_and_backward_match_reference(Sq, Skv, H,
                                                            KV, dh):
    """``ref.attention_plain`` (the CPU's path) non-causal over Sq !=
    Skv against the reference's ``_attention_xla``, and
    ``ref.attention_backward_plain`` (what the card holds N1 to) against
    ``jax.grad`` of the xla path."""
    rng = np.random.default_rng(Sq + Skv)
    q, do = (rng.normal(size=(2, Sq, H, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, Skv, KV, dh)).astype(np.float32)
            for _ in range(2))

    def jatt(q, k, v):
        return jops._attention_xla(q, k, v, causal=False, window=0,
                                   softcap=0.0, q_offset=0, block_q=512)

    want = jatt(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = ref.attention_plain(tq, tk, tv, causal=False, return_lse=True)
    assert float(np.abs(o.numpy() - np.asarray(want)).max()) <= 1e-6
    _, vjp = jax.vjp(jatt, *(jnp.asarray(t) for t in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    got = ref.attention_backward_plain(tq, tk, tv, o, tdo, lse,
                                       causal=False)
    for a, b in zip(got, jg):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= \
            1e-5 * float(np.abs(b).max())
def test_chip_smoke_whisper_phases_on_cpu():
    """chip_smoke.py's whisper pieces rehearsed on the CPU: the smoke's
    parity phase with frames (both sides on the CPU: identical streams)
    and the launch counts it asserts on the card."""
    import chip_smoke
    cfg = chip_smoke.whisper_smoke()
    assert cfg.encoder_seq_len == 100 and cfg.dtype == "bfloat16"
    row = chip_smoke.phase_smoke_parity("whisper-tiny", device="cpu",
                                        cfg=cfg, prompt_len=20, gen=3,
                                        tag="arch-parity")
    assert row["matched_whole"] == 3 and row["max_diff"] == 0.0
    assert chip_smoke.train_launches(get_config("whisper-tiny")) == (20, 12)
    assert chip_smoke.train_launches(get_smoke("phi4-mini-3.8b")) == (4, 2)
