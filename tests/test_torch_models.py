"""The port's decoder LM (configs, layers, transformer, Model, serve
steps) against the JAX reference on the CPU.

The tiny LM (``conftest.tiny_lm_config``) and the phi4-mini, gemma2,
recurrentgemma and rwkv6 SMOKE configs in float32 run through both
packages with the reference's parameters carried across by
``convert.lm_params_from_reference``.  Tolerance: logits within 1e-5 of
the reference's largest logit (relative), caches (KV and recurrent
state) within 1e-5 absolute — the same float32 arithmetic summed in
another order (and RoPE's float32 ``theta ** x`` may differ by an ulp
between the frameworks; the reference's RG-LRU takes an associative
scan on the CPU, the port's plain version a sequential one).  Greedy tokens and every integer
decision are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model, tiny_lm_config
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.core import distill as jdistill
from repro.models import Model as JModel
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.core import distill
from repro_torch.models import Model

ARCHS = ["tiny", "phi4-mini-3.8b", "gemma2-27b", "recurrentgemma-2b",
         "rwkv6-7b"]
PORTED = ["phi4-mini-3.8b", "gemma2-27b", "recurrentgemma-2b", "rwkv6-7b",
          "mixtral-8x7b", "deepseek-moe-16b", "stablelm-3b", "granite-20b",
          "llava-next-mistral-7b", "whisper-tiny"]
# parameters of the full-width models, from ``jax.eval_shape`` of the
# reference's init
PARAM_COUNTS = {"phi4-mini-3.8b": 3_836_021_760,
                "whisper-tiny": 36_448_128,
                "deepseek-moe-16b": 16_377_694_208,
                "granite-20b": 20_316_401_664,
                "llava-next-mistral-7b": 7_241_732_096,
                "stablelm-3b": 2_795_443_200,
                "mixtral-8x7b": 46_702_792_704}
RECURRENT = ("rglru", "rwkv")
RTOL = 1e-5


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, port Model, port params, jax Model, jax params)."""
    if request.param == "tiny":
        jcfg = tiny_lm_config()
        jm = JModel(jcfg)
    else:
        jcfg, jm = smoke_model(request.param, dtype="float32",
                               param_dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return cfg, Model(cfg), params, jm, jp


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), err


def _close_cache(cfg, got, want):
    want = lm_cache_from_reference(cfg, jax.tree.map(np.asarray, want),
                                   device="cpu")
    assert len(got) == len(want) == cfg.num_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for n in w:
            assert g[n].shape == w[n].shape and g[n].dtype == w[n].dtype
            torch.testing.assert_close(g[n], w[n], atol=1e-5, rtol=0)


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference(arch):
    for mine, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.layer_kinds == theirs.pattern * theirs.num_periods \
            + theirs.tail_kinds


def test_unported_archs_raise():
    """Every arch of the reference is ported (whisper-tiny, the
    encoder-decoder, was the last): ``NOT_PORTED`` is empty, the arch
    ids are the reference's, and an unknown arch raises."""
    from repro_torch.configs.registry import ARCH_IDS, NOT_PORTED
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert NOT_PORTED == ()
    assert ARCH_IDS == JARCH_IDS
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown"):
        get_smoke("gpt-5")
    cfg = port_config(jget_smoke("whisper-tiny"))
    assert Model(cfg).init(device="cpu").dec[0].xattn.wq.shape == \
        (cfg.d_model, cfg.num_heads * cfg.head_dim_)


@pytest.mark.parametrize("arch", PORTED)
def test_full_width_parameters_match_the_reference(arch):
    """Every parameter of the full-width model, by name and shape, as
    the reference's (abstract) init lays it out: 3.84 B for phi4-mini.
    The port is built on the meta device, so nothing is allocated."""
    jcfg = jget_config(arch)
    jshapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    want = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    from repro_torch.models.transformer import new_module
    mod = new_module(get_config(arch), torch.device("meta"))
    got = sum(p.numel() for p in mod.parameters())
    assert got == want
    if arch in PARAM_COUNTS:
        assert got == PARAM_COUNTS[arch]

    def shapes(subtree, stacked):
        return {".".join(k.key for k in path): leaf.shape[stacked:]
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(subtree)[0]}

    def mine(block):
        return {n: tuple(p.shape) for n, p in block.named_parameters()}

    if jcfg.is_encoder_decoder:
        # the reference's enc / dec leaves stacked over the layers, the
        # port's listed; every matrix bf16, every norm float32
        for key in ("enc", "dec"):
            for layer in getattr(mod, key):
                assert mine(layer) == shapes(jshapes[key], 1)
        for key in ("embed", "enc_norm", "final_norm"):
            assert mine(getattr(mod, key)) == shapes(jshapes[key], 0)
        for n, p in mod.named_parameters():
            want_dt = torch.float32 if "norm" in n else torch.bfloat16
            assert p.dtype == want_dt, n
        return

    # layer by layer: head block i is blocks[i], the reference's period
    # b{j} leaves (unstacked) are blocks[fkd + j]
    fkd = get_config(arch).layer_plan()[0]
    assert len(jshapes["head_blocks"]) == fkd
    for i in range(fkd):
        assert mine(mod.blocks[i]) == shapes(jshapes["head_blocks"][i], 0)
    for j in range(len(jcfg.pattern)):
        assert mine(mod.blocks[fkd + j]) == \
            shapes(jshapes["periods"][f"b{j}"], 1)
    if arch == "phi4-mini-3.8b":
        cfg = get_config(arch)
        # bf16 matrices, float32 norm scales
        assert mod.blocks[0].attn.wq.dtype == torch.bfloat16
        assert mod.blocks[0].norm1.scale.dtype == torch.float32
        # KV cache: 131 KB per token (32 layers x k,v x 8 heads x 128)
        per_tok = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim_ * 2
        assert per_tok == 131_072
    # parameters the reference reads in float32 are stored in float32
    f32 = {"rglru.w_a", "rglru.w_x", "rglru.lam", "tm.w0", "tm.u",
           "tm.ln_scale"}
    for block in mod.blocks:
        for n, p in block.named_parameters():
            if n in f32:
                assert p.dtype == torch.float32, n
            elif p.dim() >= 2 and not n.startswith("norm"):
                assert p.dtype == torch.bfloat16, n
    if arch == "recurrentgemma-2b":
        assert mod.blocks[0].rglru.w_a.dtype == torch.float32
        assert [hasattr(b, "attn") for b in mod.blocks].count(True) == 8
    if arch == "rwkv6-7b":
        assert mod.blocks[0].tm.u.dtype == torch.float32
        assert mod.blocks[0].norm1.bias.shape == (4096,)


def test_init_is_seeded_and_typed():
    cfg = get_smoke("gemma2-27b")
    a = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.blocks[1].attn.wo.dtype == torch.bfloat16
    assert a.blocks[1].post_norm2.scale.dtype == torch.float32
    std = a.blocks[0].ffn.w_up.float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.01


def test_argmax_takes_the_first_of_equal_maxima():
    x = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                  [0.0, -1.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    got = torch.argmax(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 0])


# ---------------------------------------------------------------------------
# forward, caches and the serve steps
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache_match(pair):
    cfg, model, params, jm, jp = pair
    toks = _tokens(cfg, (2, 80), 0)      # crosses gemma2-smoke's window 64
    jl, jc = jm.logits(jp, {"tokens": jnp.asarray(toks)}, mode="prefill")
    with torch.inference_mode():
        pl, pc = model.logits(params, {"tokens": torch.from_numpy(toks)},
                              mode="prefill")
    _close_logits(pl, jl)
    _close_cache(cfg, pc, jc)


def test_grow_cache_and_decode_match(pair):
    """serve_batch's path: prefill, grow (a sliding-window cache past
    its window becomes a ring), then decode steps at scalar positions."""
    cfg, model, params, jm, jp = pair
    P = 70
    toks = _tokens(cfg, (2, P), 1)
    jprefill = jax.jit(jdistill.make_prefill_step(jm))
    jdecode = jax.jit(jdistill.make_decode_step(jm))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    jc = jm.grow_cache(jc, 6)
    pl, pc = distill.make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks)})
    pc = model.grow_cache(pc, 6)
    _close_logits(pl, jl)
    _close_cache(cfg, pc, jc)
    if "attn_local" in cfg.pattern:
        local = cfg.layer_kinds.index("attn_local")
        assert pc[local]["k"].shape[1] == cfg.window  # the ring
    decode = distill.make_decode_step(model)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ptok = torch.argmax(pl[:, -1], dim=-1)[:, None]
    for i in range(6):
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        # both from the same cache: a recurrent state advances per call
        jlog, jc_next = jm.logits(jp, {"tokens": jtok}, mode="decode",
                                  cache=jc, pos=jnp.int32(P + i))
        jtok, _ = jdecode(jp, jtok, jc, jnp.int32(P + i))
        jc = jc_next
        ptok, pc, plog = decode(params, ptok, pc, P + i)
        _close_logits(plog, jlog[:, -1])
    _close_cache(cfg, pc, jc)


def test_bucket_prefill_insert_and_per_row_decode_match(pair):
    """The engine's path: a padded bucket prefill, its rows written into
    a slot cache (ring conversion with each request's true length,
    zero-filled tails, a dropped padding row), then decode steps with
    per-row positions."""
    cfg, model, params, jm, jp = pair
    num_slots, cache_len, Pb = 3, 128, 128
    if any(k in RECURRENT for k in cfg.pattern):
        # recurrent state has no length axis to insert along: both
        # packages refuse (their engines never get this far)
        toks = jnp.zeros((1, 8), jnp.int32)
        _, jpc = jm.logits(jp, {"tokens": toks}, mode="prefill")
        with pytest.raises(ValueError, match="insertable"):
            jm.insert_cache(jm.init_cache(num_slots, cache_len), jpc,
                            jnp.zeros(1, jnp.int32), jnp.ones(1, jnp.int32))
        _, ppc = model.logits(params, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int32)}, mode="prefill")
        with pytest.raises(ValueError, match="insertable"):
            model.insert_cache(model.init_cache(num_slots, cache_len,
                                                device="cpu"), ppc, [0], [1])
        return
    plens = np.array([100, 30, 70, 1], np.int32)
    slots = np.array([2, 0, 1, num_slots], np.int32)    # last row dropped
    toks = _tokens(cfg, (4, Pb), 2)
    for i, n in enumerate(plens):
        toks[i, n:] = 0
    jtok, jpc = jax.jit(jdistill.make_bucket_prefill_step(jm))(
        jp, jnp.asarray(toks), jnp.asarray(plens))
    jslot = jm.insert_cache(jm.init_cache(num_slots, cache_len), jpc,
                            jnp.asarray(slots), jnp.asarray(plens))
    ptok, ppc, plog = distill.make_bucket_prefill_step(model)(
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
    jdecode = jax.jit(jdistill.make_decode_step(jm))
    jcur, pcur = jnp.asarray(cur)[:, None], torch.from_numpy(cur)[:, None]
    for step in range(4):
        p = pos + step
        jlog, _ = jm.logits(jp, {"tokens": jcur}, mode="decode",
                            cache=jslot, pos=jnp.asarray(p))
        jcur, jslot = jdecode(jp, jcur, jslot, jnp.asarray(p))
        pcur, pslot, plog = decode(params, pcur, pslot,
                                   torch.from_numpy(p).long())
        _close_logits(plog, jlog[:, -1])
        np.testing.assert_array_equal(pcur.numpy(), np.asarray(jcur))
    _close_cache(cfg, pslot, jslot)
