"""The port's dry-run stack against the reference's, on the CPU.

Exact, on the same inputs: the shape names (``INPUT_SHAPES``,
``MeshConfig``, ``long_context_variant`` for every arch); the
shape-only init (``Model.init_shapes``, ``Model.cache_shapes``) against
``jax.eval_shape`` of the reference's init and cache, every leaf through
``convert._ref_path``'s mapping; the input specs; ``count_params`` and
``model_flops`` for every arch and shape kind; ``lm_protocol_bytes``
against the reference's and against the framed bytes of real messages;
``extrapolate``, ``wire_bytes`` and the dominant term on the same
numbers.  The port's own: the meta kernels' shapes and work formulas,
counters that are exactly affine in depth, and ``run_one`` over one
arch per family and every shape with the reference's record keys.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import long_context_variant as ref_long_context_variant
from repro.configs.base import InputShape as RefInputShape
from repro.configs.base import MeshConfig as RefMeshConfig
from repro.federation import codec as ref_codec
from repro.federation.messages import PartyUpdate as RefPartyUpdate
from repro.federation.messages import TokenLabels as RefTokenLabels
from repro.models import Model as RefModel
from repro_torch import configs
from repro_torch import device as D
from repro_torch.configs import get_config, get_smoke
from repro_torch.federation import codec
from repro_torch.federation.messages import PartyUpdate, TokenLabels
from repro_torch.kernels import meta, ops, ref
from repro_torch.launch import analysis, dryrun, inputs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.tree_util import flatten_tree, tree_map
from torch_reference import (cache_ref_path, param_ref_path, ref_flat,
                             reference_module)

ref_analysis = reference_module("repro.launch.analysis")
ref_inputs = reference_module("repro.launch.inputs")
ref_dryrun = reference_module("repro.launch.dryrun")

FAMILIES = ["phi4-mini-3.8b", "mixtral-8x7b", "recurrentgemma-2b",
            "whisper-tiny"]


@pytest.fixture(scope="module")
def traces():
    """Traces shared by the run_one and depth tests (a trace depends on
    (cfg, shape, train config) only)."""
    return {}


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


def _same_leaves(cfg, got_tree, want_tree, ref_path_of):
    """Every port leaf a meta tensor with the reference leaf's shape (a
    row of it, where the reference stacks) and dtype; every reference
    leaf and every row of a stacked one reached."""
    want = ref_flat(want_tree)
    rows = {}
    for path, t in flatten_tree(got_tree).items():
        assert t.is_meta, path
        rpath, idx = ref_path_of(cfg, path)
        w = want[rpath]
        shape = w.shape if idx is None else w.shape[1:]
        assert tuple(t.shape) == tuple(shape), path
        assert _dtype_name(t.dtype) == str(w.dtype), path
        rows.setdefault(rpath, set()).add(idx)
    assert set(rows) == set(want)
    for rpath, idxs in rows.items():
        if idxs != {None}:
            assert idxs == set(range(want[rpath].shape[0])), rpath


# ---------------------------------------------------------------------------
# Shape names
# ---------------------------------------------------------------------------
def test_shape_names():
    assert list(configs.INPUT_SHAPES) == list(REF_SHAPES)
    for name, shape in configs.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            REF_SHAPES[name])
    assert [f.name for f in dataclasses.fields(configs.InputShape)] == \
        [f.name for f in dataclasses.fields(RefInputShape)]
    for kw in ({}, {"pods": 2}, {"data": 4, "model": 2}):
        got, want = configs.MeshConfig(**kw), RefMeshConfig(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_devices == want.num_devices


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_context_variant(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    got, want = configs.long_context_variant(cfg), \
        ref_long_context_variant(rcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got is cfg) == (want is rcfg)
    assert got.subquadratic and cfg.subquadratic == rcfg.subquadratic


# ---------------------------------------------------------------------------
# Shape-only init and inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_match_eval_shape(arch):
    """All 10 full configs against eval_shape; at smoke width also
    against init_tree's real tree and init_cache's real cache, path for
    path."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    want = jax.eval_shape(lambda: RefModel(rcfg).init(jax.random.PRNGKey(0)))
    _same_leaves(cfg, Model(cfg).init_shapes(), want, param_ref_path)
    bf = cfg.replace(param_dtype="bfloat16")
    want = jax.eval_shape(lambda: RefModel(rcfg.replace(
        param_dtype="bfloat16")).init(jax.random.PRNGKey(0)))
    _same_leaves(bf, Model(bf).init_shapes(), want, param_ref_path)

    smoke = Model(get_smoke(arch))
    real = flatten_tree(smoke.init_tree(np.array([0, 0], np.uint32), "cpu"))
    shapes = flatten_tree(smoke.init_shapes())
    assert list(real) == list(shapes)
    for k, t in shapes.items():
        assert (t.shape, t.dtype) == (real[k].shape, real[k].dtype), k
    real = flatten_tree(smoke.init_cache(2, 40, torch.bfloat16,
                                         device="cpu"))
    shapes = flatten_tree(smoke.cache_shapes(2, 40, torch.bfloat16))
    assert list(real) == list(shapes)
    for k, t in shapes.items():
        assert t.is_meta and (t.shape, t.dtype) == \
            (real[k].shape, real[k].dtype), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shapes_match_eval_shape(arch):
    """At a length past every local window (ring caches) and at a short
    one."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for B, L in ((2, 5000), (3, 64)):
        want = jax.eval_shape(lambda: RefModel(rcfg).init_cache(
            B, L, dtype=jnp.bfloat16))
        _same_leaves(cfg, Model(cfg).cache_shapes(B, L, torch.bfloat16),
                     want, cache_ref_path)


def test_init_shapes_is_fast_and_allocates_nothing():
    cfg = get_config("mixtral-8x7b").replace(name="mixtral-uncached")
    t0 = time.perf_counter()
    tree = Model(cfg).init_shapes()
    assert time.perf_counter() - t0 < 1.0
    leaves = list(flatten_tree(tree).values())
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 46e9


def test_resolve_meta():
    assert D.resolve("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        D.resolve("meta:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve("cuda")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    for name, shape in configs.INPUT_SHAPES.items():
        if (arch, name) in ref_dryrun.SKIPS:
            continue
        cfg, _, notes = dryrun.resolve_cfg(arch, name)
        rcfg, _, rnotes = ref_dryrun.resolve_cfg(arch, name)
        assert notes == rnotes
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        if shape.kind == "decode":
            tok, cache, pos = inputs.decode_specs(cfg, shape)
            rtok, rcache, rpos = ref_inputs.decode_specs(rcfg, shape)
            for t, w in ((tok, rtok), (pos, rpos)):
                assert t.is_meta and tuple(t.shape) == w.shape
                assert _dtype_name(t.dtype) == str(w.dtype)
            _same_leaves(cfg, cache, rcache, cache_ref_path)
            continue
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            got = getattr(inputs, fn)(cfg, shape)
            want = getattr(ref_inputs, fn)(rcfg, shape)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.is_meta and tuple(t.shape) == want[k].shape, k
                assert _dtype_name(t.dtype) == str(want[k].dtype), k


def test_concrete_like():
    cfg = get_config("llava-next-mistral-7b").replace(frontend_embeds=8)
    shape = configs.InputShape("tiny", 32, 2, "train")
    got = inputs.concrete_like(inputs.train_batch_specs(cfg, shape),
                               device="cpu")
    want = ref_inputs.concrete_like(ref_inputs.train_batch_specs(
        ref_get_config("llava-next-mistral-7b").replace(frontend_embeds=8),
        shape))
    for k, t in got.items():
        assert t.device.type == "cpu" and not t.any()
        assert tuple(t.shape) == want[k].shape
        assert _dtype_name(t.dtype) == str(want[k].dtype)


# ---------------------------------------------------------------------------
# Analysis arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops(arch):
    for name, shape in configs.INPUT_SHAPES.items():
        cfg = dryrun.resolve_cfg(arch, name)[0]
        rcfg = ref_dryrun.resolve_cfg(arch, name)[0]
        got = analysis.count_params(Model(cfg).init_shapes())
        want = ref_analysis.count_params(jax.eval_shape(
            lambda: RefModel(rcfg).init(jax.random.PRNGKey(0))))
        assert got == want
        assert analysis.count_params(Model(cfg).init_shapes(),
                                     exclude_embed=False) == \
            ref_analysis.count_params(jax.eval_shape(
                lambda: RefModel(rcfg).init(jax.random.PRNGKey(0))),
                exclude_embed=False)
        ntok = shape.global_batch * (1 if shape.kind == "decode"
                                     else shape.seq_len)
        for kind in ("train", "prefill", "decode"):
            assert analysis.model_flops(cfg, kind, ntok, got) == \
                ref_analysis.model_flops(rcfg, kind, ntok, want)


def _roofline(mod, flops, byts, coll, peak=7.0):
    wb = mod.wire_bytes(coll)
    return mod.Roofline(
        arch="a", shape="s", mesh="m", flops_per_device=flops,
        bytes_per_device=byts, collective=dict(coll),
        wire_bytes_per_device=wb, t_compute=flops / mod.PEAK_FLOPS,
        t_memory=byts / mod.HBM_BW, t_collective=wb / mod.ICI_BW,
        dominant="compute", model_flops_total=3e15, useful_ratio=0.5,
        peak_memory_bytes=peak, num_devices=256, notes="n")


@pytest.mark.parametrize("case", range(4))
def test_extrapolate_wire_bytes_and_dominant(case):
    """The same numbers through both packages' ``extrapolate`` (the
    port's constants in both, so the comparison is of the arithmetic),
    and the port's dominant term against its own constants."""
    rng = np.random.default_rng(case)
    keys = ref_analysis._COLLECTIVES

    def coll():
        return {k: int(rng.integers(0, 10**12)) for k in keys}

    p1 = (float(rng.integers(1, 10**15)), float(rng.integers(1, 10**12)),
          coll())
    p2 = (p1[0] * rng.uniform(0.5, 3.0), p1[1] * rng.uniform(0.5, 3.0),
          coll())
    eff = [1.0, 2.0, 27.5, 46.0][case]
    assert analysis.wire_bytes(p1[2]) == ref_analysis.wire_bytes(p1[2])
    got = analysis.extrapolate(_roofline(analysis, *p1, peak=9.0),
                               _roofline(analysis, *p1),
                               _roofline(analysis, *p2), eff).to_dict()
    consts = {k: getattr(analysis, k) for k in ("PEAK_FLOPS", "HBM_BW",
                                                "ICI_BW")}
    saved = {k: getattr(ref_analysis, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(ref_analysis, k, v)
        want = ref_analysis.extrapolate(
            _roofline(ref_analysis, *p1, peak=9.0),
            _roofline(ref_analysis, *p1), _roofline(ref_analysis, *p2),
            eff).to_dict()
    finally:
        for k, v in saved.items():
            setattr(ref_analysis, k, v)
    assert got == want
    terms = {"compute": got["t_compute"], "memory": got["t_memory"],
             "collective": got["t_collective"]}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["peak_memory_bytes"] == 9.0


def test_h100_constants():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.HBM_BYTES,
            analysis.ICI_BW) == (989e12, 3.35e12, 80e9, 50e9)


# ---------------------------------------------------------------------------
# Protocol bytes
# ---------------------------------------------------------------------------
def _meta_like(tree):
    return jax.tree.map(lambda a: torch.empty(
        a.shape, dtype=getattr(torch, str(a.dtype)), device="meta"), tree)


def test_lm_protocol_bytes_match_reference():
    """phi4's bf16 member priced as the reference prices it (the same
    tree), and the port's own tree with the same payload."""
    rcfg = ref_get_config("phi4-mini-3.8b").replace(param_dtype="bfloat16")
    one = jax.eval_shape(lambda: RefModel(rcfg).init(jax.random.PRNGKey(0)))
    want = ref_codec.lm_protocol_bytes(one, 16, 32, 4096)
    assert codec.lm_protocol_bytes(_meta_like(one), 16, 32, 4096) == want
    cfg = get_config("phi4-mini-3.8b").replace(param_dtype="bfloat16")
    own = codec.lm_protocol_bytes(Model(cfg).init_shapes(), 16, 32, 4096)
    for k in ("members", "update_payload_bytes_per_member", "label_bytes",
              "label_payload_bytes"):
        assert own[k] == want[k], k


def test_lm_protocol_bytes_equal_real_frames():
    members, B, S = 3, 2, 16
    ref_member = {"embed": np.zeros((64, 8), np.float32),
                  "out": {"w": jnp.zeros((8, 64), jnp.bfloat16)}}
    priced = codec.lm_protocol_bytes(_meta_like(ref_member), members, B, S)
    upd = RefPartyUpdate(party_id=0, student_states=[ref_member],
                         vote_gaps=np.zeros((B * S,), np.float32),
                         num_examples=0, meta={"num_teachers": members})
    lbl = RefTokenLabels(party_id=0, labels=np.zeros((B, S), np.int32))
    assert priced["update_bytes_per_member"] == \
        len(ref_codec.encode_update(upd))
    assert priced["update_payload_bytes_per_member"] == upd.wire_bytes()
    assert priced["label_bytes"] == len(ref_codec.encode_labels(lbl))
    assert priced["label_payload_bytes"] == B * S * 4
    assert priced["members"] == members
    # the port's own frames of a float32 member
    member = {"embed": torch.zeros((64, 8)), "out": {"w": torch.ones(8, 64)}}
    priced = codec.lm_protocol_bytes(
        tree_map(lambda t: t.to("meta"), member), members, B, S)
    upd = PartyUpdate(party_id=0, student_states=[member],
                      vote_gaps=torch.zeros(B * S),
                      num_examples=0, meta={"num_teachers": members})
    lbl = TokenLabels(party_id=0, labels=torch.zeros((B, S),
                                                     dtype=torch.int32))
    assert priced["update_bytes_per_member"] == len(codec.encode_update(upd))
    assert priced["update_payload_bytes_per_member"] == upd.wire_bytes()
    assert priced["label_bytes"] == len(codec.encode_labels(lbl))


# ---------------------------------------------------------------------------
# The meta kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,Sq,Skv", [
    (True, 0, 64, 64), (True, 16, 64, 64), (False, 0, 24, 100)])
def test_meta_attention(causal, window, Sq, Skv):
    g = torch.Generator().manual_seed(0)
    B, H, KV, dh = 2, 4, 2, 32
    q = torch.randn((B, Sq, H, dh), generator=g, dtype=torch.float32)
    k, v = (torch.randn((B, Skv, KV, dh), generator=g) for _ in range(2))
    pairs = int(ref._mask(torch.arange(Sq), Skv, causal, window,
                          "cpu").sum())
    assert meta.valid_pairs(Sq, Skv, causal, window) == pairs
    want = ops.attention(q, k, v, causal=causal, window=window)
    work = meta.Work()
    mq, mk, mv = (t.to("meta").requires_grad_(True) for t in (q, k, v))
    with meta.counting(work):
        o = ops.attention(mq, mk, mv, causal=causal, window=window)
        assert o.is_meta and (o.shape, o.dtype) == (want.shape, want.dtype)
        grads = torch.autograd.grad(o.sum(), (mq, mk, mv))
    assert [tuple(t.shape) for t in grads] == [tuple(q.shape),
                                               tuple(k.shape),
                                               tuple(v.shape)]
    e = 4
    assert work.by_kernel["flash_attention"] == {
        "calls": 1, "flops": 4 * B * H * pairs * dh,
        "bytes": e * (2 * q.numel() + k.numel() + v.numel() + B * H * Sq)}
    assert work.by_kernel["flash_attention_backward"]["flops"] == \
        10 * B * H * pairs * dh
    # a decode step takes the plain path on meta, as on the card
    work = meta.Work()
    with meta.counting(work):
        o = ops.attention(mq[:, :1].detach(), mk.detach(), mv.detach(),
                          causal=causal, window=window, q_offset=Skv - 1)
    assert o.shape == (B, 1, H, dh) and work.by_kernel == {}


def test_meta_recurrences():
    g = torch.Generator().manual_seed(1)
    B, S, Dm, H, dh = 2, 12, 16, 3, 4
    x = torch.randn((B, S, Dm), generator=g).to(torch.bfloat16)
    log_a = -torch.rand((B, S, Dm), generator=g).to(torch.bfloat16)
    h, h_last = ops.rglru(x, log_a)
    r, k, v, w = (torch.rand((B, S, H, dh), generator=g) for _ in range(4))
    u = torch.randn((H, dh), generator=g)
    o, s_last = ops.wkv(r, k, v, w, u)
    work = meta.Work()
    with meta.counting(work):
        mh, mh_last = ops.rglru(x.to("meta"), log_a.to("meta"))
        mo, ms_last = ops.wkv(*(t.to("meta") for t in (r, k, v, w, u)))
        mx = x.to("meta").requires_grad_(True)
        dx = torch.autograd.grad(ops.rglru(mx, log_a.to("meta"))[0].sum(),
                                 mx)[0]
    for got, want in ((mh, h), (mh_last, h_last), (mo, o),
                      (ms_last, s_last), (dx, x)):
        assert got.is_meta and (got.shape, got.dtype) == \
            (want.shape, want.dtype)
    # K4 twice: x, log_a read, h written (bf16), h0 read and h_last
    # written (float32); under grad it also writes the float32
    # checkpoints of every 64th carry (12 steps: one a channel)
    ckpt = 4 * B * 1 * Dm
    assert work.by_kernel["rglru_scan"] == {
        "calls": 2, "flops": 2 * 3 * x.numel(),
        "bytes": 2 * (2 * 3 * x.numel() + 4 * 2 * B * Dm) + ckpt}
    # N2a as built: 7 FLOPs an element; x, log_a and dh read once, dx and
    # dlog_a written, dh0 written (no dh_last here), K4's checkpoints
    # read once
    assert work.by_kernel["rglru_scan_backward"] == {
        "calls": 1, "flops": 7 * x.numel(),
        "bytes": 2 * 5 * x.numel() + 4 * B * Dm + ckpt}
    assert work.by_kernel["wkv6"] == {
        "calls": 1, "flops": 6 * B * S * H * dh * dh,
        "bytes": 4 * (5 * r.numel() + u.numel() + 2 * B * H * dh * dh)}
    # N2b as built, in chunks of 16 (12 steps: one chunk of 16 padded
    # steps a (b, h)): 10 dh^2 + 2 C dh + 9 (C - 1) dh FLOPs a padded
    # step, 2 dh^2 a chunk; 11 reads of r's size (the chains' k, v, w and
    # r, w, dO, the chunks' r, k, v, w, dO), 4 writes, u and s0 read, du
    # and ds0 written, the checkpoints (2, B, H, 1, dh, dh) and du's
    # partials (B, H, 1, dh) written and read
    work = meta.Work()
    with meta.counting(work):
        leaves = [t.to("meta").requires_grad_(True) for t in (r, k, v, w, u)]
        torch.autograd.grad(ops.wkv(*leaves)[0].sum(), leaves)
    C, steps = 16, B * H * 16
    assert work.by_kernel["wkv6_backward"] == {
        "calls": 1,
        "flops": (10 * dh * dh + 2 * C * dh + 9 * (C - 1) * dh) * steps
        + 2 * dh * dh * B * H,
        "bytes": 4 * (15 * r.numel() + 2 * u.numel() + 2 * B * H * dh * dh
                      + 2 * (2 * B * H * dh * dh + B * H * dh))}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "stablelm-3b", "deepseek-moe-16b",
                                  "gemma2-27b"])
def test_chip_smoke_train_launches_match_the_dry_run(arch):
    """chip_smoke's ``train_launches`` (read from the layer pattern) and
    the dry-run's predicted calls of K3, N1, K4, N2a, K5 and N2b agree
    for the recurrent smokes', stablelm's, deepseek-moe's and gemma2's
    train step:
    ``dryrun_train`` raises where they differ, as it does on the card
    against the counted launches."""
    import chip_smoke
    cfg = get_smoke(arch)
    want = chip_smoke.train_launches(cfg)
    row = chip_smoke.dryrun_train("cpu", {
        "step_ms_median_last6": 1.0, "peak_mem_bytes": 1 << 40,
        "launches_per_step": want}, cfg)
    assert row["predicted_launches_per_step"] == {
        k: v for k, v in want.items() if v}
    kinds = cfg.layer_kinds
    if arch == "rwkv6-7b":
        assert want["wkv6"] == 2 * len(kinds)
        assert want["wkv6_backward"] == 3 * len(kinds)
    elif arch in ("stablelm-3b", "deepseek-moe-16b", "gemma2-27b"):
        assert want["flash_attention"] == 2 * len(kinds)
        assert want["flash_attention_backward"] == 3 * len(kinds)
        assert want["rglru_scan"] == want["wkv6"] == 0
    else:
        assert want["rglru_scan"] == 2 * kinds.count("rglru")
        assert want["rglru_scan_backward"] == kinds.count("rglru")
        assert want["flash_attention"] == 2 * kinds.count("attn_local")


def test_deepseek_train_cut_fits_one_card_by_the_dry_run():
    """chip_smoke's deepseek-moe-16b cut (``DEEPSEEK_TRAIN_LAYERS``, the
    dense head block and MoE blocks) priced at lm_train's step (B 4 x S
    512, remat, AdamW, float32 masters) on one device: its predicted
    peak is at most 72 GB (the cut's rule: the other cuts measured up to
    6 GB above their resident state), with 2 K3 and 3 N1 launches a
    layer; all 28 layers' is over the card's 80 GB."""
    import chip_smoke
    from repro_torch.configs import get_config

    def peak(cfg):
        want = chip_smoke.train_launches(cfg)
        row = chip_smoke.dryrun_train("cpu", {
            "step_ms_median_last6": 1.0, "peak_mem_bytes": 1 << 40,
            "launches_per_step": want}, cfg)
        return row["predicted"]["peak_memory_bytes"], \
            row["predicted_launches_per_step"]

    cut = chip_smoke.deepseek_train_config()
    assert cut.num_layers == chip_smoke.DEEPSEEK_TRAIN_LAYERS
    assert cut.moe.capacity_factor == 1.25
    got, launches = peak(cut)
    L = chip_smoke.DEEPSEEK_TRAIN_LAYERS
    assert launches == {"flash_attention": 2 * L,
                        "flash_attention_backward": 3 * L}
    assert got <= 72e9, got
    assert peak(get_config("deepseek-moe-16b"))[0] > analysis.HBM_BYTES


def test_gemma2_train_cut_fits_one_card_by_the_dry_run():
    """chip_smoke's gemma2-27b cut (``gemma2_train_config``) priced at
    gemma2_train's step (B 2 x S 8192, remat, AdamW, float32 masters) on
    one device: 4 layers, the full config's first 4 kinds (2 local, 2
    global) at full width with window 4096, both soft-caps and tied
    embeddings; 8 K3 calls and 12 N1 launches a step; a predicted peak
    of at most 72 GB; all 46 layers' over the card's 80 GB."""
    import chip_smoke
    from repro_torch.configs.base import ATTN, ATTN_LOCAL
    full = get_config("gemma2-27b")
    cut = chip_smoke.gemma2_train_config()
    B, S = chip_smoke.GEMMA2_TRAIN_B, chip_smoke.GEMMA2_TRAIN_S
    assert (B, S) == (2, 8192)
    assert cut.num_layers == chip_smoke.GEMMA2_TRAIN_LAYERS == 4
    assert cut.layer_kinds == full.layer_kinds[:4]
    assert cut.layer_kinds.count(ATTN_LOCAL) == \
        cut.layer_kinds.count(ATTN) == 2
    assert cut.replace(num_layers=full.num_layers) == full

    def price(cfg):
        want = chip_smoke.train_launches(cfg)
        row = chip_smoke.dryrun_train("cpu", {
            "step_ms_median_last6": 1.0, "peak_mem_bytes": 1 << 40,
            "launches_per_step": want}, cfg, B=B, S=S)
        assert (row["B"], row["S"]) == (B, S)
        return row["predicted"]["peak_memory_bytes"], \
            row["predicted_launches_per_step"]

    got, launches = price(cut)
    assert launches == {"flash_attention": 8, "flash_attention_backward": 12}
    assert got <= 72e9, got
    assert price(full)[0] > analysis.HBM_BYTES


def test_recurrentgemma_f32_train_fits_one_card_by_the_dry_run():
    """chip_smoke's recurrentgemma-2b in float32
    (``recurrentgemma_f32_config``: all 26 layers, full width) priced at
    lm_train's step (B 4 x S 512, remat, AdamW, float32 masters) on one
    device: a predicted peak of at most 72 GB; its 8 local-attention
    layers' 16 K3 and 24 N1 launches a step, and 36 K4 and 18 N2a calls,
    equal to ``train_launches``; and ``step_launches`` counts every K3
    and N1 launch as the float32 kernels' (none in the bf16 config)."""
    import chip_smoke
    cfg = chip_smoke.recurrentgemma_f32_config()
    assert (cfg.dtype, cfg.num_layers) == ("float32", 26)
    assert cfg.replace(dtype="bfloat16") == get_config("recurrentgemma-2b")
    want = chip_smoke.train_launches(cfg)
    row = chip_smoke.dryrun_train("cpu", {
        "step_ms_median_last6": 1.0, "peak_mem_bytes": 1 << 40,
        "launches_per_step": chip_smoke.step_launches(cfg)}, cfg)
    assert row["predicted_launches_per_step"] == {
        k: v for k, v in want.items() if v}
    assert row["predicted_kernel_calls"] == {
        "flash_attention": 16, "flash_attention_backward": 8,
        "rglru_scan": 36, "rglru_scan_backward": 18}
    assert row["predicted"]["peak_memory_bytes"] <= 72e9
    f32 = chip_smoke.step_launches(cfg)
    assert (f32["flash_attention_f32"], f32["flash_attention_backward_f32"]) \
        == (16, 24)
    bf16 = chip_smoke.step_launches(get_config("recurrentgemma-2b"))
    assert (bf16["flash_attention_f32"],
            bf16["flash_attention_backward_f32"]) == (0, 0)


# chip_smoke's cuts of granite-20b, mixtral-8x7b and llava: (config
# function, layers constant, its value, B, S, the full config's layers)
NEW_CUTS = {"granite": ("granite_train_config", "GRANITE_TRAIN_LAYERS", 8,
                        4, 512, 52),
            "mixtral": ("mixtral_train_config", "MIXTRAL_TRAIN_LAYERS", 2,
                        4, 512, 32),
            "llava": ("llava_train_config", "LLAVA_TRAIN_LAYERS", 16, 1,
                      4096, 32)}


@pytest.mark.parametrize("name", list(NEW_CUTS))
def test_new_train_cuts_fit_one_card_by_the_dry_run(name):
    """chip_smoke's granite-20b, mixtral-8x7b and llava-next-mistral-7b
    cuts, each priced at its step (granite and mixtral B 4 x S 512;
    llava B 1 x S 4096, 2880 stub embeddings and 1216 tokens; remat,
    AdamW, float32 masters) on one device: the full config at its own
    widths but for depth (mixtral at capacity 1.25), a predicted peak of
    at most 72 GB, and predicted K3 and N1 launches a step equal to
    ``chip_smoke.step_launches`` (2 K3 and 3 N1 launches a layer)."""
    import chip_smoke
    fn, const, layers, B, S, full_layers = NEW_CUTS[name]
    cut = getattr(chip_smoke, fn)()
    assert getattr(chip_smoke, const) == cut.num_layers == layers
    full = get_config(cut.name)
    assert full.num_layers == full_layers
    assert cut.replace(num_layers=full_layers) == full
    if cut.moe:
        assert (cut.moe.capacity_factor, cut.moe.top_k,
                cut.moe.num_experts) == (1.25, 2, 8)
    if cut.frontend_embeds:
        assert (B, S) == (chip_smoke.LLAVA_TRAIN_B, chip_smoke.LLAVA_TRAIN_S)
        assert chip_smoke.text_len(cut, S) == 1216
    want = chip_smoke.step_launches(cut)
    row = chip_smoke.dryrun_train("cpu", {
        "step_ms_median_last6": 1.0, "peak_mem_bytes": 1 << 40,
        "launches_per_step": want}, cut, B=B, S=S)
    assert row["predicted_launches_per_step"] == {
        "flash_attention": 2 * layers,
        "flash_attention_backward": 3 * layers}
    assert row["predicted_launches_per_step"] == {
        k: v for k, v in want.items() if v}
    assert row["predicted"]["peak_memory_bytes"] <= 72e9


# N1's dK/dV head splits on 132 SMs at the train shapes the card runs:
# (label, B, S, H, KV, dh, splits)
TRAIN_SPLITS = [("granite_train", 4, 512, 48, 1, 128, 5),
                ("granite_like", 1, 1024, 48, 1, 128, 9),
                ("phi4_train", 4, 512, 24, 8, 128, 1),
                ("stablelm_train", 4, 512, 32, 32, 80, 1),
                ("deepseek_train", 4, 512, 16, 16, 128, 1),
                ("gemma2_train", 2, 8192, 32, 16, 128, 1),
                ("mixtral_train", 4, 512, 32, 8, 128, 1),
                ("llava_train", 1, 4096, 32, 8, 128, 1),
                ("recurrentgemma_train", 4, 512, 10, 1, 256, 5)]


@pytest.mark.parametrize("label,B,S,H,KV,dh,want", TRAIN_SPLITS,
                         ids=[c[0] for c in TRAIN_SPLITS])
def test_bwd_head_splits_at_the_train_shapes(label, B, S, H, KV, dh, want):
    """``bwd_head_splits`` on the H100's 132 SMs: above 1 where MQA
    leaves the dK/dV grid short of the card (granite-20b's train shape
    and the granite-like row), enough for one CTA an SM; 1 where the key
    tiles alone fill it (the dK/dV kernel then writes dK and dV
    itself); recurrentgemma's dh 256 keeps its 5.  Each named
    arch's own heads are the case's."""
    from repro_torch.kernels import flash_attention as fa
    n = fa.bwd_head_splits(B, S, KV, H, dh, 132)
    assert n == want
    tiles = -(-S // fa.BK) * KV * B
    assert (tiles >= 132) == (n == 1)
    if n > 1:
        assert tiles * n >= 132 > tiles * (n - 1)
    arch = {"granite": "granite-20b", "phi4": "phi4-mini-3.8b",
            "stablelm": "stablelm-3b", "deepseek": "deepseek-moe-16b",
            "gemma2": "gemma2-27b", "mixtral": "mixtral-8x7b",
            "llava": "llava-next-mistral-7b",
            "recurrentgemma": "recurrentgemma-2b"}[label.split("_")[0]]
    cfg = get_config(arch)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == (H, KV, dh)


def test_adamw_on_the_tied_embedding_sets_the_gemma2_cut_peak():
    """``tools/train_peak.py`` at gemma2_train's cut and step: the peak
    of live storages is reached inside AdamW's update (at the root of
    v / c2) with six embedding-sized float32 storages alive (its
    gradient, the new m and v, m / c1, v / c2, the root): all gradients
    plus those five temporaries, whatever B x S is."""
    import sys
    from pathlib import Path

    import chip_smoke
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import train_peak
    cfg = chip_smoke.gemma2_train_config()
    table = 4 * cfg.vocab_size * cfg.d_model
    for B, S in ((chip_smoke.GEMMA2_TRAIN_B, chip_smoke.GEMMA2_TRAIN_S),
                 (4, 512)):
        n, peak, op, sizes, stack = train_peak.peak_op(cfg, B, S)
        assert op == "aten.sqrt.default"
        assert any("optim/optimizers.py" in line for line in stack)
        assert sizes[:6] == [table] * 6 and sizes[6] < table
        assert 0 <= peak - (4 * n + 5 * table) < 1e6     # + scalars


# ---------------------------------------------------------------------------
# run_one and the depth probes
# ---------------------------------------------------------------------------
REF_RECORD_KEYS = {f.name for f in dataclasses.fields(
    ref_analysis.Roofline)} | {"param_count", "num_devices",
                               "compile_seconds", "skipped"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_one_per_family(arch, tmp_path, traces):
    """Every shape on both meshes: no error, the reference's keys, the
    skips as SKIPS says, records on disk; per-device numbers halve from
    256 to 512 devices (a trace does not depend on the mesh)."""
    assert dryrun.SKIPS == ref_dryrun.SKIPS
    for name in configs.INPUT_SHAPES:
        recs = [dryrun.run_one(arch, name, mp, str(tmp_path), quiet=True,
                               traces=traces) for mp in (False, True)]
        for rec in recs:
            path = tmp_path / (f"dryrun_{arch}_{name}_{rec['mesh']}.json")
            assert json.loads(path.read_text())["mesh"] == rec["mesh"]
        if (arch, name) in dryrun.SKIPS:
            assert all(r["skipped"] == dryrun.SKIPS[(arch, name)]
                       and "error" not in r for r in recs)
            continue
        one, two = recs
        for rec in recs:
            assert "error" not in rec, rec.get("traceback")
            assert REF_RECORD_KEYS <= set(rec)
            assert rec["dominant"] in ("compute", "memory", "collective")
            assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
            assert 0 < rec["peak_memory_bytes"]
        assert one["flops_per_device"] == 2 * two["flops_per_device"]
        assert one["bytes_per_device"] == 2 * two["bytes_per_device"]
        assert (one["num_devices"], two["num_devices"]) == (256, 512)


DEPTH_CASES = [("phi4-mini-3.8b", "train_4k"), ("mixtral-8x7b", "train_4k"),
               ("rwkv6-7b", "prefill_32k"), ("whisper-tiny", "train_4k")]


@pytest.mark.parametrize("arch,shape", DEPTH_CASES,
                         ids=[f"{a}-{s}" for a, s in DEPTH_CASES])
def test_counters_affine_in_depth(arch, shape, traces):
    """At 3 periods every counter equals p1 + 2 (p2 - p1), exactly:
    FLOPs, bytes, each kernel's calls, FLOPs and bytes, and the
    collectives priced on the production mesh."""
    cfg = dryrun.resolve_cfg(arch, shape)[0]
    mesh = make_production_mesh()
    low = [dryrun.lower_combo(arch, shape, mesh, cfg=dryrun.probe_cfg(cfg, n),
                              traces=traces)[0] for n in (1, 2, 3)]

    def affine(a, b, c):
        assert c == a + 2 * (b - a)

    tr = [lo.trace for lo in low]
    affine(*(t.flops for t in tr))
    affine(*(t.bytes for t in tr))
    assert set(tr[0].kernels) == set(tr[2].kernels) != set()
    for name in tr[0].kernels:
        for k in ("calls", "flops", "bytes"):
            affine(*(t.kernels[name][k] for t in tr))
    colls = [analysis.collective_bytes(lo) for lo in low]
    for k in colls[0]:
        affine(*(c[k] for c in colls))
