"""The LM training path on the card: the flash-attention backward kernel
(N1, dh 80 and 256 included, and at gemma2-27b's train shape) against
its plain version, the forward's row log-sum-exp, launch counts of a
train step, the recurrences' backward kernels (N2a, N2b) against
theirs, the recurrent smokes fitting on the card, and deepseek-moe's
smoke train step (picks dropping) repeated bit for bit.

Run on a GPU host with
``python -m pytest -q -m cuda tests/test_torch_cuda_lm.py``; elsewhere
every test skips (the decision is made in a fixture, at run time).
Tolerances: gradients within 2e-2 of the largest |gradient| in bfloat16
and 2e-5 in float32 of ``ref.attention_backward_plain`` on the same
inputs (the forward's tolerances), identical run to run; the LSE within
1e-5 (float32) and 1e-2 (bfloat16, where P is rounded inside the
kernel but not in the plain version).  N2a equals
``ref.rglru_scan_backward_plain`` bit for bit; N2b is within 2e-2
(bfloat16) or 1e-5 (float32) of each output's largest |gradient| of
``ref.wkv6_backward_plain``.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, B, S, H, KV, dh, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((B, S, n, dh), generator=g, device=cuda).to(dtype)
            for n in (H, KV, KV, H)]


# (B, S, H, KV, window, softcap): MHA, GQA, MQA, windows and caps,
# ragged S; a granite-like 48:1 group (one kv head's CTAs walk 48 q
# heads); a window whose edge cuts a key tile, uncapped
SHAPES = [(2, 128, 4, 4, 0, 0.0), (2, 200, 6, 2, 0, 0.0),
          (1, 130, 4, 1, 64, 0.0), (2, 150, 4, 2, 0, 50.0),
          (1, 257, 8, 2, 100, 30.0), (1, 256, 48, 1, 0, 0.0),
          (2, 320, 8, 4, 90, 0.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("B,S,H,KV,window,softcap", SHAPES)
def test_backward_kernel_matches_plain(cuda, dtype, dh, B, S, H, KV, window,
                                       softcap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _qkv(cuda, B, S, H, KV, dh, dtype, seed=dh + S)
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_forward_lse_matches_plain(cuda, dtype, dh):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, _ = _qkv(cuda, 2, 190, 4, 2, dh, dtype)
    for kw in (dict(), dict(window=50, softcap=30.0)):
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        o2 = fa.flash_attention(q, k, v, **kw)
        _, want = ref.attention_plain(q, k, v, return_lse=True, **kw)
        assert torch.equal(o, o2)      # the LSE changes nothing else
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        assert float((lse - want).abs().max()) <= tol


@pytest.mark.parametrize("window", [4096, 0], ids=["local", "global"])
def test_gemma2_train_shape_matches_plain(cuda, window):
    """One batch row of chip_smoke's gemma2_train step, (1, 8192, 32:16,
    dh 128, bf16, soft-cap 50), at a local layer (the 4096-key window
    binds) and a global one: K3's output within 2e-2 of
    ``ref.attention_ref`` and its LSE within 1e-2 of
    ``ref.attention_plain``'s; N1's gradients within 2e-2 of the largest
    |gradient| of ``ref.attention_backward_plain``, identical run to
    run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _qkv(cuda, 1, 8192, 32, 16, 128, torch.bfloat16, seed=29)
    kw = dict(causal=True, window=window, softcap=50.0)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want_o = ref.attention_ref(q, k, v, **kw)
    assert torch.allclose(o.float(), want_o.float(), atol=2e-2, rtol=2e-2)
    del want_o
    want_lse = ref.attention_plain(q, k, v, return_lse=True, **kw)[1]
    assert float((lse - want_lse).abs().max()) <= 1e-2
    del want_lse
    got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_backward_runs_the_dtypes_kernels(cuda, dtype, dh):
    """bfloat16 runs the TMA + wgmma kernels (bwd_dkdv_wgmma,
    bwd_dq_wgmma), float32 the FMA kernels (bwd_dkdv, bwd_dq), at the
    call's head dim, as the profiler sees them; both after bwd_dot."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _qkv(cuda, 2, 128, 4, 2, dh, dtype)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    fa.flash_attention_backward(q, k, v, o, do, lse)   # builds, warms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_backward(q, k, v, o, do, lse)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "bwd_" in e.key]
    wgmma = dtype == torch.bfloat16
    assert any("bwd_dot" in n for n in names), names
    for kernel in ("bwd_dkdv", "bwd_dq"):
        runs = [n for n in names if kernel in n]
        assert runs and all(("wgmma" in n) == wgmma and f"<{dh}" in n
                            for n in runs), names


def test_autograd_runs_both_kernels_and_matches_plain(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v, do = _qkv(cuda, 2, 96, 4, 2, 64, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.launches, fa.bwd_launches)
    o = ops.attention(*leaves, causal=True, window=40, softcap=20.0)
    got = torch.autograd.grad(o, leaves, do)
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == \
        (1, fa.BWD_KERNELS)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_plain(
        *plain, causal=True, window=40, softcap=20.0), plain, do)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 2e-5 * float(w.abs().max())


def test_training_rows_always_see_a_key(cuda):
    """Rows that see no key (dQ 0 by definition) are unreachable in
    training: at q_offset 0 with Sq = Skv every row sees its own key,
    so every LSE the forward writes for a training call is finite."""
    from repro_torch.kernels import flash_attention as fa
    for window, S in ((0, 70), (1, 70), (64, 300)):
        q, k, v, _ = _qkv(cuda, 1, S, 2, 1, 32, torch.bfloat16)
        _, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
        assert torch.isfinite(lse).all()


def test_train_step_launch_counts(cuda):
    """One phi4-smoke train step with remat: the forward kernel twice a
    layer (the forward and its recompute), the backward's kernels once a
    layer, and no recurrence kernel."""
    from repro_torch import prng
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.distill import make_train_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import Model
    cfg = get_smoke("phi4-mini-3.8b")
    model = Model(cfg)
    step, opt = make_train_step(model, TrainConfig(batch_size=2, steps=2))
    params = model.init_tree(prng.PRNGKey(0), cuda)
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step(params, state, batch)                         # builds, warms
    before = (fa.launches, fa.bwd_launches, rg.launches, wk.launches)
    _, _, m = step(params, state, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches - before[0], fa.bwd_launches - before[1],
            rg.launches - before[2], wk.launches - before[3]) == \
        (2 * L, fa.BWD_KERNELS * L, 0, 0)
    assert np.isfinite(float(m["loss"]))


# (B, S, D, nonzero h0 and dh_last): recurrentgemma's width, a ragged S,
# a D that is not a multiple of 32; recurrentgemma-2b's train shape, S
# 1024, a ragged S 1000 and the float32 row of chip_smoke (2, 1000,
# 512); a D whose rows are not a multiple of 16 bytes (the per-element
# path)
RGLRU_SHAPES = [(2, 128, 2560, True), (2, 1000, 256, True),
                (3, 33, 40, False), (1, 1, 64, True),
                (4, 512, 2560, True), (4, 1024, 2560, True),
                (4, 1000, 2560, True), (2, 1000, 512, True),
                (2, 130, 33, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,D,nonzero", RGLRU_SHAPES)
def test_rglru_backward_kernel_equals_plain(cuda, dtype, B, S, D, nonzero):
    """N2a from K4's checkpoints equals ``ref.rglru_scan_backward_plain``
    bit for bit (dx, dlog_a, dh0), identical run to run; and through
    ``ops.rglru`` under grad (K4, then N2a) the gradients are the plain
    ones too."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=cuda).manual_seed(S + D)
    x, dh = (torch.randn((B, S, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    la = (-torch.rand((B, S, D), generator=g, device=cuda) * 2).to(dtype)
    h0, dl = ((torch.randn((B, D), generator=g, device=cuda), torch.randn(
        (B, D), generator=g, device=cuda)) if nonzero
        else (torch.zeros((B, D), device=cuda), None))
    _, _, ck = rg.rglru_scan(x, la, h0, checkpoints=True)
    got = rg.rglru_scan_backward(x, la, ck, dh, dl)
    again = rg.rglru_scan_backward(x, la, ck, dh, dl)
    want = ref.rglru_scan_backward_plain(x, la, h0, dh, dl)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == w.dtype and torch.equal(a, b) and torch.equal(a, w)
    if S > 1:
        leaves = [t.clone().requires_grad_(True) for t in (x, la)]
        before = (rg.launches, rg.bwd_launches)
        h, hl = ops.rglru(*leaves, h0)
        outs, grads = ((h,), (dh,)) if dl is None else ((h, hl), (dh, dl))
        comp = torch.autograd.grad(outs, leaves, grads)
        assert (rg.launches - before[0], rg.bwd_launches - before[1]) == \
            (1, 1)
        for a, w in zip(comp, want):
            assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,D", [(2, 200, 2560), (2, 130, 33),
                                   (1, 64, 32)])
def test_rglru_checkpoints_are_the_carries(cuda, dtype, B, S, D):
    """K4 asked for checkpoints writes the float32 carry before each
    chunk of ``CHECKPOINT_STEPS`` steps, bit for bit the plain carry,
    and leaves h and h_last as they are without them; N2a refuses
    checkpoints of another shape."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=cuda).manual_seed(S)
    x, dh = (torch.randn((B, S, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    la = (-torch.rand((B, S, D), generator=g, device=cuda)).to(dtype)
    h0 = torch.randn((B, D), generator=g, device=cuda)
    h, hl, ck = rg.rglru_scan(x, la, h0, checkpoints=True)
    h2, hl2 = rg.rglru_scan(x, la, h0)
    CH = rg.CHECKPOINT_STEPS[dtype]
    assert ck.shape == rg.checkpoint_shape(B, S, D, dtype) == \
        (B, -(-S // CH), D)
    carry, want = h0.clone(), []
    for t in range(S):
        if t % CH == 0:
            want.append(carry)
        carry = torch.exp(la[:, t].float()) * carry + x[:, t].float()
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(hl, hl2)
    assert torch.equal(ck, torch.stack(want, 1))
    with pytest.raises(ValueError, match="ckpt"):
        rg.rglru_scan_backward(x, la, ck[:, :-1].contiguous()
                               if ck.shape[1] > 1 else ck[:1, :, :1], dh)


# (B, S, H, nonzero s0 and ds_last): rwkv6's 64 heads and its train
# shape; S a multiple of the backward's chunk of 16 (16, 128), not one
# (200, 37, 33), shorter than a chunk (9) and a single step
WKV_SHAPES = [(2, 128, 64, True), (1, 200, 8, False), (2, 37, 4, True),
              (1, 9, 2, False), (4, 512, 64, False), (1, 16, 2, True),
              (1, 33, 1, False), (2, 1, 3, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,nonzero", WKV_SHAPES)
def test_wkv6_backward_kernel_matches_plain(cuda, dtype, B, S, H, nonzero):
    """N2b within 2e-2 (bf16) or 1e-5 (float32) of each output's largest
    |gradient| from ``ref.wkv6_backward_plain`` (dr, dk, dv, dw, du,
    ds0: the same float32 recurrence summed in another order; bf16
    gradients rounded once), identical run to run; and through
    ``ops.wkv`` under grad (K5, then N2b) within the same bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    g = torch.Generator(device=cuda).manual_seed(S + H)
    dh = 64
    r, k, v, do = (torch.randn((B, S, H, dh), generator=g, device=cuda)
                   .mul(0.5).to(dtype) for _ in range(4))
    w = torch.rand((B, S, H, dh), generator=g, device=cuda).mul(0.9).add(
        0.05).to(dtype)
    u = torch.randn((H, dh), generator=g, device=cuda) * 0.3
    s0 = (torch.randn((B, H, dh, dh), generator=g, device=cuda) * 0.2
          if nonzero else torch.zeros((B, H, dh, dh), device=cuda))
    dsl = (torch.randn((B, H, dh, dh), generator=g, device=cuda)
           if nonzero else None)
    got = wk.wkv6_backward(r, k, v, w, u, s0, do, dsl)
    again = wk.wkv6_backward(r, k, v, w, u, s0, do, dsl)
    want = ref.wkv6_backward_plain(r, k, v, w, u, s0, do, dsl)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    before = (wk.launches, wk.bwd_launches)
    o, sl = ops.wkv(*leaves)
    outs, grads = ((o,), (do,)) if dsl is None else ((o, sl), (do, dsl))
    comp = torch.autograd.grad(outs, leaves, grads)
    torch.cuda.synchronize()
    # a single step is a decode step: ops.wkv takes the plain formula
    assert (wk.launches - before[0], wk.bwd_launches - before[1]) == \
        ((1, wk.BWD_KERNELS) if S > 1 else (0, 0))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b, c, w_ in zip(got, again, comp, want):
        assert a.dtype == w_.dtype and torch.equal(a, b)
        scale = float(w_.float().abs().max())
        assert float((a.float() - w_.float()).abs().max()) <= tol * scale
        assert float((c.float() - w_.float()).abs().max()) <= tol * scale


# dh 256: SHAPES, then recurrentgemma's train shape (4, 512, 10:1,
# window 2048: 5 head splits of 2), and groups the split count does not
# divide, at ragged S (bwd_head_splits on 132 SMs: 10:1 at S 1000 in 9
# splits, 12:2 at S 620 in 4, 20:2 at S 777 in 6, 48:1 at S 256 in 33,
# SHAPES' last but one)
SHAPES_256 = SHAPES + [(4, 512, 10, 1, 2048, 0.0), (1, 1000, 10, 1, 300,
                                                    0.0),
                       (2, 620, 12, 2, 0, 0.0), (1, 777, 20, 2, 0, 30.0)]


@pytest.mark.parametrize("B,S,H,KV,window,softcap", SHAPES_256)
def test_backward_kernel_at_dh256_matches_plain(cuda, B, S, H, KV, window,
                                                softcap):
    """N1 at recurrentgemma's head dim 256 in bfloat16 (two warpgroups a
    CTA sharing each tile's scores, one a half of the output columns; the
    group's q heads split over ``bwd_head_splits`` CTAs and their partial
    dK and dV added in split order), within 2e-2 of the largest
    |gradient| of
    ``ref.attention_backward_plain``, identical run to run, through
    windows, caps and MQA; float32 at 256 is refused."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _qkv(cuda, B, S, H, KV, 256, torch.bfloat16, seed=S + H)
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= 2e-2 * scale
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_backward(qf, kf, vf, of, dof, lse, **kw)


PROFILE_N1_AT_80 = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
g = torch.Generator(device="cuda").manual_seed(6)
q, k, v, do = (torch.randn((2, 256, 8, 80), generator=g, device="cuda")
               .bfloat16() for _ in range(4))
o, lse = fa.flash_attention(q, k, v, return_lse=True)
fa.flash_attention_backward(q, k, v, o, do, lse)    # builds, warms
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fa.flash_attention_backward(q, k, v, o, do, lse)
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}))
"""


def test_n1_at_head_dim_80_runs_only_its_kernels(cuda):
    """A bfloat16 dh-80 backward call is N1's three device kernels at
    dh 80 (D, then dK/dV, then dQ) and nothing else: no pad of q, k, v,
    o or dO and no slice of dq, dk or dv (profiled in a subprocess, as
    in test_torch_cuda_archs.py)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", PROFILE_N1_AT_80, str(src)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    assert sum(runs.values()) == 3, runs
    assert any("bwd_dot" in n for n in runs), runs
    assert any("bwd_dkdv_wgmma<80" in n for n in runs), runs
    assert any("bwd_dq_wgmma<80" in n for n in runs), runs


@pytest.mark.parametrize("B,S,window", [(4, 512, 0), (1, 300, 100)],
                         ids=["stablelm_train", "window"])
def test_n1_at_head_dim_80_native(cuda, B, S, window):
    """N1 at stablelm-3b's head dim 80 in bfloat16, launched at 80: at
    its train shape (4 x 512, MHA 32:32, causal) and at a ragged S under
    a window, within 2e-2 of the largest |gradient| of
    ``ref.attention_backward_plain``, identical run to run; also from
    the plain forward's own o and LSE."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    assert fa.padded_head_dim(80, fa.BWD_HEAD_DIMS) == 80
    H = 32 if B == 4 else 8
    q, k, v, do = _qkv(cuda, B, S, H, H, 80, torch.bfloat16, seed=S)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    n = fa.bwd_launches
    got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    assert fa.bwd_launches - n == fa.BWD_KERNELS
    again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    po, plse = ref.attention_plain(q, k, v, return_lse=True, **kw)
    whole = ref.attention_backward_plain(q, k, v, po, do, plse, **kw)
    for a, b, w, p in zip(got, again, want, whole):
        assert a.shape == w.shape == (q.shape if a.shape[2] == H else
                                      k.shape)
        assert torch.equal(a, b)
        for ref_grad in (w, p):
            scale = float(ref_grad.float().abs().max())
            assert float((a.float() - ref_grad.float()).abs().max()) <= \
                2e-2 * scale


# A backward kernel that is the first CUDA work of autograd's thread: the
# thread has no current context until a runtime call binds one, and the
# launchers' tensor-map encodes need it
FIRST_BACKWARD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
g = torch.Generator(device="cuda").manual_seed(0)
if sys.argv[2] == "rglru":
    x, dh = (torch.randn((2, 128, 256), generator=g, device="cuda")
             for _ in range(2))
    la = -torch.rand((2, 128, 256), generator=g, device="cuda")
    h0 = torch.zeros((2, 256), device="cuda")
    _, _, ck = rg.rglru_scan(x, la, h0, checkpoints=True)
    rg.rglru_scan_backward(x, la, ck, dh)        # builds, fills the cache
    leaves = [t.clone().requires_grad_(True) for t in (x, la)]
    h, _ = rg.RGLRUScan.apply(*leaves, h0)
    grads = torch.autograd.grad(h, leaves, dh)
else:
    q, k, v, do = (torch.randn((1, 128, 2, 64), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    fa.flash_attention_backward(q, k, v, o, do, lse)   # builds, fills
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves, True, 0, 0.0)
    grads = torch.autograd.grad(out, leaves, do)
torch.cuda.synchronize()
assert all(bool(torch.isfinite(t).all()) for t in grads)
print("ok")
"""


@pytest.mark.parametrize("kernel", ["rglru", "attention"])
def test_backward_kernel_first_on_autograd_thread(cuda, kernel):
    """N2a and N1 launch when their backward is the first CUDA work of a
    fresh process's autograd thread (each in a subprocess of its own)."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", FIRST_BACKWARD, str(src),
                          kernel], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_stablelm_train_step_launches(cuda):
    """One remat train step of a narrow stablelm at head dim 80 (2
    layers, d_model 320, 4 heads) on the card launches K3 twice a layer
    and N1 once (its three kernels), as ``chip_smoke.train_launches``
    counts stablelm-3b's, with no recurrence kernel; the loss finite."""
    import chip_smoke
    from repro_torch import prng
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.distill import make_train_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import Model
    cfg = get_smoke("stablelm-3b").replace(d_model=320, num_heads=4,
                                           num_kv_heads=4, d_ff=640)
    assert cfg.d_model // cfg.num_heads == 80
    model = Model(cfg)
    step, opt = make_train_step(model, TrainConfig(batch_size=2, steps=2))
    params = model.init_tree(prng.PRNGKey(0), cuda)
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step(params, state, batch)                         # builds, warms
    before = (fa.launches, fa.bwd_launches, rg.launches, rg.bwd_launches,
              wk.launches, wk.bwd_launches)
    _, _, m = step(params, state, batch)
    torch.cuda.synchronize()
    want = chip_smoke.train_launches(cfg)
    got = tuple(a - b for a, b in zip(
        (fa.launches, fa.bwd_launches, rg.launches, rg.bwd_launches,
         wk.launches, wk.bwd_launches), before))
    assert got == tuple(want[k] for k in (
        "flash_attention", "flash_attention_backward", "rglru_scan",
        "rglru_scan_backward", "wkv6", "wkv6_backward"))
    assert got[:2] == (2 * cfg.num_layers, fa.BWD_KERNELS * cfg.num_layers)
    assert np.isfinite(float(m["loss"]))


def test_moe_train_step_repeats_bit_for_bit(cuda):
    """deepseek-moe's smoke layout (its dense head block, then two MoE
    blocks; bf16 compute on float32 masters) at deepseek-moe-16b's
    capacity factor 1.25, so that picks drop: one remat train step's
    loss and gradients taken twice from one init on one batch
    (``chip_smoke.train_step_repeat``, as chip_smoke's deepseek_train
    takes them at full width) are equal bit for bit, as are two whole
    ``make_train_step`` steps (AdamW) from that init; each launches K3
    and N1 as ``chip_smoke.train_launches`` counts."""
    import dataclasses

    import chip_smoke
    from repro_torch import prng
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.distill import make_train_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.tree_util import flatten_tree, tree_map
    cfg = get_smoke("deepseek-moe-16b")
    cfg = cfg.replace(num_layers=3, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    model = Model(cfg)
    init = model.init_tree(prng.PRNGKey(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    # 16 distinct ids: repeated tokens crowd the same experts
    toks = torch.randint(0, 16, (4, 129), device=cuda, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = (fa.launches, fa.bwd_launches)
    with chip_smoke.DropCount() as drops:
        rep = chip_smoke.train_step_repeat(model, init, batch)
    torch.cuda.synchronize()
    assert rep["identical"] and rep["finite"], rep
    assert drops.share > 0.0
    want = chip_smoke.train_launches(cfg)
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == (
        2 * want["flash_attention"], 2 * want["flash_attention_backward"])
    step, opt = make_train_step(model, TrainConfig(batch_size=4, steps=2))
    runs = []
    for _ in range(2):
        p = tree_map(torch.clone, init)
        p, _, m = step(p, opt.init(p), batch)
        runs.append((m, flatten_tree(p)))
    (m1, p1), (m2, p2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(torch.as_tensor(m1["grad_norm"]),
                       torch.as_tensor(m2["grad_norm"]))
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_cuda_lm_learner_fits_recurrent_arch(cuda, arch):
    """A recurrent smoke fits on the card through ``LMLearner.fit``: its
    RG-LRU / RWKV layers run K4 / K5 and their backward kernels (N2a,
    N2b) each step, as ``chip_smoke.train_launches`` counts them, and
    the loss stays finite."""
    import chip_smoke
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.learners import LMLearner
    from repro_torch.data import synthetic
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import Model
    from repro_torch.tree_util import tree_leaves
    cfg = get_smoke(arch)
    steps = 2
    learner = LMLearner(Model(cfg), TrainConfig(batch_size=2, steps=steps),
                        device="cuda")
    seqs = synthetic.tokens(n_seqs=8, seq_len=17, vocab=512)["train"]
    before = (rg.launches, rg.bwd_launches, wk.launches, wk.bwd_launches)
    state = learner.fit(None, seqs)
    torch.cuda.synchronize()
    want = chip_smoke.train_launches(cfg)
    got = (rg.launches - before[0], rg.bwd_launches - before[1],
           wk.launches - before[2], wk.bwd_launches - before[3])
    assert got == tuple(steps * want[k] for k in (
        "rglru_scan", "rglru_scan_backward", "wkv6", "wkv6_backward"))
    assert max(got[1], got[3]) > 0
    assert all(torch.isfinite(t).all() for t in tree_leaves(state))
