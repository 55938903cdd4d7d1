"""The LM training path on the card: the flash-attention backward kernel
against its plain version, the forward's row log-sum-exp, launch counts
of a train step, and the recurrent archs' refusal to train.

Run on a GPU host with
``python -m pytest -q -m cuda tests/test_torch_cuda_lm.py``; elsewhere
every test skips (the decision is made in a fixture, at run time).
Tolerances: gradients within 2e-2 of the largest |gradient| in bfloat16
and 2e-5 in float32 of ``ref.attention_backward_plain`` on the same
inputs (the forward's tolerances), identical run to run; the LSE within
1e-5 (float32) and 1e-2 (bfloat16, where P is rounded inside the
kernel but not in the plain version).
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


def test_recurrence_kernels_raise_under_grad(cuda):
    from repro_torch.kernels import ops
    x = torch.randn(1, 8, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="N2"):
        ops.rglru(x, -torch.rand(1, 8, 32, device=cuda))
    r, k, v, w = (torch.randn(1, 8, 2, 64, device=cuda) for _ in range(4))
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="N2"):
        ops.wkv(r, k, v, torch.sigmoid(w), torch.randn(2, 64, device=cuda))
    with torch.no_grad():               # serving is unaffected
        ops.rglru(x, -torch.rand(1, 8, 32, device=cuda))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_cuda_lm_learner_on_recurrent_arch_raises_in_fit(cuda, arch):
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.learners import LMLearner
    from repro_torch.data import synthetic
    from repro_torch.models import Model
    learner = LMLearner(Model(get_smoke(arch)),
                        TrainConfig(batch_size=2, steps=1), device="cuda")
    seqs = synthetic.tokens(n_seqs=8, seq_len=17, vocab=512)["train"]
    with pytest.raises(NotImplementedError, match="no backward"):
        learner.fit(None, seqs)
