"""The MoE slice's archs on the card: flash attention (K3) and its
backward (N1) at stablelm's head dim 80 (padded to 128 on the head
axis) and at granite's MQA group (48 q heads on one kv head), the MoE
layer run to run, and each new smoke's logits against the CPU's.

Run on a GPU host with
``python -m pytest -q -m cuda tests/test_torch_cuda_archs.py``;
elsewhere every test skips (the decision is made in a fixture, at run
time).  Tolerances: K3 within 2e-5 (float32) and 2e-2 (bfloat16) of
``ref.attention_plain`` (``tests/test_torch_cuda.py``'s), N1 within the
same share of the largest |gradient| of ``ref.attention_backward_plain``
(``tests/test_torch_cuda_lm.py``'s), both identical run to run; the
smokes' float32 logits within 1e-4 of the CPU's largest |logit|
(cuBLAS and the CPU sum in other orders).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ARCHS = ["mixtral-8x7b", "deepseek-moe-16b", "stablelm-3b", "granite-20b",
         "llava-next-mistral-7b"]


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


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,window,softcap",
                         [(2, 200, 8, 8, 0, 0.0), (1, 333, 4, 2, 100, 0.0),
                          (2, 130, 4, 1, 0, 30.0)])
def test_k3_at_head_dim_80_matches_plain(cuda, dtype, B, S, H, KV, window,
                                         softcap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    assert fa.padded_head_dim(80) == 128
    q, k, v, _ = _qkv(cuda, B, S, H, KV, 80, dtype, seed=S)
    kw = dict(causal=True, window=window, softcap=softcap)
    n = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n + 2             # one launch a call
    want = ref.attention_plain(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == dtype
    assert got.is_contiguous() and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    # the row LSE of the padded launch is the true dim's
    _, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.attention_plain(q, k, v, return_lse=True, **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((lse - want_lse).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 30.0)])
def test_n1_at_head_dim_80_matches_plain(cuda, dtype, window, softcap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _qkv(cuda, 2, 160, 8, 4, 80, dtype, seed=7)
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= \
            _tol(dtype) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_at_granite_mqa_group(cuda, dtype):
    """48 q heads on one kv head (granite-20b), dh 128."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, _ = _qkv(cuda, 2, 384, 48, 1, 128, dtype, seed=3)
    got = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    want = ref.attention_plain(q, k, v, causal=True)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full_width"])
def test_moe_apply_is_identical_run_to_run(cuda, full):
    """The gather-based combine adds in a fixed order: two runs of one
    input give the same bits (at deepseek's smoke in float32 and one
    full-width deepseek MoE layer in bfloat16, 1024 tokens)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import moe as M
    cfg = get_config("deepseek-moe-16b") if full else \
        get_smoke("deepseek-moe-16b").replace(dtype="float32",
                                              param_dtype="float32")
    p = M.MoE(cfg, cuda, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 512, cfg.d_model), generator=g, device=cuda)
    x = x.to(getattr(torch, cfg.dtype))
    with torch.inference_mode():
        y1, a1 = M.moe_apply(cfg, p, x)
        y2, a2 = M.moe_apply(cfg, p, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert bool(torch.isfinite(y1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_on_the_card_match_the_cpu(cuda, arch):
    """Each new smoke in float32, one set of weights on both devices:
    prefill logits (llava with its stub embeddings) within 1e-4 of the
    CPU's largest |logit|; the card's prefill launches K3 once a
    layer."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    cfg = get_smoke(arch).replace(dtype="float32", param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    cpu = model.init(device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in params.state_dict().items()})
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))}
    if cfg.frontend_embeds:
        batch["embeds"] = torch.from_numpy(rng.normal(
            0, 1, (2, cfg.frontend_embeds, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        want, _ = model.logits(cpu, batch, mode="prefill")
        n = fa.launches
        got, _ = model.logits(params, {k: t.to(cuda)
                                       for k, t in batch.items()},
                              mode="prefill")
        assert fa.launches - n == cfg.num_layers
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
