"""The MoE slice's archs on the card: flash attention (K3) at
stablelm's head dim 80 (launched at 80: one device kernel a call) and
its backward (N1, at 80 in both dtypes), the two joined by
``FlashAttention``, K3 at granite's MQA group (48 q heads on one kv
head), the MoE layer run to run, and each new smoke's logits against
the CPU's.

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
    assert fa.padded_head_dim(80) == 80     # launched at 80, not padded
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
    # the row LSE, the backward's input
    _, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.attention_plain(q, k, v, return_lse=True, **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((lse - want_lse).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv", [(2, 65), (64, 100), (100, 65),
                                    (100, 100)])
def test_k3_at_head_dim_80_non_causal_ragged_keys(cuda, dtype, Sq, Skv):
    """K3 at dh 80 with no mask over ragged key tiles (65, 100), as
    whisper's cross attention is held: within the tolerance of
    ``ref.attention_ref``, identical run to run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q = torch.randn((2, Sq, 8, 80), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, Skv, 4, 80), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    assert got.shape == q.shape and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


# One bfloat16 dh-80 forward call under torch.profiler, in a process of
# its own: with this session in the pytest process, the profiler test of
# tests/test_torch_cuda_lm.py, run later there, saw only one of its
# three kernels.  Prints {kernel name: calls}.
PROFILE_ONE_CALL = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
g = torch.Generator(device="cuda").manual_seed(5)
q, k, v = (torch.randn((2, 256, n, 80), generator=g, device="cuda")
           .bfloat16() for n in (8, 4, 4))
fa.flash_attention(q, k, v)                     # builds, warms
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
print(json.dumps({e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}))
"""


def test_k3_at_head_dim_80_runs_one_device_kernel(cuda):
    """A bfloat16 dh-80 forward call is one device kernel, the dh-80
    wgmma kernel: no pad of q, k, v and no slice of the output."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", PROFILE_ONE_CALL, str(src)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    assert sum(runs.values()) == 1, runs
    (name,) = runs
    assert "flash_attention_wgmma<80>" in name, runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 30.0)])
def test_flash_attention_autograd_at_head_dim_80(cuda, dtype, window,
                                                 softcap):
    """``FlashAttention`` at dh 80, a native forward joined to N1 (native
    in both dtypes): the output against the plain
    forward, dq, dk and dv against
    ``ref.attention_backward_plain`` from the plain forward's own o and
    LSE within N1's tolerance of the largest |gradient|, one forward
    and one backward call, identical run to run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _qkv(cuda, 2, 160, 8, 4, 80, dtype, seed=9)
    kw = dict(causal=True, window=window, softcap=softcap)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.FlashAttention.apply(*leaves, True, window, softcap)
        return o.detach(), torch.autograd.grad(o, leaves, do)
    n = (fa.launches, fa.bwd_launches)
    o, got = run()
    assert (fa.launches - n[0], fa.bwd_launches - n[1]) == \
        (1, fa.BWD_KERNELS)
    o2, again = run()
    want_o, want_lse = ref.attention_plain(q, k, v, return_lse=True, **kw)
    want = ref.attention_backward_plain(q, k, v, want_o, do, want_lse, **kw)
    assert torch.equal(o, o2)
    torch.testing.assert_close(o.float(), want_o.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= \
            _tol(dtype) * scale


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
