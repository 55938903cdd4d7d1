"""The encoder-decoder slice on the card: K3 (flash attention) held
non-causal over ragged keys and Sq != Skv, N1 (its backward) over the
encoder's Sq = Skv and cross attention's Sq != Skv (N1b), the gradient
policy of ``ops.attention``, and whisper's smoke on the card against
the CPU.

Run on a GPU host with
``python -m pytest -q -m cuda tests/test_torch_cuda_encdec.py``;
elsewhere every test skips (the decision is made in a fixture, at run
time).  Tolerances: K3 within 2e-2 (bfloat16) and 2e-5 (float32) of
``ref.attention_ref``; N1 within 2e-2 / 2e-5 of the largest |gradient|
of ``ref.attention_backward_plain``; both identical run to run.  The
smoke in float32 card against CPU: logits within 1e-4 of the largest,
one train step's loss within 1e-4 relative and its gradients within
1e-4 of each leaf's largest.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tensors(cuda, B, Sq, Skv, H, KV, dh, dtype, seed=0):
    """q, k, v, dO: q and dO (B, Sq, H, dh), k and v (B, Skv, KV, dh)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((B, S, n, dh), generator=g, device=cuda).to(dtype)
            for S, n in ((Sq, H), (Skv, KV), (Skv, KV), (Sq, H))]


# (Sq, Skv): ragged key tiles (65, 100, 1500 = 23 x 64 + 28), Sq below,
# at and above one 64-row tile, Sq != Skv and the encoder's Sq = Skv
CROSS = [(2, 65), (64, 100), (100, 65), (2, 1500), (64, 1500), (100, 1500),
         (1500, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("Sq,Skv", CROSS)
def test_forward_non_causal_matches_plain(cuda, dtype, dh, Sq, Skv):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, _ = _tensors(cuda, 2, Sq, Skv, 6, 6 if dh == 64 else 2, dh,
                          dtype, seed=Sq + Skv + dh)
    got = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, again)
    tol = TOL[dtype]
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
        float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh", [(1, 1500, 1500, 6, 6, 64),
                                              (2, 100, 1500, 6, 6, 64),
                                              (2, 64, 65, 4, 2, 32),
                                              (2, 130, 70, 4, 1, 32)])
def test_backward_non_causal_matches_plain(cuda, dtype, B, Sq, Skv, H, KV,
                                           dh):
    """N1 at the encoder's Sq = Skv = 1500 and N1b at Sq != Skv."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, do = _tensors(cuda, B, Sq, Skv, H, KV, dh, dtype, seed=Sq)
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, causal=False)
    again = fa.flash_attention_backward(q, k, v, o, do, lse, causal=False)
    want = ref.attention_backward_plain(q, k, v, o, do, lse, causal=False)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and a.dtype == dtype and torch.equal(a, b)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= \
            TOL[dtype] * scale


def test_grad_policy_of_ops_attention(cuda):
    """Under grad, a non-causal Sq != Skv call runs K3 and N1b and
    matches autograd of the plain version; a causal Sq != Skv call
    still raises (its offset would need a meaning the reference never
    gives it), and so does the wrapper's backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v, do = _tensors(cuda, 2, 40, 150, 4, 2, 32, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.launches, fa.bwd_launches)
    o = ops.attention(*leaves, causal=False)
    got = torch.autograd.grad(o, leaves, do)
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == \
        (1, fa.BWD_KERNELS)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_plain(*plain, causal=False),
                               plain, do)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 2e-5 * float(w.abs().max())
    with pytest.raises(NotImplementedError, match="causal=False"):
        ops.attention(*leaves, causal=True)
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    with pytest.raises(ValueError, match="causal call needs"):
        fa.flash_attention_backward(q, k, v, o, do, lse, causal=True)


def _smoke():
    from repro_torch.configs import get_smoke
    return get_smoke("whisper-tiny").replace(
        dtype="float32", param_dtype="float32", encoder_seq_len=100,
        frontend_embeds=100)


def test_whisper_smoke_card_matches_cpu(cuda):
    """The float32 smoke (100 frames) on the card against the CPU with
    the same weights: train-mode logits, then the prefill + decode
    path; the prefill launches K3 three times a decoder layer pair
    (encoder, self, cross), decode steps none."""
    from repro_torch import prng
    from repro_torch.core import distill
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.models.transformer import to_module
    cfg = _smoke()
    model = Model(cfg)
    tree = model.init_tree(prng.PRNGKey(0), "cpu")
    cpu, card = to_module(cfg, tree), to_module(cfg, tree, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    fr = torch.from_numpy(rng.normal(size=(2, 100, cfg.d_model))
                          .astype(np.float32))
    with torch.no_grad():
        want, _ = model.logits(cpu, {"tokens": toks, "frames": fr})
        got, _ = model.logits(card, {"tokens": toks.to(cuda),
                                     "frames": fr.to(cuda)})
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    prefill = distill.make_prefill_step(model)
    decode = distill.make_decode_step(model)
    before = fa.launches
    pl, pc = prefill(card, {"tokens": toks.to(cuda), "frames": fr.to(cuda)})
    assert fa.launches - before == cfg.num_encoder_layers + 2 * cfg.num_layers
    cl, cc = prefill(cpu, {"tokens": toks, "frames": fr})
    pc, cc = model.grow_cache(pc, 4), model.grow_cache(cc, 4)
    tok = torch.argmax(cl[:, -1], -1)[:, None]
    before = fa.launches
    for i in range(4):
        _, pc, plog = decode(card, tok.to(cuda), pc, 24 + i)
        tok, cc, clog = decode(cpu, tok, cc, 24 + i)
        assert float((plog.cpu() - clog).abs().max()) <= \
            1e-4 * float(clog.abs().max())
    assert fa.launches == before


def test_whisper_smoke_train_step_card_matches_cpu(cuda):
    """One AdamW step's loss and first-step gradients, card against CPU,
    with exact launches: K3 once an encoder layer and twice a decoder
    attention (the forward and remat's recompute), N1 once an encoder
    layer and once a decoder attention (self and cross, N1b)."""
    from repro_torch import device as D
    from repro_torch import prng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.tree_util import flatten_tree, tree_map
    cfg = _smoke()
    model = Model(cfg)
    init = model.init_tree(prng.PRNGKey(0), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (4, 33))
    fr = rng.normal(size=(4, 100, cfg.d_model)).astype(np.float32)

    def grads(dev):
        leaves = tree_map(lambda t: t.clone().to(dev).requires_grad_(True),
                          init)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev),
                 "frames": torch.from_numpy(fr).to(dev)}
        flat = flatten_tree(leaves)
        with D.full_float32(torch.device(dev)):
            loss = model.loss(leaves, batch)
            g = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), {n: x.cpu() for n, x in zip(flat, g)}

    before = (fa.launches, fa.bwd_launches)
    lc, gc = grads("cuda")
    torch.cuda.synchronize()
    E, L = cfg.num_encoder_layers, cfg.num_layers
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == \
        (E + 2 * 2 * L, fa.BWD_KERNELS * (E + 2 * L))
    lh, gh = grads("cpu")
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for n in gh:
        assert float((gc[n] - gh[n]).abs().max()) <= \
            1e-4 * float(gh[n].abs().max()) + 1e-12, n
