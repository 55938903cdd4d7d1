"""The CUDA kernels against their plain versions, on the card.

Run on a GPU host with ``python -m pytest -m cuda tests/test_torch_cuda.py``;
elsewhere every test here skips (the decision is made in a fixture, at
run time, so every worker collects the same tests).  Tolerances: the
vote kernel is bit-identical on all five outputs; the histogram kernel
is exact on integer weights, identical run to run on float weights and,
cell by cell, within what float32 summation of that cell's own terms
can explain: gamma(m - 1) * sum |w| of the exact sum for its m nonzero
terms (``ref.tree_hist_f32_error``); the flash-attention kernel is
within the reference's kernel-test tolerances of ``ref.attention_ref``
(2e-5 float32, 2e-2 bfloat16) and identical run to run.
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


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("M,T,U", [(5, 6105, 2), (3, 64, 10),
                                   (16, 257, 1024), (1, 9, 1)])
@pytest.mark.parametrize("noisy", [False, True])
def test_vote_kernel_bit_identical_to_plain(cuda, M, T, U, noisy):
    from repro_torch.kernels import ref
    from repro_torch.kernels import vote_aggregate as va
    g = torch.Generator(device=cuda).manual_seed(M + T + U)
    # few classes per query: many exact ties
    preds = torch.randint(0, min(U, 3), (M, T), device=cuda, generator=g,
                          dtype=torch.int32)
    noise = (torch.randn((T, U), device=cuda, generator=g)
             if noisy else None)
    before = va.launches
    got = va.vote_aggregate(preds, noise, num_classes=U)
    want = ref.vote_aggregate_plain(preds, U, noise)
    torch.cuda.synchronize()
    assert va.launches == before + 1
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


def _hist_inputs(cuda, G, Gf, N, F, B, K, n, integer, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xb = torch.randint(0, B, (Gf, N, F), device=cuda, generator=g,
                       dtype=torch.int32)
    node = torch.randint(0, n, (G, N), device=cuda, generator=g,
                         dtype=torch.int32)
    if integer:
        w = torch.randint(0, 4, (G, K, N), device=cuda,
                          generator=g).float()
    else:
        w = torch.rand((G, K, N), device=cuda, generator=g) * 2 - 1
    w[:, :, N - N // 4:] = 0.0
    return xb, node, w.contiguous()


@pytest.mark.parametrize("G,Gf,N,F,n,K", [(1, 1, 300, 14, 8, 2),
                                          (6, 2, 513, 5, 32, 2),
                                          (4, 4, 1000, 3, 1, 3),
                                          (3, 1, 70, 33, 16, 10)])
def test_tree_hist_kernel_against_plain(cuda, G, Gf, N, F, n, K):
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_hist as th
    B = 32
    xb, node, w = _hist_inputs(cuda, G, Gf, N, F, B, K, n, True, N + G)
    got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    assert torch.equal(got, ref.tree_hist_ref(xb, node, w, n, B))
    # padding rows (w == 0) add exact zeros whatever they hold
    xb2, node2 = xb.clone(), node.clone()
    xb2[:, N - N // 4:] = (xb2[:, N - N // 4:] + 7) % B
    node2[:, N - N // 4:] = (node2[:, N - N // 4:] + 1) % n
    assert torch.equal(got, th.tree_hist(xb2, node2, w, num_nodes=n,
                                         num_bins=B))
    # float weights: run-to-run identical, close to the plain version
    xb, node, w = _hist_inputs(cuda, G, Gf, N, F, B, K, n, False, N + 1)
    a = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    b = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    err, ratio = ref.tree_hist_f32_error(a, xb, node, w, n, B)
    assert ratio <= 1.0, (err, ratio)


def test_node_hist_kernel_against_plain(cuda):
    from repro_torch.kernels import ops, ref
    _, node, w = _hist_inputs(cuda, 5, 5, 777, 1, 64, 2, 64, True, 3)
    assert torch.equal(ops.node_hist(node, w, num_nodes=64),
                       ref.node_hist_ref(node, w, 64))


def test_wrappers_refuse_bad_inputs(cuda):
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    preds = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        va.vote_aggregate(preds, None, num_classes=2)
    xb = torch.zeros((1, 8, 2), dtype=torch.int32, device=cuda)
    node = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        th.tree_hist(xb, node, torch.zeros((2, 17, 8), device=cuda),
                     num_nodes=1, num_bins=4)
    with pytest.raises(ValueError):
        th.tree_hist(xb, node,
                     torch.zeros((2, 8, 2), device=cuda).transpose(1, 2),
                     num_nodes=1, num_bins=4)


ATT_SHAPES = [
    # B, Sq, Skv, H, KV, dh, q_offset
    (1, 128, 128, 4, 4, 64, 0),
    (2, 256, 256, 4, 2, 64, 0),      # GQA
    (2, 256, 256, 8, 1, 128, 0),     # MQA
    (1, 384, 384, 2, 2, 128, 0),
    (3, 77, 77, 8, 4, 32, 0),        # ragged edges on both axes
    (2, 1, 9, 4, 2, 64, 8),          # one query row
    (1, 100, 300, 4, 2, 128, 200),   # chunked prefill: q_offset
]


def _att_inputs(cuda, B, Sq, Skv, H, KV, dh, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, Sq, H, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, KV, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, KV, dh), generator=g, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("shape", ATT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (96, 0.0), (0, 30.0)])
def test_flash_attention_kernel_against_plain(cuda, shape, dtype, window,
                                              softcap):
    """The kernel against ``ref.attention_ref`` at the tolerances of the
    reference's own kernel test (2e-5 float32, 2e-2 bfloat16), and
    identical run to run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Sq, Skv, H, KV, dh, off = shape
    q, k, v = _att_inputs(cuda, B, Sq, Skv, H, KV, dh, dtype, Sq + dh)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window,
                             softcap=softcap, q_offset=off)
    again = fa.flash_attention(q, k, v, causal=True, window=window,
                               softcap=softcap, q_offset=off)
    want = ref.attention_ref(q, k, v, causal=True, window=window,
                             softcap=softcap, q_offset=off)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_attention_op_launches_only_for_prefill(cuda):
    """ops.attention: a prefill launches the kernel, a decode (one row,
    scalar or per-row offsets) takes the plain path, as the reference's
    ops.attention does."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v = _att_inputs(cuda, 2, 16, 16, 4, 2, 64, torch.float32, 1)
    before = fa.launches
    out = ops.attention(q, k, v, causal=True)
    assert fa.launches == before + 1
    torch.testing.assert_close(out, ref.attention_ref(q, k, v), atol=2e-5,
                               rtol=2e-5)
    pos = torch.tensor([3, 15], device=cuda)
    one = ops.attention(q[:, :1], k, v, causal=True, q_offset=pos)
    one_s = ops.attention(q[:, :1], k, v, causal=True, q_offset=15)
    assert fa.launches == before + 1
    torch.testing.assert_close(one[1], one_s[1])


def test_flash_attention_wrapper_refuses_bad_inputs(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _att_inputs(cuda, 1, 8, 8, 4, 2, 64, torch.float32, 2)
    with pytest.raises(TypeError):                 # dtype
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):                 # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v)
    qd, kd, vd = _att_inputs(cuda, 1, 8, 8, 4, 2, 48, torch.float32, 3)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(qd, kd, vd)
    with pytest.raises(ValueError, match="contiguous"):  # (B, H, S, dh)
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="split"):
        fa.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1).contiguous(),
                           v[:, :, :1].repeat(1, 1, 3, 1).contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    buf = torch.zeros(q.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(buf[1:].view(q.shape), k, v)


def test_engine_on_card_holds_to_serve_batch(cuda):
    """The gemma2 smoke in float32 on the card (window 64, prompts
    crossing it): every prefill layer launches the attention kernel,
    and every stream holds to its solo serve_batch run under the parity
    rule, with logits within 1e-4 of the largest."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.serving import Engine, compare_stream, serve_batch
    cfg = get_smoke("gemma2-27b").replace(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (30, 70, 100)]
    before = fa.launches
    eng = Engine(model, params, num_slots=2, cache_len=256,
                 keep_logits=True)
    res = eng.serve(prompts, max_tokens=6)
    assert fa.launches - before == cfg.num_layers * eng.dispatches["prefill"]
    for r, p in zip(res, prompts):
        toks, stats = serve_batch(model, params, p[None], 6, verbose=False,
                                  keep_logits=True)
        info = compare_stream(r.tokens, r.logits, toks[0].tolist(),
                              stats["logits"][0])
        assert info["explained"], info
        assert info["max_diff"] <= 1e-4 * stats["logits"].abs().max(), info


@pytest.mark.parametrize("kind", ["rf", "gbdt"])
def test_stacked_fit_equals_serial_fit_on_card(cuda, kind):
    from repro_torch import prng
    from repro_torch.core.learners import GBDTLearner, RFLearner
    from repro_torch.tree_util import tree_leaves, tree_map
    rng = np.random.default_rng(3)
    Xs = [rng.normal(0, 1, (n, 6)).astype(np.float32)
          for n in (40, 70, 130)]
    ys = [(X[:, 0] > 0).astype(np.int32) for X in Xs]
    learner = (RFLearner(num_classes=2, num_trees=6, depth=4)
               if kind == "rf" else GBDTLearner(num_rounds=8, depth=3))
    keys = prng.split(prng.PRNGKey(5), 3)
    stacked = learner.fit_stacked(keys, Xs, ys)
    for i in range(3):
        serial = learner.fit(keys[i], Xs[i], ys[i])
        for a, b in zip(tree_leaves(serial),
                        tree_leaves(tree_map(lambda x: x[i], stacked))):
            assert _bits_equal(a, b)


def test_round_on_card_equals_round_on_cpu(cuda):
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import RFLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    data = tabular_binary(n=1200, seed=0)
    cfg = FedKTConfig(num_parties=3, num_subsets=2, num_classes=2,
                      privacy_level="L2", gamma=0.1, query_fraction=0.2)
    learner = RFLearner(num_classes=2, num_trees=4, depth=3)
    th.launches = va.launches = 0
    card = FedKTSession(learner, data, cfg, engine="vmap").run()
    assert (th.launches, va.launches) == (3 * 2 * 4 + 4, 3 * 2)
    cpu = FedKTSession(learner, data, cfg, engine="vmap",
                       device="cpu").run()
    (lc,), (lp,) = ([r["labels"] for r in res.by_domain.values()]
                    for res in (card, cpu))
    np.testing.assert_array_equal(lc, lp)
    assert card.accuracy == cpu.accuracy and card.epsilon == cpu.epsilon
