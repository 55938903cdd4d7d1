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
(2e-5 float32, 2e-2 bfloat16) and identical run to run, at head dims
32 to 256.  The recurrence kernels are held to their plain versions
and are identical run to run: the RG-LRU scan bit for bit (each
channel's steps run in order, rounded as ``ref.rglru_scan_ref`` rounds
them), the WKV recurrence within the reference's kernel-test
tolerances against ``ref.wkv6_ref`` (1e-4 float32, 5e-2 bfloat16: the
WKV output's 64-term sums run in another order).
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


# both layouts: a thread per query (U <= 32) and a CTA per query (U
# above, up to a vocabulary); T under the card's 132 SMs, ragged T, M =
# 1, 16 and 70
@pytest.mark.parametrize("M,T,U", [(5, 6105, 2), (3, 64, 10),
                                   (16, 257, 1024), (1, 9, 1),
                                   (70, 50, 40), (1, 100, 2049),
                                   (16, 131, 4096), (5, 300, 200_064)])
@pytest.mark.parametrize("noise_kind", ["none", "gauss", "integer"])
def test_vote_kernel_bit_identical_to_plain(cuda, M, T, U, noise_kind):
    from repro_torch.kernels import ref
    from repro_torch.kernels import vote_aggregate as va
    g = torch.Generator(device=cuda).manual_seed(M + T + U)
    # few classes per query, and integer noise: many exact ties
    preds = torch.randint(0, min(U, 3), (M, T), device=cuda, generator=g,
                          dtype=torch.int32)
    noise = None
    if noise_kind == "gauss":
        noise = torch.randn((T, U), device=cuda, generator=g)
    elif noise_kind == "integer":
        noise = torch.randint(-2, 3, (T, U), device=cuda,
                              generator=g).float()
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



# The sample-parallel histogram: rows cut into chunks at fixed indices,
# partials combined in chunk order.  N off the chunk grid, the worst
# key collisions, the widest channel count, the leaf build's bins, and
# a tree alone against the same tree inside a padded stack.
@pytest.mark.parametrize("N", [1, 255, 257, 8193])
def test_tree_hist_rows_off_the_chunk_grid(cuda, N):
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_hist as th
    G, Gf, F, n, K, B = 3, 1, 5, 4, 2, 32
    xb, node, w = _hist_inputs(cuda, G, Gf, N, F, B, K, n, True, N)
    got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    assert torch.equal(got, ref.tree_hist_ref(xb, node, w, n, B))
    xb, node, w = _hist_inputs(cuda, G, Gf, N, F, B, K, n, False, N + 1)
    a = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    b = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    assert ref.tree_hist_f32_error(a, xb, node, w, n, B)[1] <= 1.0


@pytest.mark.parametrize("integer", [True, False])
def test_tree_hist_every_sample_in_one_cell(cuda, integer):
    """n = 1 and one bin: all 32 rows of every warp step collide."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_hist as th
    G, N, F, K, B = 2, 8193, 3, 2, 32
    xb, node, w = _hist_inputs(cuda, G, G, N, F, B, K, 1, integer, 5)
    xb = torch.full_like(xb, 7)
    got = th.tree_hist(xb, node, w, num_nodes=1, num_bins=B)
    if integer:
        assert torch.equal(got, ref.tree_hist_ref(xb, node, w, 1, B))
    else:
        again = th.tree_hist(xb, node, w, num_nodes=1, num_bins=B)
        torch.cuda.synchronize()
        assert _bits_equal(got, again)
        assert ref.tree_hist_f32_error(got, xb, node, w, 1, B)[1] <= 1.0
    assert bool((got[..., :7] == 0).all() and (got[..., 8:] == 0).all())


@pytest.mark.parametrize("K,n,B,F", [(16, 8, 32, 6), (16, 32, 32, 2),
                                     (2, 1, 64, 1), (3, 64, 64, 1),
                                     (2, 128, 64, 1)])
def test_tree_hist_wide_channels_and_bins(cuda, K, n, B, F):
    """K = 16 channels; the leaf build's 64 bins at n = 1; key spaces
    wider than one warp's window (n * B * K past 12,288 floats)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_hist as th
    G, N = 4, 3000
    xb, node, w = _hist_inputs(cuda, G, 2, N, F, B, K, n, True, K + n)
    got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    assert torch.equal(got, ref.tree_hist_ref(xb, node, w, n, B))
    xb, node, w = _hist_inputs(cuda, G, 2, N, F, B, K, n, False, K * n)
    got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    assert ref.tree_hist_f32_error(got, xb, node, w, n, B)[1] <= 1.0


@pytest.mark.parametrize("n,F,B", [(32, 14, 32), (1, 14, 32), (1, 1, 64)])
def test_tree_hist_alone_equals_in_padded_stack_as_bits(cuda, n, F, B):
    """One tree of 3000 rows alone (G = 1, N = 3000) and as tree 17 of
    a G = 40 stack over 8192 rows whose tail is zero-weight padding
    with arbitrary keys: the same float32 bits, as a serial and a
    stacked fit need; float weights of both signs stay within the f32
    limit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_hist as th
    G, N, N1, K = 40, 8192, 3000, 2
    xb, node, w = _hist_inputs(cuda, G, G, N, F, B, K, n, False, n + F)
    w[:, :, N1:] = 0.0
    w[17, :, N1::3] = -0.0
    stack = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
    alone = th.tree_hist(xb[17:18, :N1].contiguous(),
                         node[17:18, :N1].contiguous(),
                         w[17:18, :, :N1].contiguous(), num_nodes=n,
                         num_bins=B)
    torch.cuda.synchronize()
    assert _bits_equal(stack[17:18], alone)
    assert not bool((alone.view(torch.int32) == -2 ** 31).any())  # no -0.0
    assert ref.tree_hist_f32_error(stack, xb, node, w, n, B)[1] <= 1.0


ATT_SHAPES = [
    # B, Sq, Skv, H, KV, dh, q_offset
    (1, 128, 128, 4, 4, 64, 0),
    (2, 256, 256, 4, 2, 64, 0),      # GQA
    (2, 256, 256, 8, 1, 128, 0),     # MQA
    (1, 384, 384, 2, 2, 128, 0),
    (3, 77, 77, 8, 4, 32, 0),        # ragged edges on both axes
    (2, 1, 9, 4, 2, 64, 8),          # one query row
    (1, 100, 300, 4, 2, 128, 200),   # chunked prefill: q_offset
    (2, 200, 200, 10, 1, 256, 0),    # recurrentgemma's heads: dh 256, MQA
    (1, 70, 330, 2, 1, 256, 260),    # dh 256 with q_offset
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



WG_CASES = [
    # B, Sq, Skv, H, KV, q_offset, window, softcap
    (2, 2, 2, 8, 8, 0, 0, 0.0),          # GQA ratio 1, two rows
    (1, 63, 63, 24, 8, 0, 0, 0.0),       # ratio 3 (phi4's heads)
    (2, 65, 65, 8, 1, 0, 0, 50.0),       # ratio 8, soft-cap
    (1, 300, 300, 6, 2, 0, 96, 0.0),     # window
    (1, 63, 300, 3, 1, 237, 0, 0.0),     # q_offset: the last 63 rows
    (2, 65, 300, 8, 1, 235, 64, 50.0),   # offset, window and soft-cap
    (1, 70, 65, 4, 4, 100, 64, 0.0),     # rows 28.. see no key at all
    (1, 130, 130, 10, 1, 0, 0, 0.0),     # ratio 10 (recurrentgemma's)
]


@pytest.mark.parametrize("case", WG_CASES)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_flash_attention_wgmma_path(cuda, case, dh):
    """The bfloat16 path (TMA + wgmma) at head dims 32 to 256, at ragged
    Sq and Skv, q_offset, window, soft-cap and GQA ratios 1, 3, 8, 10:
    within 2e-2 of ``ref.attention_ref``, identical run to run, and
    exactly 0 on rows that see no key (where the naive oracle averages
    every value)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Sq, Skv, H, KV, off, window, cap = case
    q, k, v = _att_inputs(cuda, B, Sq, Skv, H, KV, dh, torch.bfloat16,
                          Sq * Skv + dh)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    qpos = torch.arange(Sq, device=cuda) + off
    seen = ref._mask(qpos, Skv, True, window, cuda).any(-1)     # (Sq,)
    assert bool((got[:, ~seen] == 0).all())
    torch.testing.assert_close(got[:, seen].float(), want[:, seen].float(),
                               atol=2e-2, rtol=2e-2)


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
    qd, kd, vd = _att_inputs(cuda, 1, 8, 8, 4, 2, 320, torch.float32, 3)
    with pytest.raises(ValueError, match="head dim"):   # above 256
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


@pytest.mark.parametrize("level", ["L0", "L1", "L2"])
def test_round_on_card_equals_round_on_cpu(cuda, level):
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import RFLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    data = tabular_binary(n=1200, seed=0)
    noise = {} if level == "L0" else dict(gamma=0.1, query_fraction=0.2)
    cfg = FedKTConfig(num_parties=3, num_subsets=2, num_classes=2,
                      privacy_level=level, **noise)
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


# ---------------------------------------------------------------------------
# The recurrences (K4 rglru_scan, K5 wkv6)
# ---------------------------------------------------------------------------
def _randn(g, shape, cuda, scale=1.0):
    return torch.randn(shape, generator=g, device=cuda) * scale


def _rglru_exact(x, log_a, h0):
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    before = rg.launches
    h, hl = rg.rglru_scan(x, log_a, h0)
    h2, hl2 = rg.rglru_scan(x, log_a, h0)
    want_h, want_hl = ref.rglru_scan_ref(x, log_a, h0)
    torch.cuda.synchronize()
    assert rg.launches == before + 2
    assert h.dtype == x.dtype and hl.dtype == torch.float32
    assert torch.equal(h, h2) and _bits_equal(hl, hl2)
    assert _bits_equal(h.float(), want_h.float())
    assert _bits_equal(hl, want_hl)


# D x element size a multiple of 16 bytes takes the TMA path, else the
# per-element path: bf16 D 2560, 512, 256, 40 and float32 also 100, 36
# are TMA; bf16 100, 36, 6, 1 and float32 6, 1 are not.  S = 1, S past
# a chunk (64 bf16 / 32 float32 steps), D past a 32-channel tile.
@pytest.mark.parametrize("B,S,D", [(1, 256, 256), (2, 512, 256),
                                   (2, 128, 512), (4, 1000, 2560),
                                   (3, 7, 100), (1, 2, 1), (2, 65, 40),
                                   (2, 70, 36), (2, 33, 6), (3, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_against_plain(cuda, B, S, D, dtype):
    """Bit for bit against the plain version, from a nonzero h0."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    x = _randn(g, (B, S, D), cuda).to(dtype)
    log_a = (-_randn(g, (B, S, D), cuda).abs() * 0.1).to(dtype)
    h0 = _randn(g, (B, D), cuda)
    _rglru_exact(x, log_a, h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_misaligned_base(cuda, dtype):
    """Contiguous tensors whose data starts off a 16-byte boundary take
    the per-element path, bit for bit as well."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, D = 2, 70, 64

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    x = offset(_randn(g, (B, S, D), cuda).to(dtype))
    log_a = offset((-_randn(g, (B, S, D), cuda).abs() * 0.1).to(dtype))
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _rglru_exact(x, log_a, _randn(g, (B, D), cuda))


@pytest.mark.parametrize("B,S,H", [(1, 256, 2), (2, 128, 4), (2, 77, 3),
                                   (1, 2, 1), (1, 1000, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nonzero_s0", [False, True])
def test_wkv6_kernel_against_plain(cuda, B, S, H, dtype, nonzero_s0):
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    dh = 64
    g = torch.Generator(device=cuda).manual_seed(S + H)
    r, k, v = (_randn(g, (B, S, H, dh), cuda, 0.5).to(dtype)
               for _ in range(3))
    w = torch.sigmoid(_randn(g, (B, S, H, dh), cuda)).to(dtype)
    u = _randn(g, (H, dh), cuda, 0.1)
    s0 = (_randn(g, (B, H, dh, dh), cuda, 0.1) if nonzero_s0
          else torch.zeros((B, H, dh, dh), device=cuda))
    before = wk.launches
    o, sl = wk.wkv6(r, k, v, w, u, s0)
    o2, sl2 = wk.wkv6(r, k, v, w, u, s0)
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wk.launches == before + 2
    assert o.dtype == dtype and sl.dtype == torch.float32
    assert torch.equal(o, o2) and _bits_equal(sl, sl2)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(sl, want_s, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_with_decays_near_one(cuda, dtype):
    """Decays near 1, the model's w = exp(-exp(x)) with x ~ N(-4, 1)
    (``models/rwkv.py``), over 1024 steps from a nonzero state: the state
    accumulates longest.  Within the reference's tolerances on o and
    s_last, identical run to run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    B, S, H, dh = 2, 1024, 4, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    r, k, v = (_randn(g, (B, S, H, dh), cuda, 0.5).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(_randn(g, (B, S, H, dh), cuda) - 4)).to(dtype)
    u = _randn(g, (H, dh), cuda, 0.1)
    s0 = _randn(g, (B, H, dh, dh), cuda, 0.1)
    o, sl = wk.wkv6(r, k, v, w, u, s0)
    o2, sl2 = wk.wkv6(r, k, v, w, u, s0)
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and _bits_equal(sl, sl2)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(sl, want_s, atol=tol, rtol=tol)


def test_recurrence_ops_launch_only_for_prefill(cuda):
    """ops.rglru / ops.wkv: a prefill (S > 1) launches the kernel, a
    decode step (S == 1) takes the plain formula, as the reference's
    ops do; a prefill followed by decode steps equals one longer
    prefill."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, D, H = 2, 12, 96, 2
    x = _randn(g, (B, S, D), cuda)
    log_a = -_randn(g, (B, S, D), cuda).abs() * 0.1
    before = rg.launches
    h_all, hl_all = ops.rglru(x, log_a)
    h, hl = ops.rglru(x[:, :8].contiguous(), log_a[:, :8].contiguous())
    assert rg.launches == before + 2
    for t in range(8, S):
        ht, hl = ops.rglru(x[:, t:t + 1].contiguous(),
                           log_a[:, t:t + 1].contiguous(), hl)
        torch.testing.assert_close(ht[:, 0], h_all[:, t], atol=1e-5,
                                   rtol=1e-5)
    assert rg.launches == before + 2
    torch.testing.assert_close(hl, hl_all, atol=1e-5, rtol=1e-5)

    r, k, v = (_randn(g, (B, S, H, 64), cuda, 0.5) for _ in range(3))
    w = torch.sigmoid(_randn(g, (B, S, H, 64), cuda))
    u = _randn(g, (H, 64), cuda, 0.1)
    before = wk.launches
    o_all, s_all = ops.wkv(r, k, v, w, u)
    o, s = ops.wkv(*(t[:, :8].contiguous() for t in (r, k, v, w)), u)
    assert wk.launches == before + 2
    for t in range(8, S):
        ot, s = ops.wkv(*(a[:, t:t + 1].contiguous() for a in (r, k, v, w)),
                        u, s)
        torch.testing.assert_close(ot[:, 0], o_all[:, t], atol=1e-4,
                                   rtol=1e-4)
    assert wk.launches == before + 2
    torch.testing.assert_close(s, s_all, atol=1e-4, rtol=1e-4)


def test_recurrence_wrappers_refuse_bad_inputs(cuda):
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    x = torch.zeros((2, 8, 16), device=cuda)
    h0 = torch.zeros((2, 16), device=cuda)
    with pytest.raises(TypeError):                 # dtype
        rg.rglru_scan(x.half(), x.half(), h0)
    with pytest.raises(TypeError):                 # mixed dtypes
        rg.rglru_scan(x, x.bfloat16(), h0)
    with pytest.raises(TypeError):                 # h0 must be float32
        rg.rglru_scan(x, x, h0.bfloat16())
    with pytest.raises(ValueError):                # device
        rg.rglru_scan(x, x.cpu(), h0)
    with pytest.raises(ValueError):                # shape
        rg.rglru_scan(x, x[:, :4], h0)
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan(x, x.transpose(0, 1).contiguous().transpose(0, 1),
                      h0)
    r = torch.zeros((1, 4, 2, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    s0 = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        r32 = torch.zeros((1, 4, 2, 32), device=cuda)
        wk.wkv6(r32, r32, r32, r32, u[:, :32].contiguous(),
                s0[..., :32, :32].contiguous())
    with pytest.raises(TypeError):
        wk.wkv6(r, r, r.bfloat16(), r, u, s0)
    with pytest.raises(TypeError):
        wk.wkv6(r, r, r, r, u, s0.double())
    with pytest.raises(ValueError):
        wk.wkv6(r, r, r, r.cpu(), u, s0)
    with pytest.raises(ValueError):
        wk.wkv6(r, r, r, r, u, s0[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r, u,
                s0)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_recurrent_serve_batch_on_card_equals_cpu(cuda, arch):
    """The smoke config in float32: serve_batch on the card (kernels)
    and on the CPU (plain versions) with the same weights, held to the
    parity rule with logits within 1e-4 of the largest; each prefill
    launches one kernel per recurrent layer (and per local-attention
    layer); a prefill followed by decode steps equals a longer
    prefill's last logits."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import Model
    from repro_torch.serving import compare_stream, serve_batch
    cfg = get_smoke(arch).replace(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cpu_params = model.init(device="cpu")
    cpu_params.load_state_dict({n: t.cpu() for n, t in
                                params.state_dict().items()})
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 100)).astype(np.int32)
    before = (rg.launches, wk.launches, fa.launches)
    toks, stats = serve_batch(model, params, prompts, 6, verbose=False,
                              keep_logits=True)
    got = (rg.launches - before[0], wk.launches - before[1],
           fa.launches - before[2])
    kinds = cfg.layer_kinds
    assert got == (kinds.count("rglru"), kinds.count("rwkv"),
                   kinds.count("attn_local"))
    ctoks, cstats = serve_batch(model, cpu_params, prompts, 6,
                                verbose=False, keep_logits=True)
    scale = float(cstats["logits"].abs().max())
    for i in range(2):
        info = compare_stream(toks[i].tolist(), stats["logits"][i],
                              ctoks[i].tolist(), cstats["logits"][i])
        assert info["explained"], info
        assert info["max_diff"] <= 1e-4 * scale, info
    # prefill(P) + decode steps == prefill(P + n)
    longer = np.concatenate([prompts, toks[:, :5]], axis=1)
    with torch.inference_mode():
        lg, _ = model.logits(params, {"tokens": torch.as_tensor(
            longer, device=cuda)}, mode="prefill")
    torch.testing.assert_close(lg[:, -1].cpu(), stats["logits"][:, 5].cpu(),
                               atol=1e-4 * scale, rtol=0)
