"""The port's vote and tree-histogram ops (plain versions, on the CPU)
against the JAX reference's kernels, run as the reference's own tests
run them: the Pallas kernel in interpret mode, and the xla path.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: every vote output is exact (integer counts plus one float
add of the same noise value); histograms are exact for integer weights
and within rtol=atol=1e-6 for float weights (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

JAX_IMPLS = ("kernel_interpret", "xla")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("M,T,U", [(5, 128, 512), (16, 256, 1024),
                                   (3, 64, 10), (5, 96, 2)])
@pytest.mark.parametrize("noisy", [False, True])
def test_votes_match_reference_exactly(M, T, U, noisy):
    rng = np.random.default_rng(M * 1000 + T + U + noisy)
    preds = rng.integers(0, U, (M, T)).astype(np.int32)
    noise = (rng.laplace(0, 0.3, (T, U)).astype(np.float32)
             if noisy else None)
    tn = _t(noise) if noisy else None
    got = ops.votes(_t(preds), U, tn)
    got_c = ops.votes_with_clean(_t(preds), U, tn)
    for impl in JAX_IMPLS:
        jn = jnp.asarray(noise) if noisy else None
        want = jops.votes(jnp.asarray(preds), U, jn, impl=impl)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        want_c = jops.votes_with_clean(jnp.asarray(preds), U, jn,
                                       impl=impl)
        np.testing.assert_array_equal(_np(got_c[0]), np.asarray(want_c[0]))
        np.testing.assert_array_equal(_np(got_c[2]), np.asarray(want_c[2]))
        np.testing.assert_array_equal(_np(got_c[3]), np.asarray(want_c[3]))
        if impl == "xla":
            np.testing.assert_array_equal(_np(got_c[1]),
                                          np.asarray(want_c[1]))


def test_vote_plain_five_outputs_are_consistent():
    """The plain version of the kernel's five outputs: noisy labels and
    top-2 of counts + noise, clean top-2 of counts, exact ties giving
    top2 == top1."""
    preds = torch.tensor([[0, 1, 2, 1], [0, 1, 0, 2], [1, 2, 2, 0]],
                         dtype=torch.int32)
    lab, t1, t2, c1, c2 = ref.vote_aggregate_plain(preds, 3)
    np.testing.assert_array_equal(lab.numpy(), [0, 1, 2, 0])
    np.testing.assert_array_equal(c1.numpy(), [2, 2, 2, 1])
    np.testing.assert_array_equal(c2.numpy(), [1, 1, 1, 1])
    assert torch.equal(t1, c1) and torch.equal(t2, c2)
    noise = torch.zeros((4, 3))
    noise[3, 2] = 0.5
    lab, t1, t2, c1, c2 = ref.vote_aggregate_plain(preds, 3, noise)
    assert lab[3] == 2 and t1[3] == 1.5 and t2[3] == 1.0 and c1[3] == 1


@pytest.mark.parametrize("M,T,U", [(1, 5, 3), (7, 40, 9), (16, 33, 50)])
def test_votes_sort_matches_histogram(M, T, U):
    rng = np.random.default_rng(M + T + U)
    preds = _t(rng.integers(0, U, (M, T)).astype(np.int32))
    labels, top1, top2 = ops.votes_sort(preds)
    want = ref.vote_aggregate_plain(preds, U)
    assert torch.equal(labels, want[0])
    assert torch.equal(top1, want[1])
    if M > 1:
        assert torch.equal(top2, want[2].clamp_min(0))


@pytest.mark.parametrize("N,F,n,K", [(300, 14, 8, 2), (128, 6, 1, 2),
                                     (512, 33, 16, 3), (70, 5, 32, 1)])
@pytest.mark.parametrize("integer", [False, True])
def test_tree_hist_matches_reference(N, F, n, K, integer):
    B = 32
    rng = np.random.default_rng(N + F + n + K)
    xb = rng.integers(0, B, (N, F)).astype(np.int32)
    node = rng.integers(0, n, (N,)).astype(np.int32)
    w = (rng.integers(0, 4, (K, N)) if integer
         else rng.random((K, N))).astype(np.float32)
    w[:, -N // 4:] = 0.0                       # padding-style zero rows
    got = ops.tree_hist(_t(xb)[None], _t(node)[None], _t(w)[None],
                        num_nodes=n, num_bins=B)[0].numpy()
    assert got.shape == (K, n, F, B)
    for impl in JAX_IMPLS:
        want = np.asarray(jops.tree_hist(
            jnp.asarray(xb), jnp.asarray(node), jnp.asarray(w),
            num_nodes=n, num_bins=B, impl=impl))
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # w == 0 rows add EXACT zeros: scrambling what they hold is
    # bit-identical
    pad = N // 4
    xb2, node2 = xb.copy(), node.copy()
    xb2[-pad:] = rng.integers(0, B, (pad, F))
    node2[-pad:] = rng.integers(0, n, (pad,))
    got2 = ops.tree_hist(_t(xb2)[None], _t(node2)[None], _t(w)[None],
                         num_nodes=n, num_bins=B)[0].numpy()
    np.testing.assert_array_equal(got, got2)


def test_tree_hist_batch_axis_matches_reference_vmap():
    """The leading batch axis (trees sharing a forest's rows, and
    several forests) against the reference's vmap over trees."""
    Gf, per, N, F, n, B = 2, 3, 160, 7, 4, 32
    rng = np.random.default_rng(0)
    xb = rng.integers(0, B, (Gf, N, F)).astype(np.int32)
    nodes = rng.integers(0, n, (Gf * per, N)).astype(np.int32)
    ws = rng.integers(0, 5, (Gf * per, 2, N)).astype(np.float32)
    got = ops.tree_hist(_t(xb), _t(nodes), _t(ws), num_nodes=n,
                        num_bins=B).numpy()
    for impl in JAX_IMPLS:
        for f in range(Gf):
            sl = slice(f * per, (f + 1) * per)
            want = jax.vmap(lambda nd, wk: jops.tree_hist(
                jnp.asarray(xb[f]), nd, wk, num_nodes=n, num_bins=B,
                impl=impl))(jnp.asarray(nodes[sl]), jnp.asarray(ws[sl]))
            np.testing.assert_array_equal(got[sl], np.asarray(want))
    # each tree's slice equals its own unbatched build
    for g in range(Gf * per):
        one = ops.tree_hist(_t(xb[g // per])[None], _t(nodes[g])[None],
                            _t(ws[g])[None], num_nodes=n, num_bins=B)
        np.testing.assert_array_equal(got[g], one[0].numpy())


@pytest.mark.parametrize("integer", [False, True])
def test_node_hist_matches_reference(integer):
    N, L, K = 200, 64, 2
    rng = np.random.default_rng(1)
    node = rng.integers(0, L, (N,)).astype(np.int32)
    w = (rng.integers(0, 3, (K, N)) if integer
         else rng.random((K, N))).astype(np.float32)
    got = ops.node_hist(_t(node)[None], _t(w)[None], num_nodes=L)[0]
    for impl in JAX_IMPLS:
        want = np.asarray(jops.node_hist(jnp.asarray(node),
                                         jnp.asarray(w), num_nodes=L,
                                         impl=impl))
        np.testing.assert_allclose(got.numpy(), want,
                                   rtol=0 if integer else 1e-6,
                                   atol=0 if integer else 1e-6)


def test_cpu_tensors_take_the_plain_version_only():
    """On CPU tensors the ops run the plain versions: no kernel launch
    is counted and the results are the plain versions' own."""
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    rng = np.random.default_rng(2)
    preds = _t(rng.integers(0, 3, (4, 16)).astype(np.int32))
    noise = _t(rng.laplace(0, 1, (16, 3)).astype(np.float32))
    xb = _t(rng.integers(0, 8, (1, 40, 3)).astype(np.int32))
    node = _t(rng.integers(0, 4, (2, 40)).astype(np.int32))
    w = _t(rng.random((2, 2, 40)).astype(np.float32))
    before = (va.launches, th.launches)
    got = ops.votes(preds, 3, noise)
    for a, b in zip(got, ref.vote_aggregate_plain(preds, 3, noise)[:3]):
        assert torch.equal(a, b)
    assert torch.equal(ops.tree_hist(xb, node, w, num_nodes=4, num_bins=8),
                       ref.tree_hist_ref(xb, node, w, 4, 8))
    assert torch.equal(ops.node_hist(node, w, num_nodes=4),
                       ref.node_hist_ref(node, w, 4))
    assert (va.launches, th.launches) == before


def _sequential_f32_hist(xb, node, w, n, B, dtype=np.float32):
    """The kernel's summation order emulated on the CPU: each cell adds
    its samples' weights one after another, in sample order, in
    ``dtype`` (np.add.at is unbuffered and runs in index order)."""
    K, N = w.shape
    F = xb.shape[1]
    out = np.zeros((K, n, F, B), dtype)
    for k in range(K):
        for f in range(F):
            np.add.at(out[k, :, f], (node, xb[:, f]), w[k].astype(dtype))
    return out


@pytest.mark.parametrize("N,n,B", [(2000, 32, 32), (3000, 1, 64)])
def test_float_hist_limit_holds_float32_and_rejects_bfloat16(N, n, B):
    """The float-weight check of the kernel (``ref.tree_hist_f32_error``)
    passes every float32 accumulation order — the plain version's single
    rounding and the kernel's sample-order sum — and fails a sum held in
    bfloat16 or float16, at a GBDT level-5 and a leaf-build shape."""
    F = 3 if n > 1 else 1
    rng = np.random.default_rng(N + n)
    xb = rng.integers(0, B, (N, F)).astype(np.int32)
    node = rng.integers(0, n, (N,)).astype(np.int32)
    w = (rng.random((2, N)) * 2 - 1).astype(np.float32)
    w[:, -N // 8:] = 0.0
    args = (_t(xb)[None], _t(node)[None], _t(w)[None], n, B)
    plain = ref.tree_hist_ref(*args)
    seq = _t(_sequential_f32_hist(xb, node, w, n, B))[None]
    for got in (plain, seq):
        err, ratio = ref.tree_hist_f32_error(got, *args)
        assert 0 < err and ratio <= 1.0
    half = _t(_sequential_f32_hist(xb, node, w, n, B, np.float16)
              .astype(np.float32))[None]
    bf16 = plain.to(torch.bfloat16).to(torch.float32)
    for got in (half, bf16):
        assert ref.tree_hist_f32_error(got, *args)[1] > 100.0


@pytest.mark.parametrize("N,F,K,n,B", [(8192, 14, 2, 32, 32),
                                       (8192, 14, 2, 1, 32),
                                       (8192, 1, 2, 1, 64),
                                       (1, 3, 16, 64, 64), (0, 5, 2, 4, 8),
                                       (100_000, 40, 16, 32, 32),
                                       (257, 33, 10, 16, 32),
                                       (3000, 1, 3, 64, 64)])
def test_tree_hist_launch_plan(N, F, K, n, B):
    """The histogram kernel's launch plan (``tree_hist.plan``): chunks
    of a power-of-two row count set by the key space n * B alone (a
    serial and a stacked fit cut a tree's rows alike, whatever N); warps
    a CTA and feature groups covering F; a warp's key window and a CTA's
    histograms within their shared-memory budgets."""
    from repro_torch.kernels import tree_hist as th
    chunk, chunks, window, warps, groups = th.plan(N, F, K, n, B)
    assert th.CHUNK_MIN <= chunk <= th.CHUNK_MAX
    assert chunk & (chunk - 1) == 0 and (chunk >= 2 * n * B or
                                         chunk == th.CHUNK_MAX)
    more = th.plan(10 * N + 7, F, K, n, B)
    assert more[0] == chunk and more[2:] == (window, warps, groups)
    assert (chunks - 1) * chunk < N <= chunks * chunk or N == chunks == 0
    assert 1 <= window <= n * B and K * window <= th.WARP_HIST
    assert window == n * B or K * (window + 1) > th.WARP_HIST
    assert 1 <= warps <= th.MAX_WARPS
    assert warps == 1 or warps * K * window <= th.CTA_HIST
    assert (groups - 1) * warps < F <= groups * warps
    # level 5 of the round: 2048-row chunks, 7 features a CTA; level 0
    # and the leaf build: 256-row chunks
    if (N, F, K, n, B) == (8192, 14, 2, 32, 32):
        assert (chunk, chunks, window, warps, groups) == (2048, 4, 1024, 7,
                                                          2)
    if n == 1:
        assert chunk == 256


@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_launch_plan(dh, dtype):
    """The attention kernel's launch plan (``flash_attention.plan``):
    every bfloat16 head dim takes the wgmma path (a warpgroup of 64 query
    rows and a producer warp, a 2-stage K/V ring; two CTAs an SM at dh
    <= 128, three at stablelm's dh 80), float32 the FMA path; the shared
    memory the launcher asks for stays within what one CTA may opt into
    on the H100 (232,448 bytes), and the threads are whole warps."""
    from repro_torch.kernels import flash_attention as fa
    p = fa.plan(dh, dtype)
    assert p.keys == 64 and p.threads % 32 == 0
    assert 0 < p.smem <= fa.SMEM_MAX == 232_448
    if dtype == torch.bfloat16:
        assert (p.path, p.rows, p.threads) == ("wgmma", 64, 160)
        # a Q tile and a 2-stage K/V ring of 64 x dh bf16 tiles, 9
        # barriers, and the 1 KB alignment slack
        tile = 64 * dh * 2
        assert p.smem == 1024 + tile * 5 + 72
        if dh <= 128:   # two CTAs an SM
            assert 2 * p.smem <= 228 * 1024
        if dh == 80:    # three: five 2 KB boxes a tile
            assert p.smem == 52_296 and 3 * p.smem <= 228 * 1024
    else:
        assert (p.path, p.rows, p.threads) == ("fma", 64, 256)
        # Q, the K tile or the P tile over it, V; rows padded by 1
        assert p.smem == 4 * (64 * (dh + 1) + 64 * max(dh + 1, 65)
                              + 64 * dh)


@pytest.mark.parametrize("dh", [32, 64, 80, 128, 256])
def test_flash_attention_tile_geometry(dh):
    """The wgmma path's tile geometry (``flash_attention.tile``, the
    mirror of ``csrc/hopper.cuh: Tile``) at every head dim the forward
    launches: its boxes cover the row's dh columns exactly, a box's row
    of bytes fills its swizzle span (a TMA box may not be wider), a
    k-step of 16 columns never straddles two boxes, a tile keeps the next
    one on the 1024-byte period the kernel aligns Q to, and the plan's
    shared memory is that of 5 such tiles."""
    from repro_torch.kernels import flash_attention as fa
    assert dh in fa.HEAD_DIMS
    t = fa.tile(dh)
    assert t.swizzle in (32, 64, 128)
    assert t.boxes * t.cols == dh and t.cols * 2 == t.swizzle
    assert t.cols % 16 == 0                       # whole k-steps a box
    box = 64 * t.swizzle
    assert t.boxes * box == 64 * dh * 2           # the whole bf16 tile
    assert t.boxes * box % 1024 == 0
    assert fa.plan(dh, torch.bfloat16).smem == \
        1024 + 5 * t.boxes * box + 72
    # stablelm's 160-byte row: five 32-byte boxes, no padding to 128
    if dh == 80:
        assert t == fa.Tile(swizzle=32, cols=16, boxes=5)
    assert fa.padded_head_dim(dh) == dh


@pytest.mark.parametrize("S", [0, 1, 2, 15, 16, 17, 77, 1000, 1024,
                               100_001])
def test_wkv6_launch_plan(S):
    """The WKV kernel's launch plan (``wkv6.plan``): a thread holds a
    rows x cols block of the state, the lanes of a column block adjacent
    in one warp, so a (batch, head)'s threads are whole warps and cover
    the 64 x 64 state once; chunks of steps that cover any S, the last
    one partial; the staged chunk and its partial sums within one CTA's
    shared memory, two CTAs an SM."""
    from repro_torch.kernels import wkv6 as wk
    p = wk.plan(S)
    assert (p.rows, p.cols, p.chunk) == (wk.ROWS, wk.COLS, wk.CHUNK)
    assert p.threads % 32 == 0 and 32 % p.lanes == 0
    assert p.lanes * p.rows == 64 and p.threads * p.rows * p.cols == 64 * 64
    assert p.rows % 4 == 0 and p.cols % 4 == 0
    assert (p.chunks - 1) * p.chunk < S <= p.chunks * p.chunk or \
        S == p.chunks == 0
    # r, k, w, v double-buffered, rows padded by 8; o's partials, rows
    # padded by 4; u; the betas, double-buffered
    assert p.smem == 4 * (p.chunk * (8 * 72 + p.lanes * 68) + 64
                          + 2 * p.chunk)
    assert 2 * p.smem <= 228 * 1024
    # a chunk's 16-byte loads of r, k, w, v split evenly over threads
    assert (4 * p.chunk * 64 // 8) % p.threads == 0
