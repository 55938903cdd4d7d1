"""The class-blocked vote (``ref.vote_aggregate_blocked``) and its merge
rule (``ref.fold_top2``), on the CPU, against the plain vote and the
JAX reference's Pallas kernel in interpret mode with class blocks
narrower than U.

The merge rule is the one the CUDA vote kernel folds its partial
results by, over whatever partition of the classes its layout makes.
Inputs are made from a seed with numpy; predictions come from at most
three classes and the noise is often integer-valued, so exact ties (in
the counts and in the noisy scores) are common.  Tolerance: none, every
output is held bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vote_aggregate import vote_aggregate as jax_vote
from repro_torch.kernels import ref

OUTPUTS = ("labels", "top1", "top2", "clean1", "clean2")


def _inputs(M, T, U, noise, seed):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, min(U, 3), (M, T)).astype(np.int32)
    if noise == "none":
        return preds, None
    if noise == "integer":
        return preds, rng.integers(-2, 3, (T, U)).astype(np.float32)
    return preds, rng.laplace(0, 1.0, (T, U)).astype(np.float32)


def _bits(t):
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want):
    for name, a, b in zip(OUTPUTS, got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


BLOCK_CASES = [(1, 9, 1, 1), (1, 9, 7, 2), (5, 96, 2, 1), (3, 64, 10, 3),
               (16, 100, 33, 8), (5, 128, 512, 128), (16, 256, 1024, 100),
               (5, 256, 4096, 512), (16, 37, 2049, 256)]


@pytest.mark.parametrize("M,T,U,block_u", BLOCK_CASES)
@pytest.mark.parametrize("noise", ["none", "integer", "laplace"])
def test_blocked_vote_equals_plain(M, T, U, block_u, noise):
    preds, nz = _inputs(M, T, U, noise, M * 7919 + T * 31 + U)
    p, n = torch.from_numpy(preds), _torch(nz)
    got = ref.vote_aggregate_blocked(p, U, n, block_u=block_u)
    _assert_same([g.numpy() for g in got],
                 [w.numpy() for w in ref.vote_aggregate_plain(p, U, n)])


# the Pallas kernel takes whole blocks: U % block_u == 0, T % 128 == 0
# or T <= 128; block_u < U so the walk folds several class blocks
JAX_CASES = [(1, 8, 8, 2), (3, 64, 10, 5), (5, 128, 512, 128),
             (16, 256, 1024, 256), (5, 256, 4096, 512)]


@pytest.mark.parametrize("M,T,U,block_u", JAX_CASES)
@pytest.mark.parametrize("noise", ["integer", "laplace"])
def test_blocked_vote_equals_jax_kernel_interpret(M, T, U, block_u, noise):
    preds, nz = _inputs(M, T, U, noise, M * 104729 + T + U)
    want = jax_vote(jnp.asarray(preds), jnp.asarray(nz), num_classes=U,
                    block_u=block_u, interpret=True)
    got = ref.vote_aggregate_blocked(torch.from_numpy(preds), U,
                                     torch.from_numpy(nz), block_u=block_u)
    _assert_same([g.numpy() for g in got], want)


@pytest.mark.parametrize("M,T,U", [(1, 40, 64), (5, 64, 300), (16, 50, 97)])
@pytest.mark.parametrize("noise", ["none", "integer", "laplace"])
def test_kernel_partition_folds_to_plain(M, T, U, noise):
    """The partition the CUDA kernel's CTA-per-query layout folds:
    the classes no teacher chose in thread-strided slices scored 0.0 +
    noise, each chosen class alone with its count, and the clean top-2
    from the chosen classes plus one zero-count class, folded in a
    scrambled order."""
    preds, nz = _inputs(M, T, U, noise, M + T * 3 + U)
    rng = np.random.default_rng(U)
    empty = (torch.full((1,), ref.NEG_INF),
             torch.full((1,), ref.NO_CLASS, dtype=torch.int32),
             torch.full((1,), ref.NEG_INF))
    want = ref.vote_aggregate_plain(torch.from_numpy(preds), U, _torch(nz))
    for t in range(T):
        chosen = np.unique(preds[:, t])
        counts = np.array([(preds[:, t] == c).sum() for c in chosen],
                          dtype=np.float32)
        free = np.setdiff1d(np.arange(U), chosen)
        parts, clean = [], []
        for c, k in zip(chosen, counts):
            ids = torch.tensor([c])
            s = k if nz is None else k + nz[t, c]
            parts.append(ref.block_top2(torch.tensor([[s]]), ids))
            clean.append(ref.block_top2(torch.tensor([[k]]), ids))
        if len(free):
            zeros = torch.zeros((1, min(2, len(free))))
            clean.append(ref.block_top2(zeros, torch.tensor(free[:2])))
        if nz is None:
            parts += clean[len(chosen):]
        else:
            for lane in range(4):
                ids = torch.tensor(free[lane::4])
                if len(ids):
                    scores = 0.0 + torch.from_numpy(nz[t, ids.numpy()])
                    parts.append(ref.block_top2(scores[None], ids))
        folded = []
        for group in (parts, clean):
            acc = empty
            for i in rng.permutation(len(group)):
                acc = ref.fold_top2(acc, group[i])
            folded.append(acc)
        (top1, label, top2), (c1, _, c2) = folded
        got = (label, top1, top2, c1, c2)
        _assert_same([g.numpy() for g in got],
                     [w[t:t + 1].numpy() for w in want])
