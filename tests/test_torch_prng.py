"""The threefry port against ``jax.random``: keys, splits, ``fold_in``,
draws and ``choice(p=...)`` are bit-exact; ``normal`` is within
atol=2.5e-7, rtol=1.2e-7 (XLA's ``erf_inv`` and log1p round otherwise
in about 1 % of draws);
Laplace noise agrees within rtol=1e-6 (the same uniform bits, but
``log1p`` may differ between XLA and torch by an ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import voting as jvoting
from repro_torch import prng
from repro_torch.core import voting

SEEDS = (0, 1, 7, 123456, 2 ** 31 - 1)
SHAPES = ((1,), (7,), (3, 5), (20, 257))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    pkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), pkey)
    assert pkey.dtype == np.uint32
    for num in (2, 3, 8):
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, num)),
                                      prng.split(pkey, num))
    # the schedules the round plays: repeated two-way splits
    k, pk = key, pkey
    for _ in range(5):
        k, _ = jax.random.split(k)
        pk, _ = prng.split(pk)
    np.testing.assert_array_equal(np.asarray(k), pk)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_exact(seed, shape):
    key = jax.random.PRNGKey(seed)
    pkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, shape, jnp.uint32)),
        prng.bits(pkey, shape))
    for lo, hi in ((0.0, 1.0), (-0.5, 0.5), (2.0, 7.5)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(pkey, shape, lo, hi)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hi", (1, 2, 33, 4097, 36631, 70000, 2 ** 31 - 1))
def test_randint_bit_exact(seed, hi):
    key = jax.random.PRNGKey(seed)
    pkey = prng.PRNGKey(seed)
    for shape in ((5,), (4, 300)):
        want = np.asarray(jax.random.randint(key, shape, 0, hi))
        got = prng.randint(pkey, shape, 0, hi)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (0, 5, 99))
def test_laplace_matches_reference(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jvoting.laplace(key, (64, 10), 10.0))
    got = voting.laplace(prng.PRNGKey(seed), (64, 10), 10.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 2, 17, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(key, data)),
            prng.fold_in(prng.PRNGKey(seed), data))


# (bucket, real rows): the fit's row masks, from a full bucket to the
# 6000-of-8192 fill of an Adult-size party, and one under a block of 16
@pytest.mark.parametrize("bucket,n", [(32, 5), (32, 32), (64, 33),
                                      (1024, 1000), (4096, 4096),
                                      (8192, 6000), (65536, 40000)])
def test_choice_with_p_bit_exact(bucket, n):
    """The fit's batch draw: ``choice(k, bucket, (64,), p=mask/sum)``
    under ``split(fold_in(key, 2), steps)``, one step at a time in the
    reference and as one stack of keys in the port."""
    mask = np.zeros((bucket,), np.float32)
    mask[:n] = 1.0
    p = mask / mask.sum()
    key = jax.random.PRNGKey(bucket + n)
    keys = jax.random.split(jax.random.fold_in(key, 2), 12)
    want = np.stack([np.asarray(jax.random.choice(k, bucket, (64,),
                                                  p=jnp.asarray(p)))
                     for k in keys])
    pkeys = prng.split(prng.fold_in(prng.PRNGKey(bucket + n), 2), 12)
    got = prng.choice(pkeys, bucket, (64,), p)
    np.testing.assert_array_equal(got, want)
    assert got.max() < n
    # one key at a time, and a non-uniform p
    np.testing.assert_array_equal(prng.choice(pkeys[3], bucket, (64,), p),
                                  want[3])
    q = np.random.default_rng(n).random(bucket).astype(np.float32)
    q /= q.sum()
    np.testing.assert_array_equal(
        prng.choice(pkeys[0], bucket, (5, 7), q),
        np.asarray(jax.random.choice(keys[0], bucket, (5, 7),
                                     p=jnp.asarray(q))))


@pytest.mark.parametrize("n", [7, 16, 17, 100, 5000, 65536])
def test_blocked_cumsum_is_xlas(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    np.testing.assert_array_equal(prng._cumsum16(x),
                                  np.asarray(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_erf_inv_rounding(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, (200, 50)))
    got = prng.normal(prng.PRNGKey(seed), (200, 50))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=2.5e-7)
    assert (got != want).mean() < 0.05


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_tensor_matches_normal(seed, monkeypatch):
    """``normal_tensor`` (the device-side draw of full-width inits), run
    on the CPU in passes of 997 draws: ``normal``'s bits, but where
    torch's float64 log1p rounds otherwise than numpy's (a last float32
    bit in about 1e-5 of draws)."""
    monkeypatch.setattr(prng, "_CHUNK", 997)
    want = prng.normal(prng.PRNGKey(seed), (300, 70))
    got = prng.normal_tensor(prng.PRNGKey(seed), (300, 70), "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert (got != want).mean() < 1e-3
    np.testing.assert_array_less(np.abs(got - want),
                                 np.spacing(np.abs(want)) * 1.01)
