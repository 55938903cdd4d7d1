"""The threefry port against ``jax.random``: keys, splits and draws are
bit-exact; Laplace noise agrees within rtol=1e-6 (the same uniform
bits, but ``log1p`` may differ between XLA and torch by an ulp)."""
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
