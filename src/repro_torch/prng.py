"""threefry2x32 keys and draws, bit-exact with ``jax.random``.

The reference threads ``jax.random`` keys through every step of the
round (party key schedules, server splits, RF bootstrap and feature
masks, Laplace noise).  This module reproduces the draws the round
makes, bit for bit, so whole rounds compare seed for seed:

  PRNGKey(seed)               -> (2,) uint32 key
  split(key, num)             -> (num, 2) uint32 keys
  bits(key, shape)            -> uint32 array
  uniform(key, shape, lo, hi) -> float32 array
  randint(key, shape, lo, hi) -> int32 array

It follows JAX's ``jax_threefry_partitionable=True`` layout (the
default since JAX 0.5): element i of a shaped draw hashes the 64-bit
counter i split into (hi, lo) 32-bit words, and 32-bit draws are the
XOR of the two output words.  Keys are numpy arrays on the host; the
draws are numpy too and callers move them to their device.  Everything
is uint32 arithmetic, which numpy wraps modulo 2**32.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2)
    under key (k1, k2); uint32 arrays in, a pair of uint32 arrays out."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = np.asarray(x1, np.uint32) + ks[0]
    x2 = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def _counters(shape):
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 subkeys."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` for uint32."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0 give [1, 2), shifted and scaled to [minval, maxval)."""
    b = bits(key, shape)
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses f * (hi - lo) + lo into one fused multiply-add; the
    # float64 product of two float32 values is exact, so one rounding
    # of the float64 sum to float32 gives the same bits
    scaled = (f.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` in int32: two 32-bit draws per value,
    combined as (hi mod span) * (2**32 mod span) + (lo mod span), all
    modulo span, in wrapping uint32 arithmetic as JAX does it."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    # one-element arrays, not scalars: numpy wraps array arithmetic
    # modulo 2**32 silently, as lax does
    span = np.array([span], np.uint32)
    mult = np.array([1 << 16], np.uint32) % span
    mult = (mult * mult) % span
    off = (hi % span) * mult + (lo % span)       # wraps like lax.mul/add
    off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
