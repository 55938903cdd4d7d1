"""threefry2x32 keys and draws, bit-exact with ``jax.random``.

The reference threads ``jax.random`` keys through every step of the
round (party key schedules, server splits, RF bootstrap and feature
masks, Laplace noise).  This module reproduces the draws the round
makes, bit for bit, so whole rounds compare seed for seed:

  PRNGKey(seed)               -> (2,) uint32 key
  split(key, num)             -> (num, 2) uint32 keys
  bits(key, shape)            -> uint32 array
  uniform(key, shape, lo, hi) -> float32 array
  uniform_tensor(key, shape, lo, hi, device) -> the same, as a float32
                              tensor computed on ``device``
  randint(key, shape, lo, hi) -> int32 array
  fold_in(key, data)          -> (2,) uint32 key
  normal(key, shape)          -> float32 array (within 2.5e-7)
  normal_tensor(key, shape, device) -> the same, as a float32 tensor
                              computed on ``device``
  choice(key, n, shape, p)    -> int64 indices, with replacement

It follows JAX's ``jax_threefry_partitionable=True`` layout (the
default since JAX 0.5): element i of a shaped draw hashes the 64-bit
counter i split into (hi, lo) 32-bit words, and 32-bit draws are the
XOR of the two output words.  Keys are numpy arrays on the host; the
draws are numpy too and callers move them to their device.  ``bits``,
``uniform`` and ``choice`` also take a stack of keys (..., 2) and draw
under each, as ``jax.vmap`` of the draw would.  Everything
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
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
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


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    (0, data) under ``key``."""
    key = np.asarray(key, np.uint32)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.concatenate([b1, b2])


def bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` for uint32; a stack of keys
    (..., 2) gives (...,) + shape."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), hi, lo)
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


_M32 = 0xFFFFFFFF
_CHUNK = 1 << 25     # draws a pass of ``uniform_tensor`` (bounds scratch)


def _threefry_tensor(k1: int, k2: int, x1, x2):
    """``threefry2x32`` on int64 tensors holding uint32 values (torch has
    no wrapping uint32 arithmetic on every device): each sum and shift
    is masked back to 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def uniform_tensor(key, shape, minval=0.0, maxval=1.0, device="cpu"):
    """``uniform(key, shape, minval, maxval)`` bit for bit, computed on
    ``device`` in passes of ``_CHUNK`` draws: a vocabulary-sized draw
    (the token vote's noise, 410 M values at phi4-mini's 2 x 1024
    queries) takes seconds on the host and milliseconds on the card."""
    import torch
    key = np.asarray(key, np.uint32)
    k1, k2 = int(key[0]), int(key[1])
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    out = torch.empty((n,), dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        i = torch.arange(start, min(n, start + _CHUNK), dtype=torch.int64,
                         device=device)
        b1, b2 = _threefry_tensor(k1, k2, i >> 32, i & _M32)
        f = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32) \
            .view(torch.float32) - 1.0
        # as ``uniform``: one rounding of the exact float64 product-sum
        scaled = (f.double() * span + float(lo)).float()
        out[start:start + len(i)] = torch.clamp(scaled, min=float(lo))
    return out.reshape(shape)


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


# XLA's float32 erf_inv (Giles' single-precision polynomial): the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941],
                       np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` on (-1, 1).  Its Horner steps are fused
    multiply-adds (the exact float64 product and sum, rounded once) and
    log1p is rounded from float64; XLA's own log1p differs from that in
    the last bit now and then, so about 1 % of values differ in their
    last bits."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    w = w.astype(np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, c_lt, c_ge).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return p * x


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(u) of a
    uniform u in (-1, 1).  The uniform bits are exact; ``_erf_inv``
    leaves about 1 % of draws a few ulps (at most 2.5e-7 +
    1.2e-7 |x|) from the reference's."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * _erf_inv(u)


def _erf_inv_tensor(x):
    """``_erf_inv`` on a float32 tensor, step for step on its device:
    the same float32 and float64 operations, so the result equals
    ``_erf_inv``'s wherever the device's float64 log1p rounds as the
    host's (a float64 ulp moves a float32 rounding rarely)."""
    import torch
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float64, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float64, device=x.device)
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, lt5[0], ge5[0]).float()
    for c_lt, c_ge in zip(lt5[1:], ge5[1:]):
        p = (torch.where(lt, c_lt, c_ge) + p.double() * w).float()
    return p * x


def normal_tensor(key, shape, device="cpu"):
    """``normal(key, shape)`` computed on ``device`` in passes of
    ``_CHUNK`` draws: ``uniform_tensor``'s bits and ``_erf_inv_tensor``,
    so a draw of a billion values (a full-width model's init) takes
    seconds on the card where the host takes minutes."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_tensor(key, shape, lo, 1.0, device).reshape(-1)
    sqrt2 = float(np.float32(np.sqrt(2)))
    for start in range(0, u.numel(), _CHUNK):
        part = u[start:start + _CHUNK]
        part.copy_(sqrt2 * _erf_inv_tensor(part))
    return u.reshape(tuple(int(d) for d in shape))


def _cumsum16(p):
    """``jnp.cumsum`` of a float32 vector, bit for bit.  XLA sums in
    blocks of 16: a sequential float32 sum inside each block, the block
    totals scanned by the same rule, and each element its block's
    exclusive carry plus its in-block sum.  A sequential cumsum
    (``np.cumsum``) rounds otherwise in most entries, and ``choice``
    would then pick another row in about 5 % of draws."""
    p = np.asarray(p, np.float32)
    n = len(p)
    if n <= 16:
        return np.cumsum(p, dtype=np.float32)
    nb = -(-n // 16)
    blocks = np.zeros(nb * 16, np.float32)
    blocks[:n] = p
    inb = np.cumsum(blocks.reshape(nb, 16), axis=1, dtype=np.float32)
    carry = np.concatenate([np.zeros(1, np.float32),
                            _cumsum16(inb[:, -1])[:-1]])
    return (carry[:, None] + inb).reshape(-1)[:n]


def choice(key, n: int, shape, p) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=True, p=p)``: int64
    indices into range(n) drawn with probabilities ``p`` (float32,
    length n), bit for bit: the draw u is mapped to
    cumsum(p)[-1] * (1 - u) and found in cumsum(p) by a left-sided
    search.  A stack of keys (..., 2) gives (...,) + shape."""
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    cum = _cumsum16(p)
    r = cum[-1] * (np.float32(1.0) - uniform(key, shape))
    return np.searchsorted(cum, r, side="left").astype(np.int64)
