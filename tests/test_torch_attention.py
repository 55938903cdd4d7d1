"""The port's plain attention (on the CPU) against the JAX reference's:
its Pallas flash-attention kernel run in interpret mode, its oracle
``ref.attention_ref``, and its decode path ``_attention_xla`` with
scalar and per-row offsets.

Inputs are made from a seed with numpy and handed to both packages
(bfloat16 inputs are the same float32 draws rounded to nearest even in
both).  Tolerances are those of the reference's own kernel test
(``tests/test_kernels.py``): 2e-5 in float32, 2e-2 in bfloat16 — sums
run in another order, and in bfloat16 the probabilities are rounded
before P·V on the plain path but not in the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

ATT_SHAPES = [
    # B, Sq, Skv, H, KV, dh  (tests/test_kernels.py's shapes)
    (1, 128, 128, 4, 4, 64),
    (2, 256, 256, 4, 2, 64),     # GQA
    (2, 256, 256, 8, 1, 128),    # MQA
    (1, 384, 384, 2, 2, 128),    # non-pow2 seq (the reference pads)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shapes, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", ATT_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (96, 0.0), (0, 30.0)])
def test_plain_attention_matches_reference_kernel_and_oracle(
        shape, dtype, window, softcap):
    B, Sq, Skv, H, KV, dh = shape
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh)], jdt, tdt,
        Sq + H + dh)
    kw = dict(causal=True, window=window, softcap=softcap)
    want_kernel = jops.attention(jq, jk, jv, impl="kernel_interpret", **kw)
    want_oracle = jref.attention_ref(jq, jk, jv, **kw)
    before = fa.launches
    got = ops.attention(q, k, v, **kw)
    assert fa.launches == before            # a CPU tensor never launches
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want_kernel, tol)
    _close(got, want_oracle, tol)
    # the port's oracle is the reference's oracle
    _close(ref.attention_ref(q, k, v, **kw), want_oracle, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 30.0)])
def test_plain_decode_matches_reference_decode_path(dtype, window,
                                                    softcap):
    """One query row against a cache, at a scalar offset and at per-row
    offsets, against the reference's ``_attention_xla``."""
    B, Skv, H, KV, dh = 3, 40, 4, 2, 32
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, 1, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh)], jdt, tdt, 7)
    kw = dict(causal=True, window=window, softcap=softcap)
    offs = np.array([5, 39, 17], np.int32)
    want = jops.attention(jq, jk, jv, q_offset=jnp.asarray(offs),
                          impl="xla", **kw)
    got = ops.attention(q, k, v, q_offset=torch.from_numpy(offs), **kw)
    _close(got, want, tol)
    want_s = jops.attention(jq, jk, jv, q_offset=21, impl="xla", **kw)
    _close(ops.attention(q, k, v, q_offset=21, **kw), want_s, tol)


def test_per_row_offsets_need_one_query_row():
    q = torch.zeros((2, 4, 2, 32))
    k = torch.zeros((2, 8, 2, 32))
    with pytest.raises(NotImplementedError, match="single-token"):
        ops.attention(q, k, k, q_offset=torch.tensor([1, 2]))


def test_decode_row_equals_last_row_of_full_attention():
    """Decode (Sq=1 at q_offset=S-1) is the last row of a full causal
    attention, as in the reference's test_attention_decode_offset."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 96, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    full = ref.attention_ref(q, k, v, causal=True)
    one = ops.attention(q[:, -1:], k, v, causal=True, q_offset=95)
    torch.testing.assert_close(one[:, 0], full[:, -1], atol=1e-5, rtol=0)
