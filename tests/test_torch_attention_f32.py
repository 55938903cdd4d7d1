"""The arithmetic of the float32 attention kernels (K3's and N1's split
TF32 on the tensor cores) against the JAX reference on the CPU.

``ref.attention_split_tf32_plain`` and
``ref.attention_backward_split_tf32_plain`` state what the card's
float32 kernels compute: every float32 operand of a product as two TF32
terms, big = rna(x) and small = rna(x - big) (``ref.tf32_rna``: the
int32 view's ``(bits + 0x1000) & 0xFFFFE000``, as ``cvt.rna.tf32.f32``
rounds), and each product as small·big + big·small + big·big.  They are
held to the reference's float32 ``_attention_xla``
(``repro/kernels/ops.py:97``) and to ``jax.vjp`` of it, at smoke widths:
head dims 32, 80 and 256, causal, sliding windows, soft-caps, GQA and
MQA, and non-causal cross attention over Sq != Skv.

Tolerances: the float32 bars the card's kernels are held to, the output
within 2e-5 and the row log-sum-exp within 1e-5 of the plain float32
version's, each gradient within 1e-5 of its largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

# label, B, Sq, Skv, H, KV, dh, causal, window, softcap
CASES = [
    ("dh32_gqa_causal", 2, 40, 40, 4, 2, 32, True, 0, 0.0),
    ("dh32_window_cap", 2, 70, 70, 4, 2, 32, True, 16, 30.0),
    ("dh80_mha_causal", 2, 70, 70, 4, 4, 80, True, 0, 0.0),
    ("dh80_window", 1, 90, 90, 4, 4, 80, True, 24, 0.0),
    ("dh256_mqa_window", 2, 70, 70, 5, 1, 256, True, 32, 0.0),
    ("dh256_cap", 1, 40, 40, 2, 1, 256, True, 0, 50.0),
    ("cross_dh32", 2, 24, 100, 4, 2, 32, False, 0, 0.0),
    ("cross_dh80", 2, 17, 65, 4, 4, 80, False, 0, 0.0),
    ("cross_dh256", 1, 9, 40, 2, 1, 256, False, 0, 0.0)]


def test_tf32_rounding_is_cvt_rna():
    """``ref.tf32_rna`` keeps 10 mantissa bits, rounding to nearest with
    ties away from zero, on either sign; big + small holds a float32
    value to about 2^-22 of it."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11), 1 + 2 ** -12, 3.14159265, 0.0])
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
            3.140625, 0.0]
    assert ref.tf32_rna(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=10_000).astype(np.float32))
    big = ref.tf32_rna(y)
    assert torch.equal(big.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(big.view(torch.int32)))
    small = ref.tf32_rna(y - big)
    assert float(((big + small) - y).abs().max()) <= \
        2 ** -21 * float(y.abs().max())


@pytest.mark.parametrize(
    "label,B,Sq,Skv,H,KV,dh,causal,window,softcap", CASES,
    ids=[c[0] for c in CASES])
def test_split_tf32_attention_matches_reference(label, B, Sq, Skv, H, KV,
                                                dh, causal, window,
                                                softcap):
    rng = np.random.default_rng(Sq * 7 + Skv + dh)
    q, do = (rng.normal(size=(B, Sq, H, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, KV, dh)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)

    def jatt(q, k, v):
        return jops._attention_xla(q, k, v, q_offset=0, block_q=512, **kw)

    jo, vjp = jax.vjp(jatt, *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = ref.attention_split_tf32_plain(tq, tk, tv, return_lse=True,
                                            **kw)
    assert o.dtype == torch.float32 and o.shape == (B, Sq, H, dh)
    assert float(np.abs(o.numpy() - np.asarray(jo)).max()) <= 2e-5
    _, want_lse = ref.attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    got = ref.attention_backward_split_tf32_plain(tq, tk, tv, o, tdo, lse,
                                                  **kw)
    for name, a, j in zip(("dq", "dk", "dv"), got, jgrads):
        j = np.asarray(j)
        assert a.shape == j.shape, name
        assert float(np.abs(a.numpy() - j).max()) <= \
            1e-5 * float(np.abs(j).max()), name
