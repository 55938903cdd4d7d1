"""The plain backwards of the recurrences (``ref.rglru_scan_backward_plain``,
``ref.wkv6_backward_plain``, and ``ref.wkv6_backward_chunked_plain``, the
chunked algebra of the card's WKV backward) on the CPU against two
references:

  - ``jax.vjp`` of the reference's xla recurrences
    (``repro.kernels.ops.rglru`` and ``ops.wkv`` with ``impl="xla"``), the
    path the reference trains recurrentgemma and rwkv6 through off the
    TPU;
  - ``torch.autograd.grad`` of the port's plain forwards
    (``ref.rglru_scan_ref``, ``ref.wkv6_ref``).

The card's backward kernels (N2a, N2b) are held to these plain versions
in ``tests/test_torch_cuda_lm.py`` and ``chip_smoke.py``.

Inputs come from numpy seeds.  Tolerances, of each output's largest
|gradient| (as the attention backward is held in test_torch_lm_model):
  - float32: 1e-5 (the same float32 arithmetic summed in another order);
  - bfloat16: 1e-5 + 2^-7.  Both sides compute in float32 from the same
    bf16 inputs and round the gradients to bf16 once at the end; two
    float32 values within 1e-5 of the largest can round to neighbouring
    bf16 values, at most one bf16 ulp apart, and an ulp of a value no
    larger than the largest |gradient| is at most 2^-7 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5 + 2.0 ** -7}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]


def _t(a, dtype):
    """numpy float32 -> torch tensor of ``dtype`` (rounded once)."""
    return torch.from_numpy(a).to(dtype)


def _j(t):
    """A torch tensor -> a jax array of the same dtype and bits."""
    return jnp.asarray(t.float().numpy()).astype(JDT[t.dtype])


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, name):
    got = got.float().numpy() if torch.is_tensor(got) else _np(got)
    want = want.float().numpy() if torch.is_tensor(want) else _np(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


# (B, S, D, nonzero h0, with dh_last)
RGLRU_CASES = [(2, 16, 24, False, False), (2, 33, 40, True, True),
               (3, 100, 16, True, False), (1, 7, 8, False, True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,S,D,h0_on,last_on", RGLRU_CASES)
def test_rglru_backward_plain(dtype, B, S, D, h0_on, last_on):
    rng = np.random.default_rng(S * 7 + D)
    x = _t(rng.normal(size=(B, S, D)).astype(np.float32), dtype)
    # decays spanning a = exp(log_a) in (0.02, 1)
    la = _t(-rng.uniform(0.0, 4.0, (B, S, D)).astype(np.float32), dtype)
    h0 = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)) \
        if h0_on else torch.zeros((B, D))
    dh = _t(rng.normal(size=(B, S, D)).astype(np.float32), dtype)
    dh_last = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)) \
        if last_on else None
    got = ref.rglru_scan_backward_plain(x, la, h0, dh, dh_last)
    assert [g.dtype for g in got] == [dtype, dtype, torch.float32]
    # autograd of the port's plain forward
    leaves = [t.clone().requires_grad_(True) for t in (x, la, h0)]
    h, hl = ref.rglru_scan_ref(*leaves)
    auto = torch.autograd.grad(
        (h, hl), leaves,
        (dh, dh_last if last_on else torch.zeros_like(hl)))
    # jax.vjp of the reference's xla scan
    _, vjp = jax.vjp(lambda a, b, c: jops.rglru(a, b, c, impl="xla"),
                     _j(x), _j(la), _j(h0))
    jgrads = vjp((_j(dh), _j(dh_last if last_on else torch.zeros((B, D)))))
    for name, g, a, j in zip(("dx", "dlog_a", "dh0"), got, auto, jgrads):
        _close(g, a, TOL[dtype], f"{name} vs autograd")
        _close(g, j, TOL[dtype], f"{name} vs jax.vjp")


# (B, S, H, dh, nonzero s0, with ds_last); S 100 and 200 are ragged
# against the reference's 128-step chunks (one short chunk; the
# unchunked step loop)
WKV_CASES = [(2, 12, 2, 8, False, False), (1, 100, 2, 16, True, True),
             (2, 200, 1, 8, True, False), (1, 9, 3, 8, False, True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,S,H,dh,s0_on,last_on", WKV_CASES)
def test_wkv6_backward_plain(dtype, B, S, H, dh, s0_on, last_on):
    rng = np.random.default_rng(S * 11 + dh)
    r, k, v = (_t(rng.normal(size=(B, S, H, dh)).astype(np.float32), dtype)
               for _ in range(3))
    w = _t(rng.uniform(0.05, 0.999, (B, S, H, dh)).astype(np.float32),
           dtype)
    u = torch.from_numpy(rng.normal(size=(H, dh)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(B, H, dh, dh)).astype(
        np.float32)) if s0_on else torch.zeros((B, H, dh, dh))
    do = _t(rng.normal(size=(B, S, H, dh)).astype(np.float32), dtype)
    ds_last = torch.from_numpy(rng.normal(size=(B, H, dh, dh)).astype(
        np.float32)) if last_on else None
    got = ref.wkv6_backward_plain(r, k, v, w, u, s0, do, ds_last)
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 2
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    o, sl = ref.wkv6_ref(*leaves)
    auto = torch.autograd.grad(
        (o, sl), leaves, (do, ds_last if last_on else torch.zeros_like(sl)))
    _, vjp = jax.vjp(lambda *a: jops.wkv(*a, impl="xla"),
                     *(_j(t) for t in (r, k, v, w, u, s0)))
    jgrads = vjp((_j(do), _j(ds_last if last_on
                             else torch.zeros((B, H, dh, dh)))))
    for name, g, a, j in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                             auto, jgrads):
        _close(g, a, TOL[dtype], f"{name} vs autograd")
        _close(g, j, TOL[dtype], f"{name} vs jax.vjp")


# (B, S, H, dh, chunk, decay range, nonzero s0, with ds_last): chunks of
# 4, 8, 16 and 32; S ragged against the chunk, shorter than one, a single
# step; decays near 0 (some exactly 0) and near 1
CHUNKED_CASES = [(2, 12, 2, 8, 4, (0.05, 0.999), False, False),
                 (1, 37, 2, 16, 16, (0.05, 0.999), True, True),
                 (1, 40, 1, 8, 16, (0.0, 1e-3), True, False),
                 (1, 33, 2, 8, 8, (0.99, 1.0), False, True),
                 (2, 5, 1, 8, 16, (0.1, 0.9), True, True),
                 (1, 1, 2, 8, 16, (0.1, 0.9), True, True),
                 (1, 70, 1, 8, 32, (0.5, 1.0), True, True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,S,H,dh,chunk,decays,s0_on,last_on",
                         CHUNKED_CASES)
def test_wkv6_backward_chunked_plain(dtype, B, S, H, dh, chunk, decays,
                                     s0_on, last_on):
    """The chunked algebra (chunk-boundary chains, inter-chunk products
    scaled by prefix and suffix decays, intra-chunk terms by running
    products, no division) equals the step-by-step plain backward and
    ``jax.vjp`` of the reference's xla recurrence."""
    rng = np.random.default_rng(S * 13 + chunk)
    r, k, v = (_t(rng.normal(size=(B, S, H, dh)).astype(np.float32), dtype)
               for _ in range(3))
    w = rng.uniform(*decays, (B, S, H, dh)).astype(np.float32)
    if decays[0] == 0.0:
        w[:, ::3, :, ::2] = 0.0
    w = _t(w, dtype)
    u = torch.from_numpy(rng.normal(size=(H, dh)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(B, H, dh, dh)).astype(
        np.float32)) if s0_on else torch.zeros((B, H, dh, dh))
    do = _t(rng.normal(size=(B, S, H, dh)).astype(np.float32), dtype)
    ds_last = torch.from_numpy(rng.normal(size=(B, H, dh, dh)).astype(
        np.float32)) if last_on else None
    got = ref.wkv6_backward_chunked_plain(r, k, v, w, u, s0, do, ds_last,
                                          chunk=chunk)
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 2
    want = ref.wkv6_backward_plain(r, k, v, w, u, s0, do, ds_last)
    _, vjp = jax.vjp(lambda *a: jops.wkv(*a, impl="xla"),
                     *(_j(t) for t in (r, k, v, w, u, s0)))
    jgrads = vjp((_j(do), _j(ds_last if last_on
                             else torch.zeros((B, H, dh, dh)))))
    for name, g, p, j in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                             want, jgrads):
        assert g.shape == p.shape, name
        _close(g, p, TOL[dtype], f"{name} vs the step-by-step plain")
        _close(g, j, TOL[dtype], f"{name} vs jax.vjp")


def test_plain_backwards_accept_no_upstream_state_gradient():
    """dh_last / ds_last None equals passing zeros, bit for bit."""
    rng = np.random.default_rng(5)
    x, la, dh = (torch.from_numpy(rng.normal(size=(2, 10, 8)).astype(
        np.float32)) for _ in range(3))
    la = -la.abs()
    h0 = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    a = ref.rglru_scan_backward_plain(x, la, h0, dh)
    b = ref.rglru_scan_backward_plain(x, la, h0, dh, torch.zeros(2, 8))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    r, k, v, do = (torch.from_numpy(rng.normal(size=(1, 6, 2, 4)).astype(
        np.float32)) for _ in range(4))
    w = torch.sigmoid(r)
    u, s0 = torch.randn(2, 4), torch.randn(1, 2, 4, 4)
    a = ref.wkv6_backward_plain(r, k, v, w, u, s0, do)
    b = ref.wkv6_backward_plain(r, k, v, w, u, s0, do,
                                torch.zeros(1, 2, 4, 4))
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_ops_recurrences_on_cpu_run_the_plain_forwards_under_grad():
    """On the CPU ``ops.rglru`` / ``ops.wkv`` take the plain forwards, so
    their autograd gradients are the plain backwards' (within float32's
    reordering)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    la = torch.from_numpy(-rng.uniform(0, 3, (2, 12, 8)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(2, 12, 8)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, la)]
    h, _ = ops.rglru(*leaves)
    auto = torch.autograd.grad(h, leaves, dh)
    plain = ref.rglru_scan_backward_plain(x, la, None, dh)
    for a, p in zip(auto, plain):
        _close(p, a, 1e-5, "ops.rglru")
