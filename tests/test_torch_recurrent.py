"""The port's recurrent serving path (RG-LRU and RWKV-6) against the JAX
reference, on the CPU.

  1. The plain recurrences (``ops.rglru``, ``ops.wkv`` on CPU tensors)
     against the reference's oracles ``ref.rglru_scan_ref`` /
     ``ref.wkv6_ref`` and its Pallas kernels run in interpret mode, at
     the shapes of ``tests/test_kernels.py``, in float32 and bfloat16.
  2. Decode steps (S == 1) chained over a sequence equal the scan.
  3. The blocks (``rglru_apply``, ``rwkv_time_mix``,
     ``rwkv_channel_mix``) with the reference's parameters carried
     across, in modes train, prefill and decode, states compared.
  4. ``serve_batch`` streams of the recurrentgemma and rwkv6 smokes
     against the reference's ``serve_batch``, in float32.

Inputs are made from a numpy seed and handed to both packages (bfloat16
inputs are the same float32 draws rounded to nearest even in both).
Tolerances: the recurrences are held at the reference's kernel-test
tolerances (RG-LRU 1e-4 float32, 3e-2 bfloat16; WKV 1e-4 float32, 5e-2
bfloat16): the reference's interpret-mode kernel and oracle compute the
same steps, but its model path on the CPU takes an associative scan
(RG-LRU) and sums the WKV output in another order.  Block outputs and
states are within 1e-5 absolute in float32 (the same float32 arithmetic,
summed in another order); streams follow ``serving.compare_stream`` with
logits within 1e-5 of the largest.  The TPU kernel's h_last is in x's
dtype, the port's in float32 like the reference's other paths (ROADMAP
§3): in bfloat16 the kernel's h_last is compared at the bfloat16
tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro.serving import serve_batch as jserve_batch
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.serving import compare_stream, serve_batch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
WKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STATE_ATOL = 1e-5
RTOL = 1e-5


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _pair(arrs, dtype):
    """The same float32 numpy draws as JAX and torch arrays of
    ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# 1. the recurrences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,D", [(1, 256, 256), (2, 512, 256),
                                   (2, 128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_matches_reference(B, S, D, dtype):
    rng = np.random.default_rng(S + D)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((B, S, D)).astype(np.float32)) * 0.1
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    (jx, ja), (tx, ta) = _pair([x, log_a], dtype)
    h, hl = ops.rglru(tx, ta, torch.from_numpy(h0))
    assert h.dtype == tx.dtype and hl.dtype == torch.float32
    tol = RGLRU_TOL[dtype]
    want_h, want_hl = jref.rglru_scan_ref(jx, ja, jnp.asarray(h0))
    _close(h, want_h, tol)
    _close(hl, want_hl, tol)
    k_h, k_hl = jops.rglru(jx, ja, jnp.asarray(h0), impl="kernel_interpret")
    _close(h, k_h, tol)
    _close(hl, k_hl, tol)
    assert k_hl.dtype == jx.dtype      # the TPU kernel's h_last dtype


@pytest.mark.parametrize("B,S,H,dh", [(1, 256, 2, 64), (2, 128, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_plain_matches_reference(B, S, H, dh, dtype):
    rng = np.random.default_rng(S + H)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) * 0.5
               for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal((B, S, H, dh))))
    u = rng.standard_normal((H, dh)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.1
    jin, tin = _pair([r, k, v, w.astype(np.float32)], dtype)
    o, s = ops.wkv(*tin, torch.from_numpy(u), torch.from_numpy(s0))
    assert o.dtype == tin[0].dtype and s.dtype == torch.float32
    tol = WKV_TOL[dtype]
    want_o, want_s = jref.wkv6_ref(*jin, jnp.asarray(u), jnp.asarray(s0))
    _close(o, want_o, tol)
    _close(s, want_s, tol)
    k_o, k_s = jops.wkv(*jin, jnp.asarray(u), jnp.asarray(s0),
                        impl="kernel_interpret")
    _close(o, k_o, tol)
    _close(s, k_s, tol)


# ---------------------------------------------------------------------------
# 2. decode steps
# ---------------------------------------------------------------------------
def test_decode_steps_chain_to_the_scan():
    """S == 1 steps carried state to state equal the scan, for both
    recurrences, and equal the reference's own decode steps."""
    rng = np.random.default_rng(5)
    B, S, D, H = 2, 9, 48, 2
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    a = torch.from_numpy(
        -np.abs(rng.standard_normal((B, S, D))).astype(np.float32) * 0.2)
    h_all, hl_all = ops.rglru(x, a)
    hl = None
    for t in range(S):
        xt, at = x[:, t:t + 1], a[:, t:t + 1]
        jh, jhl = jops.rglru(jnp.asarray(xt.numpy()), jnp.asarray(at.numpy()),
                             None if hl is None else jnp.asarray(hl.numpy()))
        ht, hl = ops.rglru(xt, at, hl)
        torch.testing.assert_close(ht[:, 0], h_all[:, t], atol=1e-6,
                                   rtol=1e-6)
        _close(ht, jh, 1e-6)
        _close(hl, jhl, 1e-6)
    torch.testing.assert_close(hl, hl_all, atol=1e-6, rtol=1e-6)

    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, 64))
                                .astype(np.float32) * 0.4) for _ in range(3))
    w = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((B, S, H, 64)).astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((H, 64)).astype(np.float32))
    o_all, s_all = ops.wkv(r, k, v, w, u * 0.1)
    s = None
    for t in range(S):
        sl = slice(t, t + 1)
        ot, s_new = ops.wkv(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u * 0.1,
                            s)
        torch.testing.assert_close(ot[:, 0], o_all[:, t], atol=1e-5,
                                   rtol=1e-5)
        jo, js = jops.wkv(*(jnp.asarray(t_[:, sl].numpy())
                            for t_ in (r, k, v, w)),
                          jnp.asarray((u * 0.1).numpy()),
                          None if s is None else jnp.asarray(s.numpy()))
        _close(ot, jo, 1e-5)
        _close(s_new, js, 1e-5)
        s = s_new
    torch.testing.assert_close(s, s_all, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 3. the blocks, with the reference's parameters
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["recurrentgemma-2b", "rwkv6-7b"])
def block_pair(request):
    """(cfg, the reference's first-layer block params, the port's first
    block) for the smoke config in float32."""
    jcfg, jm = smoke_model(request.param, dtype="float32",
                           param_dtype="float32")
    jp = jm.init(jax.random.PRNGKey(1))
    cfg = port_config(jcfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    jblock = jax.tree.map(lambda a: a[0], jp["periods"]["b0"])
    return jcfg, cfg, jblock, params.blocks[0]


def _close_state(got, want):
    assert set(got) == set(want)
    for n in want:
        g, w = got[n], np.asarray(want[n])
        assert tuple(g.shape) == w.shape, n
        assert str(g.dtype).split(".")[-1] == str(w.dtype), n
        _close(g, w, STATE_ATOL)


def _block_fns(jcfg, cfg, jblock, block):
    """(reference fn, port fn), each (x, mode, state) -> (y, state)."""
    if cfg.pattern[0] == "rglru":
        def jfn(x, mode, st):
            return jrglru.rglru_apply(jcfg, jblock["rglru"], x, mode=mode,
                                      state=st)

        def pfn(x, mode, st):
            return rglru_mod.rglru_apply(cfg, block.rglru, x, mode=mode,
                                         state=st)
        return jfn, pfn

    def jfn(x, mode, st):
        y, s = jrwkv.rwkv_time_mix(jcfg, jblock["tm"], x, state=st)
        y2, sc = jrwkv.rwkv_channel_mix(jcfg, jblock["tm"], y, state=st)
        return y2, (None if st is None else dict(s, shift_c=sc))

    def pfn(x, mode, st):
        y, s = rwkv_mod.rwkv_time_mix(cfg, block.tm, x, state=st)
        y2, sc = rwkv_mod.rwkv_channel_mix(cfg, block.tm, y, state=st)
        return y2, (None if st is None else dict(s, shift_c=sc))
    return jfn, pfn


def test_blocks_match_in_train_prefill_and_decode(block_pair):
    jcfg, cfg, jblock, block = block_pair
    jfn, pfn = _block_fns(jcfg, cfg, jblock, block)
    rng = np.random.default_rng(2)
    B, S = 2, 40
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    init = (jrglru.init_rglru_state if cfg.pattern[0] == "rglru"
            else jrwkv.init_rwkv_state)(jcfg, B, jnp.float32)
    pinit = (rglru_mod.init_rglru_state if cfg.pattern[0] == "rglru"
             else rwkv_mod.init_rwkv_state)(cfg, B, torch.float32, "cpu")
    with torch.inference_mode():
        # train: no state
        jy, _ = jfn(jnp.asarray(x), "train", None)
        py, pst = pfn(torch.from_numpy(x), "train", None)
        _close(py, jy, STATE_ATOL)
        # prefill from the zero state, then decode steps
        jy, jst = jfn(jnp.asarray(x[:, :S - 4]), "prefill", init)
        py, pst = pfn(torch.from_numpy(x[:, :S - 4]), "prefill", pinit)
        _close(py, jy, STATE_ATOL)
        _close_state(pst, jst)
        for t in range(S - 4, S):
            xt = x[:, t:t + 1]
            jy, jst = jfn(jnp.asarray(xt), "decode", jst)
            py, pst = pfn(torch.from_numpy(xt), "decode", pst)
            _close(py, jy, STATE_ATOL)
            _close_state(pst, jst)


# ---------------------------------------------------------------------------
# 4. serve_batch against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,P", [("recurrentgemma-2b", 100),
                                    ("rwkv6-7b", 40)])
def test_serve_batch_matches_reference(arch, P):
    """Fixed-batch serving of the smoke in float32 (recurrentgemma's
    prompts cross its 64-key window): the streams against the
    reference's, under the parity rule, with the reference's logits
    from one full forward over prompt and tokens; and the port's
    prefill(P) + decode steps against its own prefill(P + n)."""
    jcfg, jm = smoke_model(arch, dtype="float32", param_dtype="float32")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    model = Model(cfg)
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    gen = 8
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, P)).astype(np.int32)
    toks, stats = serve_batch(model, params, prompts, gen, verbose=False,
                              keep_logits=True)
    jtoks, _ = jserve_batch(jm, jp, prompts, gen, verbose=False)
    jtoks = np.asarray(jtoks)
    for i in range(3):
        seq = np.concatenate([prompts[i], jtoks[i, :-1]])
        jl, _ = jm.logits(jp, {"tokens": jnp.asarray(seq[None])})
        jl = np.array(jl[0, P - 1:])
        info = compare_stream(toks[i].tolist(), stats["logits"][i],
                              jtoks[i].tolist(), jl)
        assert info["explained"], info
        assert info["max_diff"] <= RTOL * np.abs(jl).max(), info
    with torch.inference_mode():
        lg, _ = model.logits(params, {"tokens": torch.from_numpy(
            np.concatenate([prompts, toks[:, :gen - 1]], axis=1))},
            mode="prefill")
    scale = float(stats["logits"].abs().max())
    torch.testing.assert_close(lg[:, -1], stats["logits"][:, gen - 1],
                               atol=RTOL * scale, rtol=0)
