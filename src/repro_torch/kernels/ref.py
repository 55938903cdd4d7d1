"""Plain PyTorch versions of the kernels.

These are the semantic ground truth beside each hand-written kernel:
small, obviously correct, memory-naive.  ``ops.py`` runs them for
tensors on the CPU; on the card the kernels run, and ``chip_smoke.py``
and the card-only tests hold each kernel against its plain version on
the same inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Attention  (model layout: q (B, Sq, H, dh), k/v (B, Skv, KV, dh))
# ---------------------------------------------------------------------------
def _mask(qpos, Skv, causal, window, device):
    """(..., Sq, Skv) bool: which keys each query row may attend."""
    kpos = torch.arange(Skv, device=device)
    m = torch.ones(qpos.shape + (Skv,), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos[..., None]
    if window > 0:
        m &= kpos > qpos[..., None] - window
    return m


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  q_offset=0):
    """Naive softmax attention oracle (``repro.kernels.ref.attention_ref``).

    q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) with H % KV == 0.
    ``q_offset`` is the absolute position of q[:, 0] (an int).
    ``window``: sliding window size (0 = unbounded).  Everything in
    float32; returns (B, Sq, H, dh) in q.dtype.
    """
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float() * dh ** -0.5
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    mask = _mask(qpos, Skv, causal, window, q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, return_lse=False):
    """The counterpart of the reference's ``_attention_xla``
    (``repro/kernels/ops.py:97``): the path that every decode step takes
    on the card and every attention call takes on the CPU.

    ``q_offset`` is an int, or a (B,) integer tensor of per-row offsets
    (continuous-batching decode, Sq == 1).  Scores, softmax and the
    P·V sums are float32; the probabilities are rounded to v's dtype
    before P·V, as the reference does.  GQA folds the group into the
    head axis without repeating k and v.  (The reference's q-chunking
    only bounds memory: each query row's softmax is its own.)
    ``return_lse`` also returns each row's float32 log-sum-exp of its
    scaled, soft-capped, masked scores, (B, H, Sq): the flash kernel's
    second output.
    """
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, Sq, KV, g, dh) * dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())  # (B,KV,g,Sq,Skv)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    base = torch.as_tensor(q_offset, device=q.device)
    qpos = base[..., None] + torch.arange(Sq, device=q.device)
    m = _mask(qpos, Skv, causal, window, q.device)
    m = m[:, None, None] if m.dim() == 3 else m[None, None, None]
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, Sq, H, dh).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def attention_backward_plain(q, k, v, o, do, lse, *, causal=True, window=0,
                             softcap=0.0):
    """The textbook gradients (dq, dk, dv) of attention at q_offset 0,
    given its output ``o``, its row log-sum-exp ``lse`` (B, H, Sq) and
    the output's gradient ``do``: the plain version of the hand-written
    backward (``flash_attention.flash_attention_backward``).  With s the
    scaled, soft-capped scores: P = exp(s - lse) (0 where masked), dV =
    P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D) (1 - (s/c)^2),
    dQ = dS K * scale, dK = dS^T Q * scale, the group's q heads summed
    into their kv head.  q, o, do (B, Sq, H, dh) and k, v (B, Skv, KV,
    dh): Sq may differ from Skv (an encoder-decoder's cross attention,
    non-causal).  float32 throughout; results in q's and k's dtypes."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = dh ** -0.5
    qf = q.float().reshape(B, Sq, KV, g, dh)
    kf, vf = k.float(), v.float()
    gf = do.float().reshape(B, Sq, KV, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    m = _mask(torch.arange(Sq, device=q.device), Skv, causal, window,
              q.device)[None, None, None]
    p = torch.where(m, torch.exp(s - lse.float().reshape(B, KV, g, Sq, 1)),
                    torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, gf)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gf, vf)
    d_rows = (do.float() * o.float()).sum(-1).reshape(B, Sq, KV, g)
    ds = p * (dp - d_rows.permute(0, 2, 3, 1)[..., None])
    if softcap > 0:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, Sq, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def tf32_rna(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it:
    to nearest, ties away from zero, 10 mantissa bits, the low 13 bits
    of the float32 pattern zero: ``(bits + 0x1000) & 0xFFFFE000`` on
    the int32 view (sign and magnitude, so adding half a TF32 ulp and
    truncating rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_einsum(eq, a, b):
    """``torch.einsum(eq, a, b)`` of float32 operands as the split-TF32
    kernels take it (``csrc/hopper.cuh: mma_split``): each operand is
    big = tf32(x) plus small = tf32(x - big), and the product is
    small·big + big·small + big·big, each term's products exact and
    summed in float32; small·small (about 2^-22 of a term) is dropped."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def attention_split_tf32_plain(q, k, v, *, causal=True, window=0,
                               softcap=0.0, q_offset=0, return_lse=False):
    """float32 attention in the arithmetic of K3's float32 kernel
    (``csrc/flash_attention.cu``: flash_attention_tf32): ``attention_plain``
    with Q K^T and P·V as split-TF32 products (``split_tf32_einsum``),
    the scale applied to the raw scores.  float32 inputs; returns o and,
    with ``return_lse``, the (B, H, Sq) row log-sum-exp."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    s = split_tf32_einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, g, dh),
                          k) * dh ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = _mask(qpos, Skv, causal, window, q.device)[None, None, None]
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = split_tf32_einsum("bkgqs,bskd->bqkgd", p, v).reshape(B, Sq, H, dh)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def attention_backward_split_tf32_plain(q, k, v, o, do, lse, *, causal=True,
                                        window=0, softcap=0.0):
    """``attention_backward_plain`` in the arithmetic of N1's float32
    kernels (``csrc/flash_attention_bwd.cu``: bwd_dkdv_tf32, bwd_dq_tf32):
    S, dP, dV, dK and dQ as split-TF32 products (``split_tf32_einsum``),
    P, D and dS in float32.  float32 inputs and outputs."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = dh ** -0.5
    qf = q.reshape(B, Sq, KV, g, dh)
    gf = do.reshape(B, Sq, KV, g, dh)
    s = split_tf32_einsum("bqkgd,bskd->bkgqs", qf, k) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    m = _mask(torch.arange(Sq, device=q.device), Skv, causal, window,
              q.device)[None, None, None]
    p = torch.where(m, torch.exp(s - lse.reshape(B, KV, g, Sq, 1)),
                    torch.zeros_like(s))
    dv = split_tf32_einsum("bkgqs,bqkgd->bskd", p, gf)
    dp = split_tf32_einsum("bqkgd,bskd->bkgqs", gf, v)
    d_rows = (do * o).sum(-1).reshape(B, Sq, KV, g)
    ds = p * (dp - d_rows.permute(0, 2, 3, 1)[..., None])
    if softcap > 0:
        ds = ds * (1 - t * t)
    dq = split_tf32_einsum("bkgqs,bskd->bqkgd", ds, k) * scale
    dk = split_tf32_einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return dq.reshape(B, Sq, H, dh), dk, dv


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------
def rglru_scan_ref(x, log_a, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + x_t, scanned over axis 1 in order
    with a float32 carry (``repro.kernels.ref.rglru_scan_ref``).

    x, log_a: (B, S, D) (x already carries the block's sqrt(1 - a^2)
    input gate); h0: (B, D) float32 or None (zeros).  Returns (h (B, S,
    D) in x's dtype, h_last (B, D) float32).  With S == 1 this is the
    decode step, which the reference also computes outside its kernel.
    """
    B, S, D = x.shape
    xf, af = x.float(), log_a.float()
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = torch.exp(af[:, t]) * h + xf[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def rglru_scan_backward_plain(x, log_a, h0, dh, dh_last=None):
    """The gradients (dx, dlog_a, dh0) of ``rglru_scan_ref(x, log_a, h0)``
    given the gradients ``dh`` of h (x's dtype) and ``dh_last`` of h_last
    (float32, or None for zeros), step by step in float32.

    With a_t = exp(log_a_t) and h_{-1} = h0, the float32 carry is
    rebuilt as the forward builds it; then, walking back from
    g_{S-1} = dh_{S-1} + dh_last:

        dx_t = g_t;   dlog_a_t = (g_t a_t) h_{t-1};
        g_{t-1} = dh_{t-1} + a_t g_t;   dh0 = a_0 g_0

    each product and sum rounded on its own (the order K4's backward
    kernel keeps, so that it equals this bit for bit on the card).
    Returns dx and dlog_a in x's and log_a's dtypes, dh0 float32."""
    B, S, D = x.shape
    xf, af, dhf = x.float(), log_a.float(), dh.float()
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    prev = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        prev[:, t] = h
        h = torch.exp(af[:, t]) * h + xf[:, t]
    g = dhf[:, S - 1] if dh_last is None else dhf[:, S - 1] + dh_last.float()
    dx = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    dla = torch.empty_like(dx)
    for t in range(S - 1, -1, -1):
        a = torch.exp(af[:, t])
        dx[:, t] = g
        dla[:, t] = g * a * prev[:, t]
        g = dhf[:, t - 1] + a * g if t else a * g
    return dx.to(x.dtype), dla.to(log_a.dtype), g


# ---------------------------------------------------------------------------
# RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------
def wkv6_ref(r, k, v, w, u, s0=None):
    """The RWKV-6 token-mixing recurrence, step by step in float32
    (``repro.kernels.ref.wkv6_ref``).

    r, k, v, w: (B, S, H, dh), the model layout; w is the per-step decay
    in (0, 1); u: (H, dh); s0: (B, H, dh_k, dh_v) float32 or None
    (zeros).  Per head and step:

        o_t = r_t . (s + (u * k_t) v_t^T);   s <- w_t[:, None] * s + k_t v_t^T

    Returns (o (B, S, H, dh) in r's dtype, s_last (B, H, dh, dh)
    float32).  With S == 1 this is the decode step."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., None]                              # (H, dh, 1)
    s = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    o = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, dh, dh)
        o[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    return o.to(r.dtype), s


def wkv6_backward_plain(r, k, v, w, u, s0, do, ds_last=None):
    """The gradients (dr, dk, dv, dw, du, ds0) of ``wkv6_ref(r, k, v, w,
    u, s0)`` given the gradients ``do`` of o and ``ds_last`` of s_last
    (float32, or None for zeros), step by step in float32.

    With S_t the state after step t (S_{-1} = s0), G_t = dL/dS_t
    (G_{S-1} = ds_last) and, per head, i over the key and j over the
    value dimension:

        dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
        dk_t = G_t v_t + u * r_t (v_t . do_t)
        dv_t = G_t^T k_t + (sum_i r_t u k_t) do_t
        dw_t = rowsum(G_t * S_{t-1})
        G_{t-1} = diag(w_t) G_t + r_t do_t^T;   ds0 = G_{-1}
        du = sum over b and t of r_t * k_t (v_t . do_t)

    The forward states are rebuilt from s0 as ``wkv6_ref`` builds them
    (never from S_t by dividing by w_t).  Returns dr, dk, dv, dw in the
    inputs' dtype, du in u's, ds0 float32."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf, gf = (t.float() for t in (r, k, v, w, do))
    uf = u.float()                                         # (H, dh)
    s = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    prev = torch.empty((B, S, H, dh, dh), dtype=torch.float32,
                       device=r.device)
    for t in range(S):
        prev[:, t] = s
        s = wf[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :,
                                                                  None, :]
    G = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if ds_last is None else ds_last.float().clone())
    vdo = (vf * gf).sum(-1, keepdim=True)                  # (B, S, H, 1)
    beta = (rf * uf * kf).sum(-1, keepdim=True)            # (B, S, H, 1)
    grads = [torch.empty((B, S, H, dh), dtype=torch.float32,
                         device=r.device) for _ in range(4)]
    dr, dk, dv, dw = grads
    for t in range(S - 1, -1, -1):
        sp = prev[:, t]
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", sp, gf[:, t])
                    + uf * kf[:, t] * vdo[:, t])
        dk[:, t] = (torch.einsum("bhij,bhj->bhi", G, vf[:, t])
                    + uf * rf[:, t] * vdo[:, t])
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, kf[:, t])
                    + beta[:, t] * gf[:, t])
        dw[:, t] = (G * sp).sum(-1)
        G = wf[:, t, :, :, None] * G + rf[:, t, :, :, None] * gf[:, t, :,
                                                                 None, :]
    du = (rf * kf * vdo).sum((0, 1))
    return (*(x.to(r.dtype) for x in grads), du.to(u.dtype), G)


def wkv6_backward_chunked_plain(r, k, v, w, u, s0, do, ds_last=None,
                                chunk=16):
    """``wkv6_backward_plain``'s gradients by the chunked algebra of the
    card's backward (``csrc/wkv6_bwd.cu``), in float32; no main path runs
    it: it states that algebra where the CPU tests can hold it to the
    step-by-step version and to ``jax.vjp``.

    Steps are cut into chunks of ``chunk`` (the last padded with steps
    of decay 1 and zero r, k, v, do, which change nothing).  Within a
    chunk, steps tau = 0 .. C-1 and, per key channel i, the decays

        p[tau] = prod_{m < tau} w_m,   q[tau] = prod_{m > tau} w_m,
        D[a, b] = prod_{a < m < b} w_m        (a < b; 0 otherwise)

    are running products: nothing is ever divided by a decay (a bf16
    decay can round to 0).  With S_c the state before the chunk and G_c
    the state gradient at its end, two sequential chains over chunks
    give every S_c and G_c:

        S_{c+1} = diag(p[C-1] w_{C-1}) S_c + (k * q)^T v
        G_{c-1} = diag(p[C-1] w_{C-1}) G_c + (r * p)^T do;   ds0 = G_{-1}

    and, per chunk, with X1 = do S_c^T, X2 = v G_c^T, X3 = (k * q) G_c,
    A = do v^T (A[t, s] = do_t . v_s) and c0 = rowsum(G_c * S_c):

        dr_t = p_t X1_t + sum_{s<t} D[s,t] k_s A[t,s] + u k_t A[t,t]
        dk_t = q_t X2_t + sum_{s>t} D[t,s] r_s A[s,t] + u r_t A[t,t]
        dv_t = X3_t + sum_{s>t} M[t,s] do_s + beta_t do_t,
               M[t,s] = sum_i D[t,s] k_t r_s,  beta_t = sum_i r_t u k_t
        dw_t = q_t p_t c0 + q_t sum_{s<t} D[s,t] k_s X2_s
               + p_t sum_{s>t} D[t,s] r_s X1_s
               + sum_{s'<t<s} D[s',t] D[t,s] r_s k_s' A[s,s']

    The last term's decay is the product over the pair's interval (s',
    s) with step t left out: the prefix D[s', t] times the suffix D[t,
    s].  Returns dr, dk, dv, dw in the inputs' dtype, du in u's, ds0
    float32, as ``wkv6_backward_plain``."""
    B, S, H, dh = r.shape
    C = int(chunk)
    NC = -(-S // C)
    pad = (0, 0, 0, 0, 0, NC * C - S)

    def chunks(t, fill=0.0):
        t = F.pad(t.float(), pad, value=fill)
        return t.reshape(B, NC, C, H, dh).permute(0, 3, 1, 2, 4)

    rc, kc, vc, gc = (chunks(t) for t in (r, k, v, do))   # (B, H, NC, C, dh)
    wc = chunks(w, 1.0)
    uf = u.float()[None, :, None, None, :]                  # (1, H, 1, 1, dh)
    p, q = torch.empty_like(wc), torch.empty_like(wc)
    run = torch.ones_like(wc[..., 0, :])
    for t in range(C):
        p[..., t, :] = run
        run = run * wc[..., t, :]
    decay = run                                             # (B, H, NC, dh)
    run = torch.ones_like(run)
    for t in range(C - 1, -1, -1):
        q[..., t, :] = run
        run = run * wc[..., t, :]
    D = torch.zeros((B, H, NC, C, C, dh), dtype=torch.float32,
                    device=r.device)
    for a in range(C):
        run = torch.ones_like(decay)
        for b in range(a + 1, C):
            D[..., a, b, :] = run
            run = run * wc[..., b, :]
    kq, rp = kc * q, rc * p

    # the two chains over chunks
    zeros = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                        device=r.device)
    s = zeros if s0 is None else s0.float()
    Sc = torch.empty((B, H, NC, dh, dh), dtype=torch.float32,
                     device=r.device)
    for c in range(NC):
        Sc[:, :, c] = s
        s = decay[:, :, c, :, None] * s + torch.einsum(
            "bhti,bhtj->bhij", kq[:, :, c], vc[:, :, c])
    g = zeros if ds_last is None else ds_last.float()
    Gc = torch.empty_like(Sc)
    for c in range(NC - 1, -1, -1):
        Gc[:, :, c] = g
        g = decay[:, :, c, :, None] * g + torch.einsum(
            "bhti,bhtj->bhij", rp[:, :, c], gc[:, :, c])

    # within each chunk
    X1 = torch.einsum("bhctj,bhcij->bhcti", gc, Sc)
    X2 = torch.einsum("bhctj,bhcij->bhcti", vc, Gc)
    X3 = torch.einsum("bhcti,bhcij->bhctj", kq, Gc)
    A = torch.einsum("bhcti,bhcsi->bhcts", gc, vc)
    c0 = (Gc * Sc).sum(-1)                                  # (B, H, NC, dh)
    vdo = torch.diagonal(A, dim1=-2, dim2=-1)[..., None]    # (..., C, 1)
    beta = (rc * uf * kc).sum(-1, keepdim=True)
    dr = (p * X1 + torch.einsum("bhcsti,bhcsi,bhcts->bhcti", D, kc, A)
          + uf * kc * vdo)
    dk = (q * X2 + torch.einsum("bhctsi,bhcsi,bhcst->bhcti", D, rc, A)
          + uf * rc * vdo)
    M = torch.einsum("bhctsi,bhcti,bhcsi->bhcts", D, kc, rc)
    dv = X3 + torch.einsum("bhcts,bhcsj->bhctj", M, gc) + beta * gc
    dw = (q * p * c0[..., None, :]
          + q * torch.einsum("bhcsti,bhcsi,bhcsi->bhcti", D, kc, X2)
          + p * torch.einsum("bhctsi,bhcsi,bhcsi->bhcti", D, rc, X1)
          + torch.einsum("bhcuti,bhctsi,bhcsi,bhcui,bhcsu->bhcti", D, D,
                         rc, kc, A))
    du = (rc * kc * vdo).sum((0, 2, 3))

    def back(t):
        t = t.permute(0, 2, 3, 1, 4).reshape(B, NC * C, H, dh)[:, :S]
        return t.to(r.dtype)
    return (*(back(t) for t in (dr, dk, dv, dw)), du.to(u.dtype), g)


def vote_aggregate_ref(preds, num_classes, noise=None):
    """Teacher-ensemble max voting (``repro.kernels.ref``).

    preds: (M, T) int32 class prediction of each of M teachers for each
    of T queries.  noise: optional (T, U) float32 noise added to the
    vote histogram before the argmax.  Returns (labels (T,) int32,
    counts (T, U) int32); ties go to the first class, as jnp.argmax.
    """
    onehot = F.one_hot(preds.long(), num_classes).to(torch.int32)
    counts = onehot.sum(0, dtype=torch.int32)                   # (T, U)
    scores = counts.to(torch.float32)
    if noise is not None:
        scores = scores + noise.to(torch.float32)
    labels = torch.argmax(scores, dim=-1).to(torch.int32)
    return labels, counts


def top2_of(scores, argmax_labels):
    """(top1, top2) with only the argmax POSITION masked, so exact ties
    give top2 == top1 (top_k semantics; ``_top2_of`` in the
    reference's ops.py)."""
    top1 = scores.max(dim=-1).values
    pos = F.one_hot(argmax_labels.long(), scores.shape[-1]).bool()
    masked = scores.masked_fill(pos, NEG_INF)
    return top1, masked.max(dim=-1).values


def vote_aggregate_plain(preds, num_classes, noise=None):
    """The five outputs of the vote kernel, computed plainly: one-hot
    sum, argmax, then the top-2 masking.  Returns (labels, top1, top2,
    clean_top1, clean_top2) — the noisy argmax and its top-2 plus the
    pre-noise top-2 of the same histogram."""
    clean_labels, counts = vote_aggregate_ref(preds, num_classes)
    cf = counts.to(torch.float32)
    c1, c2 = top2_of(cf, clean_labels)
    if noise is None:
        return clean_labels, c1, c2, c1, c2
    scores = cf + noise.to(torch.float32)
    labels = torch.argmax(scores, dim=-1).to(torch.int32)
    top1, top2 = top2_of(scores, labels)
    return labels, top1, top2, c1, c2


NO_CLASS = 2 ** 31 - 1


def fold_top2(a, b):
    """The top-2 of the union of two disjoint sets of classes, from each
    set's (best (T,), its class (T,), the best of the rest (T,)): the
    larger best wins, an equal best goes to the smaller class, and the
    loser's best joins the seconds, so an exact tie gives second ==
    best.  The rule is order-free (any partition of the classes, folded
    in any order, gives the same bits); the CUDA kernel merges its
    partial results by it.  (NEG_INF, NO_CLASS, NEG_INF) is the empty
    set."""
    (b1, a1, s1), (b2, a2, s2) = a, b
    take = (b2 > b1) | ((b2 == b1) & (a2 < a1))
    best = torch.where(take, b2, b1)
    arg = torch.where(take, a2, a1)
    loser = torch.where(take, b1, b2)
    # the winner's second and the loser's are s1 and s2 in some order
    return best, arg, torch.maximum(loser, torch.maximum(s1, s2))


def block_top2(scores, ids):
    """(best, its class, second) of the classes ``ids`` (a 1-d tensor)
    from their (T, len(ids)) scores: the first maximum, and the largest
    score at any other position."""
    pos = torch.argmax(scores, dim=-1)
    best, second = top2_of(scores, pos)
    return best, ids[pos].to(torch.int32), second


def vote_aggregate_blocked(preds, num_classes, noise=None, *, block_u):
    """``vote_aggregate_plain``'s five outputs over class blocks of
    ``block_u`` classes (the last may be narrower): each block's counts
    and scores, its top-2, folded in with ``fold_top2`` — the TPU
    kernel's class-blocked walk, and on the CPU the merge rule of the
    CUDA kernel."""
    M, T = preds.shape
    dev = preds.device
    empty = (torch.full((T,), NEG_INF, device=dev),
             torch.full((T,), NO_CLASS, dtype=torch.int32, device=dev),
             torch.full((T,), NEG_INF, device=dev))
    noisy = clean = empty
    for u0 in range(0, num_classes, block_u):
        ids = torch.arange(u0, min(num_classes, u0 + block_u), device=dev)
        counts = (preds.long()[:, :, None] == ids).sum(0).to(torch.float32)
        clean = fold_top2(clean, block_top2(counts, ids))
        scores = counts if noise is None else \
            counts + noise[:, ids].to(torch.float32)
        noisy = fold_top2(noisy, block_top2(scores, ids))
    (top1, labels, top2), (c1, _, c2) = noisy, clean
    return labels, top1, top2, c1, c2


def _hist64(xb, node, w, num_nodes, num_bins):
    """The one-hot contraction of ``tree_hist_ref`` in float64."""
    Gf, N, Fn = xb.shape
    G, K, _ = w.shape
    per = G // Gf
    onehot_n = F.one_hot(node.long(), num_nodes).to(torch.float64)
    ncw = w.to(torch.float64)[:, :, None, :] \
        * onehot_n.transpose(1, 2)[:, None]                 # (G, K, n, N)
    onehot_b = F.one_hot(xb.long(), num_bins).to(torch.float64)
    h = torch.bmm(ncw.reshape(Gf, per * K * num_nodes, N),
                  onehot_b.reshape(Gf, N, Fn * num_bins))
    return h.reshape(G, K, num_nodes, Fn, num_bins)


def tree_hist_ref(xb, node, w, num_nodes, num_bins):
    """Weighted (channel, node, feature, bin) histograms of G trees.

    xb: (Gf, N, F) int32 binned features, shared by the G // Gf trees of
    each forest (Gf == G when every tree has its own rows); node: (G, N)
    int32 tree position of each sample; w: (G, K, N) float32 channel
    weights.  Returns (G, K, num_nodes, F, num_bins) float32:

        hist[g, k, n, f, b] = sum_i w[g, k, i] [node[g, i] == n]
                                               [xb[g // (G/Gf), i, f] == b]

    — the einsum "gki,gin,gifb->gknfb" of one-hots, contracted as one
    batched matmul per forest.  It accumulates in float64 and rounds
    once to float32, so a cell's value does not depend on the matmul's
    summation order, and so not on the zero-weight padding a stacked
    fit adds: stacked fits equal serial fits on this path too.
    """
    return _hist64(xb, node, w, num_nodes, num_bins).to(torch.float32)


def node_hist_ref(node, w, num_nodes):
    """Weighted per-node histograms (G, K, num_nodes): ``tree_hist_ref``
    with the node id as the single feature and the nodes as its bins."""
    return tree_hist_ref(node[:, :, None], torch.zeros_like(node), w, 1,
                         num_nodes)[:, :, 0, 0, :]


def tree_hist_f32_error(got, xb, node, w, num_nodes, num_bins):
    """How far a float32 histogram ``got`` is from the exact sums, in
    units of what float32 summation can explain.

    A float32 sum of a cell's m nonzero terms, in any order, is within
    gamma(m - 1) * sum |w| of the exact sum, gamma(j) = j*u / (1 - j*u)
    with u = 2^-24 (plus 2^-52 for the float64 yardstick's own
    rounding): zero for a cell of one term.  Returns (max |got - exact|,
    the largest ratio of a cell's error to its limit) — the ratio is at
    most 1 for any float32 accumulation and far above it for one held in
    bfloat16 or float16 (0/0 counts as 0, x/0 as inf)."""
    exact = _hist64(xb, node, w, num_nodes, num_bins)
    mass = _hist64(xb, node, w.abs(), num_nodes, num_bins)
    terms = _hist64(xb, node, (w != 0).to(w.dtype), num_nodes, num_bins)
    ju = (terms - 1).clamp_min(0) * (2.0 ** -24 + 2.0 ** -52)
    limit = ju / (1 - ju) * mass
    err = (got.to(torch.float64) - exact).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / limit)
    return float(err.max()), float(ratio.max())
