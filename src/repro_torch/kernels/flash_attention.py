"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The counterpart of ``repro.kernels.flash_attention.flash_attention``:
blocked online-softmax attention with GQA, a causal mask, a sliding
window, a tanh logit soft-cap and a scalar ``q_offset``; bfloat16
inputs run on the tensor cores, wgmma with TMA tile loads at every
head dim (P rounded to bf16 before P·V); float32 inputs on the tensor
cores too, in split TF32 (each float32 operand the sum of two TF32
terms, each product three TF32 products: float32 accuracy, the
arithmetic ``ref.attention_split_tf32_plain`` states).  It takes the
model layout, q (B, Sq, H, dh) and k/v (B, Skv, KV, dh), where the
reference's kernel takes (B, H, S, dh) after a transpose and padding in
``ops.attention``: the CUDA kernel reads heads by stride (or through
TMA tensor maps over the same layout, made by its launcher) and masks
its ragged edges.  CUDA tensors only; ``ops.attention`` runs the plain
version (``ref.attention_plain``) for CPU tensors.

``launches`` counts the kernel launches this process made, so a run
can show that its prefills went through the kernel (``f32_launches``
the float32 kernel's share).  ``plan`` is the launch's plan and the one
owner of its geometry: the CUDA launcher takes its threads, keys a tile
and shared memory, and refuses threads or keys it was not built for.

Training: ``return_lse=True`` also returns each row's float32
log-sum-exp (B, H, Sq), which ``flash_attention_backward`` (the
hand-written backward, ``csrc/flash_attention_bwd.cu``) takes with q,
k, v, o and dO to give dQ, dK and dV (Sq = Skv, or Sq != Skv for a
non-causal cross attention): bfloat16 on TMA + wgmma (P and dS rounded
to bf16 before their products), float32 in split TF32 on mma.sync
(``ref.attention_backward_split_tf32_plain`` states it; ``bwd_plan``
owns its geometry), the launcher choosing by dtype with no fallback;
``FlashAttention`` is the ``torch.autograd.Function`` that joins the
two, and ``bwd_launches`` counts the backward's kernel launches (three
a call; ``f32_bwd_launches`` the float32 kernels' share).  The
reference has no backward kernel: off the TPU it differentiates its xla
attention.

Both directions run every head dim of ``HEAD_DIMS`` and
``BWD_HEAD_DIMS`` natively in both dtypes (32, 64, stablelm's 80, 128
and recurrentgemma's 256).  A head dim between them is zero-padded on
the head axis to the next one (``padded_head_dim``: 48 -> 64) and run
with the true dim's scale ``dh ** -0.5``: zero columns add nothing to
q·k, to D = rowsum(dO·O) or to dQ and dK, and the padded output columns
are sliced away, at the cost of the padded dim's work and the pad and
slice copies.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0
NEG_INF = -1e30    # a masked score's running-max floor (csrc: NEG_INF)
bwd_launches = 0
# the float32 (split-TF32) kernels' share of launches and bwd_launches
f32_launches = 0
f32_bwd_launches = 0
BWD_KERNELS = 3     # D = rowsum(dO * O), then dK/dV, then dQ

HEAD_DIMS = (32, 64, 80, 128, 256)       # the forward, both dtypes
BWD_HEAD_DIMS = (32, 64, 80, 128, 256)   # the backward, both dtypes
DTYPES = (torch.float32, torch.bfloat16)
BQ = BK = 64       # query rows a CTA, keys a tile (the wgmma paths)
STAGES = 2         # the K / V (or Q / dO) ring of every path
WG_THREADS = 128 + 32  # the wgmma path: a consumer warpgroup + a producer warp
F32_THREADS = 128  # the split-TF32 paths: four warps of 16 rows
SMEM_MAX = 232_448  # shared memory one CTA may opt into on the H100


class Tile(NamedTuple):
    swizzle: int  # bytes of TMA's (and wgmma's) swizzle: 128, 64 or 32
    cols: int     # bf16 columns of one box, swizzle / 2
    boxes: int    # boxes of 64 rows x swizzle bytes a tile, dh / cols


def tile(dh):
    """The shared-memory geometry of a 64-row bfloat16 tile of head dim
    ``dh`` on the wgmma path (``csrc/hopper.cuh: Tile``): a 128-byte
    swizzle where dh is a multiple of 64, dh 32's 64-byte row, else (dh
    80) boxes of 16 columns with the 32-byte swizzle."""
    swizzle = 128 if dh % 64 == 0 else 64 if dh == 32 else 32
    return Tile(swizzle, swizzle // 2, dh // (swizzle // 2))


def f32_pitch(dh):
    """Floats a row of a float32 tile takes in shared memory
    (``csrc/hopper.cuh: F32Tile``): dh rounded up to 32, whole 128-byte
    lines, so that the XOR swizzle of its 16-byte chunks keeps both of
    the kernels' reads free of bank conflicts (dh 80: 96)."""
    return -(-dh // 32) * 32


class Plan(NamedTuple):
    path: str     # "wgmma" (bfloat16) or "split_tf32" (float32)
    rows: int     # query rows a CTA
    keys: int     # keys a tile
    threads: int
    smem: int     # bytes of dynamic shared memory


def plan(dh, dtype):
    """The forward's launch plan at head dim ``dh`` and ``dtype``.
    bfloat16 takes the wgmma path: a consumer warpgroup of 64 query rows
    and a producer warp a CTA, a Q tile and a ring of STAGES K and V
    tiles (64 x dh bf16 each, ``tile(dh).boxes`` TMA boxes), 9
    barriers, and 1 KB of slack to align the tiles to the 128-byte
    swizzle's 1024-byte period (three CTAs an SM at dh 80, two at the
    other dh <= 128, one at dh 256).  float32 takes the split-TF32 path:
    four warps of 16 query rows, a Q tile and a ring of STAGES K and V
    tiles of ``keys`` rows (64; 32 above dh 64), rows of
    ``f32_pitch(dh)`` floats (two CTAs an SM at dh 64 and 128, three at
    80, one at 256)."""
    if dtype == torch.bfloat16:
        t = tile(dh)
        tile_bytes = t.boxes * BK * t.swizzle
        smem = 1024 + tile_bytes * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES)
        return Plan("wgmma", BQ, BK, WG_THREADS, smem)
    keys = 64 if dh <= 64 else 32
    smem = 4 * f32_pitch(dh) * (BQ + STAGES * 2 * keys)
    return Plan("split_tf32", BQ, keys, F32_THREADS, smem)


class BwdPlan(NamedTuple):
    threads: int
    block: int    # rows a CTA owns: keys (dK/dV pass), query rows (dQ)
    step: int     # rows a streamed tile: query rows (dK/dV), keys (dQ)
    smem: int     # bytes of dynamic shared memory, both passes


def bwd_plan(dh, dtype):
    """The float32 backward's launch plan at head dim ``dh`` (split
    TF32, four warps a CTA), or None for bfloat16 (its launcher sizes
    its own TMA tiles).  Each pass holds two tiles of ``block`` rows (K
    and V, or Q and dO) and a ring of STAGES pairs of ``step``-row tiles
    (Q and dO, or K and V), rows of ``f32_pitch(dh)`` floats, beside the
    dK/dV pass's lse and D of a step's rows.  block is 64, 32 at dh 256
    (each 16-row block then split over two warps a half of the output
    columns); step is 64, 32 above dh 64: two CTAs an SM up to dh 80,
    one at 128 (128.5 KB) and 256 (192.5 KB)."""
    if dtype != torch.float32:
        return None
    block = 32 if dh == 256 else 64
    step = 64 if dh <= 64 else 32
    smem = (4 * f32_pitch(dh) * (2 * block + STAGES * 2 * step)
            + 4 * 2 * STAGES * step)
    return BwdPlan(F32_THREADS, block, step, smem)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F] + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


def _bwd_lib():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_P] * 10 + [_I] * 9 + [_F, _F, _I, _P] + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


def bwd_head_splits(B, Skv, KV, H, dh, sms):
    """How many CTAs share one (batch, kv head, key block)'s walk over
    its group's H / KV q heads in the backward's dK/dV pass, on a card
    of ``sms`` SMs, in both dtypes and at every head dim: the smallest
    count that gives the launch one CTA an SM counting 64-key tiles, at
    most one q head a split.  granite-20b's train shape (B 4, S 512,
    48:1) has 32 tiles and gets 5 splits of 9-10 heads (160 CTAs, the
    CTA of key block 0 walking 80 (head, query tile) pairs under the
    causal mask, not 384); recurrentgemma's (10:1, dh 256) 5 splits of
    2 heads (the float32 kernels' 32-key blocks at dh 256 make 320 CTAs
    of it).  1 wherever the tiles alone fill the card (phi4-mini's,
    stablelm's, deepseek's, gemma2's, mixtral's and llava's train
    shapes), and there the kernels write dK and dV themselves.  Above 1
    each split's float32 partial dK and dV are added in split order
    (``csrc/flash_attention_bwd.cu``: merge_dkdv)."""
    tiles = -(-Skv // BK) * KV * B
    return max(1, min(H // KV, -(-sms // tiles)))


def padded_head_dim(dh, dims=HEAD_DIMS):
    """The head dim a ``dh``-wide call launches at: ``dh`` itself where
    the kernel has it, else the next larger of ``dims``; None above
    them all."""
    return next((d for d in dims if d >= dh), None)


def _pad_heads(ts, dp):
    """Each of ``ts`` zero-padded on its last (head) axis to ``dp``."""
    return [F.pad(t, (0, dp - t.shape[-1])) for t in ts]


def _check(t, name, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"flash_attention: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} must be {dtype} like q, "
                        f"got {t.dtype}")
    if t.dim() != 4 or tuple(t.shape) != shape:
        raise ValueError(f"flash_attention: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous in the "
                         f"(B, S, heads, dh) layout")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must start on a 16-byte "
                         f"boundary (TMA and 16-byte loads need it)")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, return_lse=False):
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh); CUDA tensors of one
    dtype (float32 or bfloat16), contiguous, H % KV == 0, dh at most
    the largest of HEAD_DIMS (launched as it is where HEAD_DIMS has it,
    dh 80 included; a dh between them runs padded to the next one).
    ``q_offset`` is an int.  Returns (B, Sq, H, dh) in q's dtype, and
    with ``return_lse`` also the float32 (B, H, Sq) row
    log-sum-exp of the scaled, soft-capped, masked scores (+inf for a
    row that sees no key)."""
    global launches, f32_launches
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    dp = padded_head_dim(dh)
    if dp is None:
        raise ValueError(f"flash_attention: head dim {dh} above "
                         f"{HEAD_DIMS[-1]}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads do not split over "
                         f"{KV} kv heads")
    if not isinstance(q_offset, int):
        raise TypeError("flash_attention: q_offset must be an int (per-row "
                        "offsets take the plain decode path)")
    dev = q.device
    _check(q, "q", (B, Sq, H, dh), q.dtype, dev)
    _check(k, "k", (B, Skv, KV, dh), q.dtype, dev)
    _check(v, "v", (B, Skv, KV, dh), q.dtype, dev)
    if dp != dh:
        q, k, v = _pad_heads((q, k, v), dp)
    p = plan(dp, q.dtype)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KV,
                 dp, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), int(window), float(softcap),
                 dh ** -0.5, q_offset, p.threads, p.keys, p.smem, stream)
    build.check(err, "flash_attention")
    with build.COUNT_LOCK:
        launches += 1
        f32_launches += q.dtype == torch.float32
    if dp != dh:
        out = out[..., :dh].contiguous()
    return (out, lse) if return_lse else out


def flash_attention_backward(q, k, v, o, do, lse, *, causal=True, window=0,
                             softcap=0.0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` at
    q_offset 0, given its output ``o``, its row log-sum-exp ``lse`` (B,
    H, Sq) float32 and the output's gradient ``do``: self-attention (Sq
    = Skv, training) or, with ``causal=False``, cross attention (Sq !=
    Skv).  CUDA tensors, contiguous; q, o, do (B, Sq, H, dh) and k, v
    (B, Skv, KV, dh) of one dtype (float32 or bfloat16); dh at most the
    largest of ``BWD_HEAD_DIMS`` (each launched as it is, and a dh
    between them padded to the next one).  bfloat16 runs the wgmma
    kernels (at dh 256 two warpgroups a CTA, one a half of the output
    columns, sharing each tile's scores), float32 the split-TF32 kernels
    (``bwd_plan``); where the key tiles leave the card short both split
    the q heads of a group over ``bwd_head_splits`` CTAs whose partial
    dK and dV are added in split order.  Every product accumulates in
    float32 in a fixed order (no atomics): the gradients are identical
    run to run.  The outputs are in q's dtype."""
    global bwd_launches, f32_bwd_launches
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_backward: q and k must be 4-d, "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_backward: dtype {q.dtype} not in "
                        f"{DTYPES}")
    dp = padded_head_dim(dh, BWD_HEAD_DIMS)
    if dp is None:
        raise ValueError(f"flash_attention_backward: head dim {dh} above "
                         f"{BWD_HEAD_DIMS[-1]} (the attention archs' "
                         f"training widths and their smokes)")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention_backward: {H} heads do not split "
                         f"over {KV} kv heads")
    if causal and Skv != Sq:
        raise ValueError(f"flash_attention_backward: a causal call needs "
                         f"Sq == Skv (a training call), got {Sq} and {Skv}")
    if Skv == 0:
        raise ValueError("flash_attention_backward: no key (Skv = 0)")
    dev = q.device
    _check(q, "q", (B, Sq, H, dh), q.dtype, dev)
    _check(k, "k", (B, Skv, KV, dh), q.dtype, dev)
    _check(v, "v", (B, Skv, KV, dh), q.dtype, dev)
    _check(o, "o", (B, Sq, H, dh), q.dtype, dev)
    _check(do, "do", (B, Sq, H, dh), q.dtype, dev)
    if (lse.device != dev or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse must be a "
                         f"contiguous float32 ({B}, {H}, {Sq}) tensor on "
                         f"{dev}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    if dp != dh:
        q, k, v, o, do = _pad_heads((q, k, v, o, do), dp)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    d_rows = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    bp = bwd_plan(dp, q.dtype)
    splits = bwd_head_splits(
        B, Skv, KV, H, dp,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = (torch.empty((2, splits, B, Skv, KV, dp), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), d_rows.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H,
                 KV, dp, int(q.dtype == torch.bfloat16), int(bool(causal)),
                 int(window), float(softcap), dh ** -0.5, splits,
                 None if part is None else part.data_ptr(),
                 *(bp if bp is not None else (0, 0, 0, 0)), stream)
    build.check(err, "flash_attention_backward")
    with build.COUNT_LOCK:
        bwd_launches += BWD_KERNELS
        f32_bwd_launches += BWD_KERNELS * (q.dtype == torch.float32)
    if dp != dh:
        dq, dk, dv = (t[..., :dh].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel saves its row
    log-sum-exp, the backward runs ``flash_attention_backward``.  For
    training calls on CUDA tensors: q_offset 0, and Sq = Skv unless
    ``causal`` is False (cross attention)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, do.contiguous(), lse, causal=causal, window=window,
            softcap=softcap)
        return dq, dk, dv, None, None, None
