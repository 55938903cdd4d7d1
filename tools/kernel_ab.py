"""Two trees' builds of the vote (K1), attention (K3), RG-LRU scan (K4),
attention backward (N1), RG-LRU backward (N2a) and WKV backward (N2b)
kernels, timed in turns on one card.

    python3 tools/kernel_ab.py --parent DIR

DIR is another checkout of this repository (a ``git archive`` of an
earlier commit, unpacked).  Each tree's ``src/repro_torch/csrc/
{vote_aggregate,flash_attention,rglru_scan,flash_attention_bwd,
rglru_scan_bwd,wkv6_bwd}.cu`` is built with the port's own nvcc command
into
``build/kernels/ab/`` and called through its C entry point on the same
inputs, at the main paths' shapes: K1 at the round's (M 5, T 6105, U 2,
noise) and at the L2 token vote's (M 5, T 1024, U 200,064, noise); K3
in bf16 at (a) the phi4-mini prefill (8 x 512, 24:8, dh 128) and (f)
the stablelm-3b prefill (4 x 1024, 32:32, dh 80), causal, and in
float32 at (c) MQA (2 x 384, 8:1, dh 128), (f') stablelm's prefill,
(l') whisper-tiny's cross attention (8, 64 x 1500, 6:6, dh 64,
non-causal) and (r) recurrentgemma-2b's float32 train forward (4 x
512, 10:1, dh 256, window 2048, the row LSE written); K4 at the
recurrentgemma-2b prefill (4 x 1024 x 2560, bf16) and at its train
shape (4 x 512 x 2560) as training calls it (a tree whose K4 writes
checkpoints writes them); N1 in bf16 at phi4-mini's training shape (B
4, S 512, 24:8, dh 128, causal), at whisper-tiny's (m) encoder (8, 1500
x 1500, 6:6, dh 64) and (n) cross attention (8, 128 x 1500), at
recurrentgemma-2b's local attention in training (4, 512, 10:1, dh 256,
window 2048), at stablelm-3b's (4, 512, 32:32, dh 80, causal), at
granite-20b's (4, 512, 48:1, dh 128), a granite-like (1, 1024, 48:1)
and llava's (1, 4096, 32:8, dh 128), and in float32 at granite's,
phi4's, stablelm's and recurrentgemma's train shapes, at a dh-32 one
(2, 384, 8:2, window 64) and at whisper's (m), from this tree's forward
(K3) o and row log-sum-exp, each tree with its own dK/dV head-split
rule (``bwd_head_splits``), its gradients compared bit for bit with
the other tree's (``same_bits_as_parent``); N2a at recurrentgemma-2b's
train shape (x, log_a, dh (4, 512, 2560) bf16, h0 and dh_last nonzero),
at S 1024, at a ragged S 1000 and in float32 (2, 1000, 512); and N2b at
rwkv6-7b's training shape (r, k, v, w, dO (4, 512, 64, 64) bf16, zero
s0, no ds_last).  Each tree's K3 is launched with its own ``plan``
(keys a tile too, where its launcher takes them) and its N1 with its
own float32 ``bwd_plan`` where it has one.  A tree whose K3 or N1 has
no dh-80 kernel (the parent of a native dh 80: in bf16 once, and
float32 N1 before the split-TF32 kernels) is called at dh 80 as its
wrapper called it: the inputs zero-padded to dh 128 by ``F.pad``, a
launch at 128 with the scale 80^-0.5, the outputs sliced back to 80;
the profiler's device time of a call sums every kernel it runs, so the
copies count.  A tree whose wrapper refused a float32 head dim (N1 at
dh 256 before the split-TF32 kernels) is not called there: its row
reads null times and "refused".  A tree whose N1 entry point takes no
head-split count (the parent of the dh-256 split) is called with its
own signature; a tree's N2b is called with its wrapper's ``BWD_CHUNK``
and workspaces sized for the smaller chunk.  N2a is called as each
tree's ``RGLRUScan`` calls it in training: a tree whose K4 writes
checkpoints (``CHECKPOINT_STEPS`` per dtype) hands them to it; a tree
whose entry points take none (the parent of the checkpoints) is called
with its own signature, its N2a writing its own into a workspace sized
by its ``CHECKPOINT_STEPS``.  N2a's outputs are held bit for bit to
``ref.rglru_scan_backward_plain``.  K1 and K4 outputs are held bit for
bit to the plain version (``kernels/ref.py``); K3's to
``ref.attention_ref`` within ``chip_smoke.ATT_TOL``; N1's to
``ref.attention_backward_plain`` within ``chip_smoke.BWD_TOL`` of the
largest |gradient| (2e-2 bf16: it rounds P and dS before their
products, the plain version does not; 1e-5 float32); N2b's to
``ref.wkv6_backward_plain`` within 2e-2 of each output's largest
|gradient|; K3, N1 and N2b identical run to run.  Then the trees are
timed in turns (parent, change, change, parent), each turn's mean over
20 launches with preallocated outputs by CUDA events around
back-to-back calls, around a CUDA graph of the 20 launches, and from the
profiler's kernel durations; beside each K3 case, one
``scaled_dot_product_attention`` call under ``is_causal`` on its
fastest backend (``chip_smoke.sdpa_best``), beside each N1 case its
backward (``chip_smoke.sdpa_backward_best``), both by CUDA events (in
float32 too, where SDPA runs on the tensor cores in split TF32; none
where a window shorter than the keys binds).  Bounds are
``chip_smoke.attention_bound``'s: float32 on the TF32 tensor cores,
three TF32 products a float32 one.
Prints one JSON line a turn, then the card's name and power limit.
Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ATT_TOL, BWD_TOL, attention_bound,  # noqa: E402
                        bound, cuda_ms, graph_ms, same_bits,
                        sdpa_backward_best, sdpa_best, wkv_backward_bound)
from repro_torch.kernels import build, ref  # noqa: E402

NAMES = ("vote_aggregate", "flash_attention", "rglru_scan",
         "flash_attention_bwd", "rglru_scan_bwd", "wkv6_bwd")
# what each tree's entry points take: {tree: {"n1_splits": bool,
# "n1_dh80": bool, "k3_dh80": bool, "wkv_chunk": int, "rglru_ckpt": bool,
# "rglru_chunk": {dtype: int}}}, filled by build_tree
SIGNATURES = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def device_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms: the durations of the kernels
    it launches over ``reps`` calls under torch.profiler, after
    warm-up.  (A profiler session leaves the process's later host
    launches slower, so this runs after every host-timed reading.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if not us > 0:
        raise AssertionError("the profiler saw no device time")
    return us / reps / 1e3


def build_tree(tree: Path, tag: str):
    """{name: the C entry point} of ``tree``'s kernels, built anew."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(name):
        out = out_dir / f"lib{name}-{tag}.so"
        src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        subprocess.run(build.command(src, out), check=True,
                       capture_output=True)
        return name, ctypes.CDLL(str(out))
    with ThreadPoolExecutor(len(NAMES)) as pool:
        libs = dict(pool.map(one, NAMES))
    va = libs["vote_aggregate"].vote_aggregate_launch
    va.argtypes, va.restype = [_P] * 7 + [_I] * 3 + [_P], _I
    csrc = tree / "src" / "repro_torch" / "csrc"
    kernels = tree / "src" / "repro_torch" / "kernels"
    k3_src = (csrc / "flash_attention.cu").read_text()
    k3_keys = "int keys" in k3_src
    k3 = libs["flash_attention"].flash_attention_launch
    k3.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F] + [_I] * (
        4 if k3_keys else 3) + [_P]
    k3.restype = _I
    ckpt = "void* ckpt" in (csrc / "rglru_scan.cu").read_text()
    rg = libs["rglru_scan"].rglru_scan_launch
    rg.argtypes = [_P] * 6 + [_I] * 5 + [_P] if ckpt else \
        [_P] * 5 + [_I] * 4 + [_P]
    rg.restype = _I
    n2a = libs["rglru_scan_bwd"].rglru_scan_bwd_launch
    n2a.argtypes = [_P] * (8 if ckpt else 9) + [_I] * 5 + [_P]
    n2a.restype = _I
    steps = re.search(r"^CHECKPOINT_STEPS = (.+)$",
                      (kernels / "rglru_scan.py").read_text(), re.M).group(1)
    per = dict(re.findall(r"torch\.(\w+): (\d+)", steps))
    rg_chunk = {dt: int(per.get(str(dt).split(".")[1], steps.split()[0]))
                for dt in (torch.bfloat16, torch.float32)}
    bwd_src = (csrc / "flash_attention_bwd.cu").read_text()
    splits = "int splits" in bwd_src
    n1_plan = "int step" in bwd_src
    n1 = libs["flash_attention_bwd"].flash_attention_bwd_launch
    n1.argtypes = [_P] * 10 + [_I] * 9 + [_F] * 2 + (
        [_I, _P] if splits else []) + [_I] * (4 if n1_plan else 0) + [_P]
    n1.restype = _I
    wk = libs["wkv6_bwd"].wkv6_bwd_launch
    wk.argtypes, wk.restype = [_P] * 16 + [_I] * 6 + [_P], _I
    chunk = int(re.search(
        r"^BWD_CHUNK = (\d+)", (tree / "src" / "repro_torch" / "kernels" /
                                "wkv6.py").read_text(), re.M).group(1))
    k3_dh80 = "case 80" in k3_src
    spec = importlib.util.spec_from_file_location(
        f"flash_attention_{tag}", kernels / "flash_attention.py")
    tree_fa = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tree_fa)
    # the tree's own float32 backward head dims: a dh between them its
    # wrapper padded, a dh above them it refused
    f32_dims = getattr(tree_fa, "BWD_F32_HEAD_DIMS", tree_fa.BWD_HEAD_DIMS)
    # the tree's own dK/dV head-split rule (1 at dh <= 128 before the
    # split reached them)
    SIGNATURES[tag] = {"n1_splits": splits,
                       "head_splits": getattr(tree_fa, "bwd_head_splits",
                                              None),
                       "n1_dh80": "case 80" in bwd_src,
                       "k3_dh80": k3_dh80, "k3_keys": k3_keys,
                       "k3_plan": tree_fa.plan, "n1_plan": n1_plan,
                       "bwd_plan": getattr(tree_fa, "bwd_plan", None),
                       "n1_f32_dims": f32_dims,
                       "wkv_chunk": chunk, "rglru_ckpt": ckpt,
                       "rglru_chunk": rg_chunk}
    return {"vote_aggregate": va, "flash_attention": k3, "rglru_scan": rg,
            "flash_attention_bwd": n1, "rglru_scan_bwd": n2a,
            "wkv6_bwd": wk}


def bit_check(want):
    """A check of one tree's entry point: its outputs bit for bit
    ``want``."""
    def check(call, fn, tree):
        got = call(fn, tree)
        torch.cuda.synchronize()
        if not all(same_bits(a.float(), b.float())
                   for a, b in zip(got, want)):
            raise AssertionError("output != plain")
        return {"bit_identical": True}
    return check


def vote_case(M, T, U, g):
    preds = torch.randint(0, U, (M, T), device="cuda", generator=g,
                          dtype=torch.int32)
    noise = torch.randn((T, U), device="cuda", generator=g) * 3.0
    outs = [torch.empty((T,), dtype=torch.int32, device="cuda")] + [
        torch.empty((T,), device="cuda") for _ in range(4)]

    def call(fn, tree):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(preds.data_ptr(), noise.data_ptr(),
                 *(o.data_ptr() for o in outs), M, T, U, stream)
        build.check(err, "vote_aggregate")
        return outs
    want = ref.vote_aggregate_plain(preds, U, noise)
    nbytes = 4 * (M * T + T * U + 5 * T)
    shape = {"M": M, "T": T, "U": U, "noise": True}
    return shape, call, bit_check(want), bound(nbytes, M * T + T * U), None


def rglru_case(label, B, S, D, train, g):
    """K4 in bf16; with ``train`` as training calls it: a tree whose K4
    writes checkpoints writes them (held bit for bit to the plain
    carries)."""
    from repro_torch.kernels import rglru_scan as rgs
    x = torch.randn((B, S, D), device="cuda", generator=g).bfloat16()
    log_a = (-torch.rand((B, S, D), device="cuda", generator=g)
             * 0.1).bfloat16()
    h0 = torch.randn((B, D), device="cuda", generator=g) * 0.5
    h = torch.empty_like(x)
    hl = torch.empty((B, D), device="cuda")
    ck = torch.empty(rgs.checkpoint_shape(B, S, D, x.dtype), device="cuda")

    def call(fn, tree):
        stream = torch.cuda.current_stream().cuda_stream
        sig = SIGNATURES[tree]
        args = [x.data_ptr(), log_a.data_ptr(), h0.data_ptr(),
                h.data_ptr(), hl.data_ptr()]
        writes = train and sig["rglru_ckpt"]
        if sig["rglru_ckpt"]:
            args += [ck.data_ptr() if writes else None]
        args += [B, S, D, 1]
        if sig["rglru_ckpt"]:
            args += [sig["rglru_chunk"][torch.bfloat16]]
        build.check(fn(*args, stream), "rglru_scan")
        return (h, hl, ck) if writes else (h, hl)
    # the plain carry before each chunk, rounded as the kernels round it
    carry, cks = h0.clone(), []
    for t in range(S):
        if t % rgs.CHECKPOINT_STEPS[x.dtype] == 0:
            cks.append(carry)
        carry = torch.exp(log_a[:, t].float()) * carry + x[:, t].float()
    want = (*ref.rglru_scan_ref(x, log_a, h0), torch.stack(cks, 1))

    def check(call, fn, tree):
        got = call(fn, tree)
        torch.cuda.synchronize()
        if not all(same_bits(a.float(), b.float())
                   for a, b in zip(got, want)):
            raise AssertionError("output != plain")
        return {"bit_identical": True, "checkpoints": len(got) == 3}
    nbytes = x.element_size() * 3 * x.numel() + 4 * 2 * B * D + (
        4 * ck.numel() if train else 0)
    shape = {"shape": label, "B": B, "S": S, "D": D, "dtype": "bfloat16",
             "train": train}
    return shape, call, check, bound(nbytes, 3 * B * S * D), None


def rglru_bwd_case(label, B, S, D, dt, g):
    """N2a from a nonzero h0 and dh_last, outputs preallocated, each tree
    called as its ``RGLRUScan`` calls it: a tree whose K4 writes
    checkpoints gets them (made here by this tree's K4), the other writes
    its own into a workspace sized by its chunk."""
    from repro_torch.kernels import rglru_scan as rgs
    x, dh = (torch.randn((B, S, D), device="cuda", generator=g).to(dt)
             for _ in range(2))
    log_a = (-torch.rand((B, S, D), device="cuda", generator=g)
             * 0.5).to(dt)
    h0, dl = (torch.randn((B, D), device="cuda", generator=g) * 0.5
              for _ in range(2))
    _, _, k4_ck = rgs.rglru_scan(x, log_a, h0, checkpoints=True)
    outs = (torch.empty_like(x), torch.empty_like(log_a),
            torch.empty_like(h0))
    work = {tree: torch.empty((B, -(-S // sig["rglru_chunk"][dt]), D),
                              device="cuda")
            for tree, sig in SIGNATURES.items() if not sig["rglru_ckpt"]}

    def call(fn, tree):
        stream = torch.cuda.current_stream().cuda_stream
        sig = SIGNATURES[tree]
        tail = [B, S, D, int(dt == torch.bfloat16), sig["rglru_chunk"][dt]]
        grads = [t.data_ptr() for t in outs]
        if sig["rglru_ckpt"]:
            args = [x.data_ptr(), log_a.data_ptr(), k4_ck.data_ptr(),
                    dh.data_ptr(), dl.data_ptr(), *grads, *tail]
        else:
            args = [x.data_ptr(), log_a.data_ptr(), h0.data_ptr(),
                    dh.data_ptr(), dl.data_ptr(), *grads,
                    work[tree].data_ptr(), *tail]
        build.check(fn(*args, stream), "rglru_scan_backward")
        return outs
    want = ref.rglru_scan_backward_plain(x, log_a, h0, dh, dl)

    def check(call, fn, tree):
        got = [t.clone() for t in call(fn, tree)]
        again = call(fn, tree)
        torch.cuda.synchronize()
        if not all(same_bits(a, w) and same_bits(b, w)
                   for a, b, w in zip(got, again, want)):
            raise AssertionError(f"N2a {label} != plain bit for bit")
        sig = SIGNATURES[tree]
        return {"bit_identical": True, "run_to_run": True,
                "from_k4_checkpoints": sig["rglru_ckpt"],
                "chunk": sig["rglru_chunk"][dt]}
    # the training call's bytes: x, log_a, dh and the checkpoints read,
    # dx and dlog_a written, dh_last read and dh0 written
    nbytes = x.element_size() * 5 * x.numel() + 4 * 2 * B * D + \
        4 * k4_ck.numel()
    shape = {"shape": label, "B": B, "S": S, "D": D, "dtype": str(dt)}
    return shape, call, check, bound(nbytes, 7 * B * S * D), None


def attention_case(label, B, Sq, Skv, H, KV, dh, causal, window, lse, dt,
                   g):
    """K3 at one shape in ``dt`` (the row LSE written where ``lse``), the
    outputs preallocated, each tree launched with its own plan (its
    ``plan``, and keys a tile where its launcher takes them).  At dh 80
    a tree with no dh-80 kernel is called as its wrapper called it: pad
    to 128, launch and slice."""
    from repro_torch.kernels.meta import valid_pairs
    q = torch.randn((B, Sq, H, dh), device="cuda", generator=g).to(dt)
    k, v = (torch.randn((B, Skv, KV, dh), device="cuda", generator=g)
            .to(dt) for _ in range(2))
    out = torch.empty_like(q)
    lse_out = torch.empty((B, H, Sq), device="cuda") if lse else None
    kw = dict(causal=causal, window=window)

    def launch(fn, tree, q, k, v, o):
        d = q.shape[-1]
        sig = SIGNATURES[tree]
        p = sig["k3_plan"](d, dt)
        geometry = (p.threads, p.keys, p.smem) if sig["k3_keys"] else \
            (p.threads, p.smem)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse_out is None else lse_out.data_ptr(), B, Sq,
                 Skv, H, KV, d, int(dt == torch.bfloat16), int(causal),
                 window, 0.0, dh ** -0.5, 0, *geometry, stream)
        build.check(err, "flash_attention")

    def padded(tree):
        return dh == 80 and not SIGNATURES[tree]["k3_dh80"]

    def call(fn, tree):
        if padded(tree):
            qp, kp, vp = (F.pad(t, (0, 128 - dh)) for t in (q, k, v))
            op = torch.empty_like(qp)
            launch(fn, tree, qp, kp, vp, op)
            return (op[..., :dh].contiguous(),)
        launch(fn, tree, q, k, v, out)
        return (out,)
    want = ref.attention_ref(q, k, v, **kw)
    tol = ATT_TOL[dt]

    def check(call, fn, tree):
        got = call(fn, tree)[0].clone()
        again = call(fn, tree)[0]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {label} differs run to run")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol,
                              rtol=tol):
            raise AssertionError(f"K3 {label}: max |err| {err}")
        return {"max_abs_err": err, "tol": tol, "run_to_run": True,
                "launched_dh": 128 if padded(tree) else dh,
                "plan": SIGNATURES[tree]["k3_plan"](
                    128 if padded(tree) else dh, dt)._asdict()}

    def library():
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        extra = {"is_causal": True} if causal else {}
        ms, backend, out_t = sdpa_best(qt, kt, vt, **extra)
        torch.testing.assert_close(out_t.transpose(1, 2).float(),
                                   want.float(), atol=tol, rtol=tol)
        return {"event_ms": ms, "backend": backend}
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + (
        4 * B * H * Sq if lse else 0)
    nops = 4 * B * H * valid_pairs(Sq, Skv, causal, window) * dh
    shape = {"shape": label, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "KV": KV,
             "dh": dh, "causal": causal, "window": window, "lse": lse,
             "dtype": str(dt).split(".")[1]}
    # SDPA computes the same function where the window covers the keys
    lib = library if window == 0 or window >= Skv else None
    return shape, call, check, attention_bound(nbytes, nops, dt), lib


def attention_bwd_case(label, B, Sq, Skv, H, KV, dh, causal, window, dt,
                       g):
    """N1 at one shape in ``dt``: inputs from ``g``, o and the row
    log-sum-exp from this tree's forward kernel, outputs preallocated; a
    tree that splits the dK/dV walk gets its split count
    (``bwd_head_splits``) and its partials' workspace, a tree whose
    launcher takes the float32 plan gets its ``bwd_plan``.  A head dim
    the tree's wrapper padded (bf16 dh 80 before its native kernel;
    float32 dh 80 before the split-TF32 kernels) is called padded to
    128, as that wrapper did; one it refused (float32 dh 256 before
    them) is not called, and its time is null."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.meta import valid_pairs
    q, do = (torch.randn((B, Sq, H, dh), device="cuda", generator=g)
             .to(dt) for _ in range(2))
    k, v = (torch.randn((B, Skv, KV, dh), device="cuda", generator=g)
            .to(dt) for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    d_rows = torch.empty((B, H, Sq), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launched_dh(tree):
        sig = SIGNATURES[tree]
        if dt == torch.float32:
            return fa.padded_head_dim(dh, sig["n1_f32_dims"])
        return dh if dh != 80 or sig["n1_dh80"] else 128

    def geometry(tree, d):
        sig = SIGNATURES[tree]
        bp = sig["bwd_plan"](d, dt) if sig["bwd_plan"] else None
        if not sig["n1_splits"] or (dt == torch.float32 and bp is None):
            return bp, 1
        splits = sig["head_splits"](B, Skv, KV, H, d, sms)
        return bp, splits

    def launch(fn, tree, ins, grads):
        sig = SIGNATURES[tree]
        d = ins[0].shape[-1]
        bp, splits = geometry(tree, d)
        part = (torch.empty((2, splits, B, Skv, KV, d), device="cuda")
                if splits > 1 else None)
        stream = torch.cuda.current_stream().cuda_stream
        args = [*(t.data_ptr() for t in ins[:5]), lse.data_ptr(),
                d_rows.data_ptr(), *(t.data_ptr() for t in grads), B, Sq,
                Skv, H, KV, d, int(dt == torch.bfloat16), int(causal),
                window, 0.0, dh ** -0.5]
        if sig["n1_splits"]:
            args += [splits, None if part is None else part.data_ptr()]
        if sig["n1_plan"]:
            args += list(bp) if bp is not None else [0, 0, 0, 0]
        err = fn(*args, stream)
        build.check(err, "flash_attention_backward")

    def call(fn, tree):
        d = launched_dh(tree)
        if d is None:
            return None
        if d != dh:
            ins = [F.pad(t, (0, d - dh)) for t in (q, k, v, o, do)]
            grads = [torch.empty_like(t) for t in ins[:3]]
            launch(fn, tree, ins, grads)
            return tuple(t[..., :dh].contiguous() for t in grads)
        launch(fn, tree, (q, k, v, o, do), outs)
        return outs
    want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
    tol = BWD_TOL[dt]
    seen = {}  # each checked tree's gradients

    def check(call, fn, tree):
        first = call(fn, tree)
        if first is None:
            return {"refused": f"the tree's wrapper refuses float32 dh {dh}",
                    "launched_dh": None}
        got = [t.clone() for t in first]
        again = call(fn, tree)
        torch.cuda.synchronize()
        rel = 0.0
        for a, b, w in zip(got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"N1 {label} differs run to run")
            rel = max(rel, float((a.float() - w.float()).abs().max()
                                 / w.float().abs().max()))
        if rel > tol:
            raise AssertionError(f"N1 {label}: {rel} > {tol} of the "
                                 f"largest |gradient|")
        # whether dQ, dK and dV equal each earlier tree's bit for bit
        same = {f"same_bits_as_{t}": all(torch.equal(a, b)
                                         for a, b in zip(got, other))
                for t, other in seen.items()}
        seen[tree] = got
        return {"max_rel_err": rel, "tol": tol, "run_to_run": True,
                "head_splits": geometry(tree, launched_dh(tree))[1],
                "launched_dh": launched_dh(tree), **same}

    def library():
        ms, backend, _ = sdpa_backward_best(q, k, v, do, want, ATT_TOL[dt],
                                            causal=causal)
        return {"event_ms": ms, "backend": backend}
    nbytes = (q.element_size() * (3 * q.numel() + 2 * (k.numel() + v.numel())
                                  + o.numel()) + 4 * lse.numel())
    nops = 10 * B * H * valid_pairs(Sq, Skv, causal, window) * dh
    shape = {"shape": label, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
             "KV": KV, "dh": dh, "causal": causal, "window": window,
             "dtype": str(dt).split(".")[1]}
    lib = library if window == 0 or window >= Skv else None
    return shape, call, check, attention_bound(nbytes, nops, dt), lib


def wkv_bwd_case(B, S, H, g):
    """N2b at one shape in bf16 from the zero state with no ds_last (a
    train step's call), outputs and workspaces preallocated, each tree
    called with its own chunk."""
    dh = 64
    r, k, v, do = (torch.randn((B, S, H, dh), device="cuda", generator=g)
                   .mul(0.5).bfloat16() for _ in range(4))
    w = torch.sigmoid(torch.randn((B, S, H, dh), device="cuda", generator=g)
                      + 2.0).bfloat16()
    u = torch.randn((H, dh), device="cuda", generator=g) * 0.1
    s0 = torch.zeros((B, H, dh, dh), device="cuda")
    grads = [torch.empty_like(r) for _ in range(4)] + [
        torch.empty((H, dh), device="cuda"), torch.empty_like(s0)]
    nc = -(-S // min(t["wkv_chunk"] for t in SIGNATURES.values()))
    du_part = torch.empty((B, H, nc, dh), device="cuda")
    ckpt = torch.empty((2, B, H, nc, dh, dh), device="cuda")

    def call(fn, tree):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), do.data_ptr(), None,
                 *(t.data_ptr() for t in grads), du_part.data_ptr(),
                 ckpt.data_ptr(), B, S, H, dh, 1,
                 SIGNATURES[tree]["wkv_chunk"], stream)
        build.check(err, "wkv6_backward")
        return grads
    want = ref.wkv6_backward_plain(r, k, v, w, u, s0, do)
    tol = 2e-2

    def check(call, fn, tree):
        got = [t.clone() for t in call(fn, tree)]
        again = call(fn, tree)
        torch.cuda.synchronize()
        rel = 0.0
        for a, b, w_ in zip(got, again, want):
            if not same_bits(a, b):
                raise AssertionError("N2b differs run to run")
            rel = max(rel, float((a.float() - w_.float()).abs().max()
                                 / w_.float().abs().max()))
        if rel > tol:
            raise AssertionError(f"N2b: {rel} > {tol} of the largest "
                                 f"|gradient|")
        return {"max_rel_err": rel, "tol": tol, "run_to_run": True,
                "chunk": SIGNATURES[tree]["wkv_chunk"]}
    shape = {"shape": "rwkv6_train", "B": B, "S": S, "H": H, "dh": dh,
             "dtype": "bfloat16"}
    return (shape, call, check,
            wkv_backward_bound(B, S, H, dh, torch.bfloat16, False)[:2], None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="checkout of the tree to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": build_tree(args.parent.resolve(), "parent"),
             "change": build_tree(ROOT, "change")}
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("vote_aggregate", vote_case(5, 6105, 2, g)),
             ("vote_aggregate", vote_case(5, 1024, 200_064, g))] + [
        ("flash_attention", attention_case(*shape, g))
        # label, B, Sq, Skv, H, KV, dh, causal, window, lse, dtype
        for shape in (
            ("a_phi4_prefill", 8, 512, 512, 24, 8, 128, True, 0, False, bf),
            ("f_stablelm_dh80", 4, 1024, 1024, 32, 32, 80, True, 0, False,
             bf),
            ("c_f32_mqa", 2, 384, 384, 8, 1, 128, True, 0, False, f32),
            ("f2_stablelm_dh80_f32", 4, 1024, 1024, 32, 32, 80, True, 0,
             False, f32),
            ("l2_whisper_cross_f32", 8, 64, 1500, 6, 6, 64, False, 0, False,
             f32),
            ("r_recurrentgemma_train_f32_lse", 4, 512, 512, 10, 1, 256,
             True, 2048, True, f32))] + [
        ("rglru_scan", rglru_case(*shape, g))
        for shape in (("recurrentgemma_prefill", 4, 1024, 2560, False),
                      ("recurrentgemma_train", 4, 512, 2560, True))] + [
        ("rglru_scan_bwd", rglru_bwd_case(*shape, g))
        # label, B, S, D, dtype
        for shape in (("recurrentgemma_train", 4, 512, 2560, torch.bfloat16),
                      ("S1024", 4, 1024, 2560, torch.bfloat16),
                      ("ragged_S1000", 4, 1000, 2560, torch.bfloat16),
                      ("f32_small", 2, 1000, 512, torch.float32))] + [
        ("flash_attention_bwd", attention_bwd_case(*shape, g))
        # label, B, Sq, Skv, H, KV, dh, causal, window, dtype
        for shape in (("phi4_train", 4, 512, 512, 24, 8, 128, True, 0, bf),
                      ("m_whisper_encoder", 8, 1500, 1500, 6, 6, 64, False,
                       0, bf),
                      ("n_whisper_cross", 8, 128, 1500, 6, 6, 64, False, 0,
                       bf),
                      ("recurrentgemma_train", 4, 512, 512, 10, 1, 256,
                       True, 2048, bf),
                      ("stablelm_train", 4, 512, 512, 32, 32, 80, True, 0,
                       bf),
                      ("granite_train", 4, 512, 512, 48, 1, 128, True, 0,
                       bf),
                      ("granite_like", 1, 1024, 1024, 48, 1, 128, True, 0,
                       bf),
                      ("llava_train", 1, 4096, 4096, 32, 8, 128, True, 0,
                       bf),
                      ("granite_train_f32", 4, 512, 512, 48, 1, 128, True,
                       0, f32),
                      ("phi4_train_f32", 4, 512, 512, 24, 8, 128, True, 0,
                       f32),
                      ("stablelm_train_f32", 4, 512, 512, 32, 32, 80, True,
                       0, f32),
                      ("recurrentgemma_train_f32", 4, 512, 512, 10, 1, 256,
                       True, 2048, f32),
                      ("f32_dh32", 2, 384, 384, 8, 2, 32, True, 64, f32),
                      ("m_whisper_encoder_f32", 8, 1500, 1500, 6, 6, 64,
                       False, 0, f32))] + [
        ("wkv6_bwd", wkv_bwd_case(4, 512, 64, g))]
    turns = list(enumerate(("parent", "change", "change", "parent")))
    rows = []
    for name, (shape, call, check, (b_ms, b_by), library) in cases:
        checks = {tree: check(call, fns[name], tree)
                  for tree, fns in trees.items()}
        if library is not None:
            lib = "sdpa_backward" if name == "flash_attention_bwd" \
                else "sdpa_forward"
            print(json.dumps({"kernel": lib, **shape, **library()}),
                  flush=True)
        for turn, tree in turns:
            def run(fn=trees[tree][name], tree=tree, call=call):
                return call(fn, tree)
            refused = "refused" in checks[tree]
            rows.append((None if refused else run, {
                "kernel": name, **shape, "tree": tree, "turn": turn,
                "event_ms": None if refused else cuda_ms(run),
                "graph_ms": None if refused else graph_ms(run),
                "bound_ms": b_ms, "bound_by": b_by, **checks[tree]}))
    for run, row in rows:  # profiler last
        row["device_ms"] = None if run is None else device_ms(run)
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
