"""Two trees' builds of the vote (K1), RG-LRU scan (K4) and attention
backward (N1) kernels, timed in turns on one card.

    python3 tools/kernel_ab.py --parent DIR

DIR is another checkout of this repository (a ``git archive`` of an
earlier commit, unpacked).  Each tree's ``src/repro_torch/csrc/
{vote_aggregate,rglru_scan,flash_attention_bwd}.cu`` is built with the
port's own nvcc command into ``build/kernels/ab/`` and called through
its C entry point (the same signature in both trees) on the same
inputs, at the main paths' shapes: K1 at the round's (M 5, T 6105, U 2,
noise) and at the L2 token vote's (M 5, T 1024, U 200,064, noise), K4
at the recurrentgemma-2b prefill (4 x 1024 x 2560, bf16), N1 at
phi4-mini's training shape (B 4, S 512, 24:8, dh 128, causal) and at
whisper-tiny's (m) encoder (8, 1500 x 1500, 6:6, dh 64) and (n) cross
attention (8, 128 x 1500), bf16, from this tree's forward (K3) o and
row log-sum-exp.  K1 and K4 outputs are held bit for bit to the plain
version (``kernels/ref.py``); N1's to ``ref.attention_backward_plain``
within ``chip_smoke.ATT_TOL`` of the largest |gradient| (bf16 rounds P
and dS before their products, the plain version does not), and
identical run to run.  Then the trees are timed in turns (parent,
change, change, parent), each turn's mean over 20 launches with
preallocated outputs by CUDA events around back-to-back calls, around a
CUDA graph of the 20 launches, and from the profiler's kernel
durations; beside each N1 case, the backward of one
``scaled_dot_product_attention`` call on its fastest backend
(``chip_smoke.sdpa_backward_best``, CUDA events).  Prints one JSON line
a turn, then the card's name and power limit.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ATT_TOL, BF16_OPS_PER_S, bound, cuda_ms,  # noqa: E402
                        graph_ms, same_bits, sdpa_backward_best)
from repro_torch.kernels import build, ref  # noqa: E402

NAMES = ("vote_aggregate", "rglru_scan", "flash_attention_bwd")
_P, _I = ctypes.c_void_p, ctypes.c_int


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
    rg = libs["rglru_scan"].rglru_scan_launch
    rg.argtypes, rg.restype = [_P] * 5 + [_I] * 4 + [_P], _I
    n1 = libs["flash_attention_bwd"].flash_attention_bwd_launch
    n1.argtypes = [_P] * 10 + [_I] * 9 + [ctypes.c_float] * 2 + [_P]
    n1.restype = _I
    return {"vote_aggregate": va, "rglru_scan": rg,
            "flash_attention_bwd": n1}


def bit_check(want):
    """A check of one tree's entry point: its outputs bit for bit
    ``want``."""
    def check(call, fn):
        got = call(fn)
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

    def call(fn):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(preds.data_ptr(), noise.data_ptr(),
                 *(o.data_ptr() for o in outs), M, T, U, stream)
        build.check(err, "vote_aggregate")
        return outs
    want = ref.vote_aggregate_plain(preds, U, noise)
    nbytes = 4 * (M * T + T * U + 5 * T)
    shape = {"M": M, "T": T, "U": U, "noise": True}
    return shape, call, bit_check(want), bound(nbytes, M * T + T * U), None


def rglru_case(B, S, D, g):
    x = torch.randn((B, S, D), device="cuda", generator=g).bfloat16()
    log_a = (-torch.rand((B, S, D), device="cuda", generator=g)
             * 0.1).bfloat16()
    h0 = torch.randn((B, D), device="cuda", generator=g) * 0.5
    h = torch.empty_like(x)
    hl = torch.empty((B, D), device="cuda")

    def call(fn):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), log_a.data_ptr(), h0.data_ptr(),
                 h.data_ptr(), hl.data_ptr(), B, S, D, 1, stream)
        build.check(err, "rglru_scan")
        return h, hl
    want = ref.rglru_scan_ref(x, log_a, h0)
    nbytes = x.element_size() * 3 * x.numel() + 4 * 2 * B * D
    shape = {"B": B, "S": S, "D": D, "dtype": "bfloat16"}
    return shape, call, bit_check(want), bound(nbytes, 3 * B * S * D), None


def attention_bwd_case(label, B, Sq, Skv, H, KV, dh, causal, g):
    """N1 at one shape in bf16: inputs from ``g``, o and the row
    log-sum-exp from this tree's forward kernel, outputs preallocated."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.meta import valid_pairs
    q, do = (torch.randn((B, Sq, H, dh), device="cuda", generator=g)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, Skv, KV, dh), device="cuda", generator=g)
            .bfloat16() for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    d_rows = torch.empty((B, H, Sq), device="cuda")

    def call(fn):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), d_rows.data_ptr(),
                 *(t.data_ptr() for t in outs), B, Sq, Skv, H, KV, dh, 1,
                 int(causal), 0, 0.0, dh ** -0.5, stream)
        build.check(err, "flash_attention_backward")
        return outs
    want = ref.attention_backward_plain(q, k, v, o, do, lse, causal=causal)
    tol = ATT_TOL[torch.bfloat16]

    def check(call, fn):
        got = [t.clone() for t in call(fn)]
        again = call(fn)
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
        return {"max_rel_err": rel, "tol": tol, "run_to_run": True}

    def library():
        ms, backend, _ = sdpa_backward_best(q, k, v, do, want, tol,
                                            causal=causal)
        return {"event_ms": ms, "backend": backend}
    nbytes = (2 * (3 * q.numel() + 2 * (k.numel() + v.numel()) + o.numel())
              + 4 * lse.numel())
    nops = 10 * B * H * valid_pairs(Sq, Skv, causal, 0) * dh
    shape = {"shape": label, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
             "KV": KV, "dh": dh, "causal": causal, "dtype": "bfloat16"}
    return (shape, call, check, bound(nbytes, nops, BF16_OPS_PER_S),
            library)


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
    cases = [("vote_aggregate", vote_case(5, 6105, 2, g)),
             ("vote_aggregate", vote_case(5, 1024, 200_064, g)),
             ("rglru_scan", rglru_case(4, 1024, 2560, g))] + [
        ("flash_attention_bwd", attention_bwd_case(*shape, g))
        for shape in (("phi4_train", 4, 512, 512, 24, 8, 128, True),
                      ("m_whisper_encoder", 8, 1500, 1500, 6, 6, 64, False),
                      ("n_whisper_cross", 8, 128, 1500, 6, 6, 64, False))]
    turns = list(enumerate(("parent", "change", "change", "parent")))
    rows = []
    for name, (shape, call, check, (b_ms, b_by), library) in cases:
        checks = {tree: check(call, fns[name])
                  for tree, fns in trees.items()}
        if library is not None:
            print(json.dumps({"kernel": "sdpa_backward", **shape,
                              **library()}), flush=True)
        for turn, tree in turns:
            fn = trees[tree][name]
            rows.append((call, fn, {
                "kernel": name, **shape, "tree": tree, "turn": turn,
                "event_ms": cuda_ms(lambda: call(fn)),
                "graph_ms": graph_ms(lambda: call(fn)),
                "bound_ms": b_ms, "bound_by": b_by, **checks[tree]}))
    for call, fn, row in rows:  # profiler last
        row["device_ms"] = device_ms(lambda: call(fn))
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
