"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # as the GPU host's check runs it
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown

Phases, each failing loudly (a failed check raises and the script exits
non-zero before printing a result):

  1. device   : the card's name, count, power limit; the five CUDA
                kernels built from ``src/repro_torch/csrc``, one nvcc
                each, all started together (-Xptxas -v report printed
                per kernel, and a summary line of the registers and
                spills of the wgmma attention and WKV kernels).
  2. kernels  : each kernel against its plain PyTorch version on the
                card, at the main paths' shapes: the vote kernel bit for
                bit on all five outputs at every shape the rounds give
                it (U 2 over all queries and, under L2, over the noisy
                query subset; cnn_L0's U 10), with noise at U 2 and 512
                over all queries, and at the token vote's (1024 queries
                over phi4-mini's vocabulary, with noise); the histogram
                kernel exact on integer weights, and on float weights
                run-to-run identical and within float32 summation's own
                limit cell by cell (a bfloat16-accumulated stand-in is
                read beside it), timed at the RF level-5 shapes and at
                every shape a GBDT round launches (teacher grid G 10,
                students G 2, final model G 1; levels 0 and 5 and the
                leaf build);
                flash attention at (a) the phi4-mini prefill, (b)
                gemma2's widths at 6144 positions with window and
                soft-cap, (c) float32 MQA, (d) recurrentgemma's local
                attention at head dim 256, (e) float32 at head dim 256;
                the RG-LRU scan at the recurrentgemma-2b prefill, at a
                ragged S = 1000 and in float32, bit for bit; the WKV
                recurrence at the rwkv6-7b prefill, from a nonzero
                state, and in float32; the others within the
                reference's kernel-test tolerances; every kernel
                identical run to run.  Times with CUDA
                events beside each kernel's bound, the plain version's
                time and one library call's where there is one (SDPA's
                fastest pinned backend, named, under the explicit mask
                and, where the window covers S, under ``is_causal``; and
                the kernel's time over the faster); the vote and
                RG-LRU kernels' device time also from 20 launches in a
                CUDA graph (their event times read the host's).
  3. round    : the one-shot FedKT round at full width (Adult's size:
                48,842 rows x 14 features; 10 parties, s=2, t=5) for RF
                and GBDT at L0 and RF at L2, through FedKTSession on
                the card; the launch counters must equal the counts the
                config implies.
  3b. fleet   : rf_L0 again through the thread (10 workers), subprocess
                (5 spawned workers, each its own CUDA context) and
                socket (journaled) transports, each bit for bit phase
                3's in-process round (server labels, vote counts,
                accuracy, epsilon, every party's frame digest, wire
                bytes); the thread and socket rounds launch K1 and K2
                from several host threads and must count exactly the
                config's launches; the subprocess round's parent only
                the server's fit.  Then the parity cell's round (n
                6000, 5 parties) as OS processes: one
                ``repro_torch.launch.federate coordinator`` and five
                ``party`` processes over TCP, whose report must equal
                the ``local`` role's; a coordinator killed between
                journaling a frame and its ACK, resumed bit for bit;
                one seeded ``--chaos`` round, bit for bit.
  4. parity   : a smaller RF round on the card and on the CPU (plain
                versions): identical server labels, accuracy, epsilon.
  4b. nn      : the neural learners at full size on the card, engine
                ``vmap``: nn_L0 (the Adult-size round with the MLP,
                hidden 64, 300 steps of batch 64), cnn_L0 (PaperCNN on
                ``digits(12,000, 16 px)``, 10 classes, 400 steps; 10
                parties, s=2, t=3) and mixed_L2 (parties cycling nn,
                rf, gbdt; an MLP final model; L2 noise): K1 and K2
                launches exactly as the roster implies, accuracy over a
                sanity floor (0.6; 0.2 for 10 classes), finite epsilon.
                nn_parity: phase 4's round with the reference's MLP
                (hidden 64, 300 steps) on the card and the CPU,
                >= 99 % equal server labels; the card's labels hold
                both classes and accuracy is above 0.75.  strategies: SOLO,
                central PATE, FedAvg, FedProx and SCAFFOLD (5 rounds)
                on ``tabular_binary(6000)`` with the MLP, each accuracy
                above 0.5.
  5. serving  : phi4-mini-3.8b at full width (random weights from a
                seeded generator, bf16) behind ``Engine(num_slots=8,
                cache_len=1024)``: 16 requests of 1-512 prompt tokens,
                32 tokens each, closed loop.  Every prefill layer must
                launch the attention kernel (32 per prefill dispatch).
                TTFT, per-token latency, tok/s, prefill ms per bucket,
                peak memory.  Three streams against solo
                ``serve_batch`` runs under the parity rule
                (``serving.compare_stream``).
  6. window   : the gemma2 smoke config in float32 (window 64, soft-cap)
                through the engine, prompts crossing the window, every
                stream against its solo ``serve_batch`` run.
  7. recurrent: recurrentgemma-2b, then rwkv6-7b, at full width (random
                weights, bf16) through ``serve_batch``: 4 prompts of
                1024 tokens, 32 tokens each.  The one prefill must
                launch one RG-LRU scan per RG-LRU layer, one attention
                kernel per local-attention layer and one WKV kernel per
                RWKV layer (18 + 8 + 0 and 0 + 0 + 32); every logit
                finite.  Prefill ms (and of 5 more prefills, their
                median), decode tok/s, peak memory.
  8. rec-parity: the recurrentgemma and rwkv6 smokes in float32 through
                ``serve_batch`` on the card (kernels) and on the CPU
                (plain versions) with the same weights, held to the
                parity rule with logits within 1e-4 of the largest; and
                prefill(P) + decode steps against prefill(P + n).
  --profile    : device time by kernel and the device's busy share of
                each full-width round (RF, GBDT, nn_L0, cnn_L0), of the
                serving runs and of one recurrent prefill
                (torch.profiler; the host-bound phases after it read
                slower than without the flag).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
where torch sees no CUDA device or the repository's sources are absent.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA cores, float32
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, bf16 dense
ADULT_ROWS, ADULT_FEATURES = 48_842, 14
ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}    # test_kernels.py


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls
    (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph and replayed between CUDA events, so no host time lies
    between the launches (each launch still pays the graph's own
    kernel-to-kernel gap)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate for their type (float32 CUDA cores
    unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(xs, q):
    return sorted(xs)[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# kernels whose registers and spills get a summary line of their own
PTXAS_KERNELS = ("flash_attention_wgmma", "wkv6_kernel")


def _kernel_label(mangled):
    """``name<args>`` of a mangled template kernel in PTXAS_KERNELS (bf16
    for __nv_bfloat16, f32 for float), else None."""
    for name in PTXAS_KERNELS:
        i = mangled.find(name + "I")
        if i < 0:
            continue
        args = mangled[i + len(name) + 1:]
        args = args[:args.find("EE") + 1]
        kind = ["bf16"] if "__nv_bfloat16" in args else (
            ["f32"] if args.startswith("f") else [])
        ints = re.findall(r"Li(\d+)E", args)
        return f"{name}<{','.join(kind + ints)}>"
    return None


def ptxas_summary(report):
    """{kernel<args>: {registers, spill_stores, spill_loads}} from an
    ``nvcc -Xptxas -v`` report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_label(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------
def phase_device():
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    t0 = time.time()
    reports = build.build()
    log(f"[device] built {sorted(reports)} in {time.time() - t0:.1f} s")
    for kname, rep in reports.items():
        for line in rep.splitlines():
            log(f"[ptxas:{kname}] {line.strip()}")
    summary = {}
    for rep in reports.values():
        summary.update(ptxas_summary(rep))
    log("[ptxas-summary] " + json.dumps(summary, sort_keys=True))
    return name, smi


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------
def teacher_bucket(data, cfg):
    """Party 0's teacher-grid bucket in the full-width round (the
    largest subset's pow2 bucket), from the round's own partition."""
    from repro_torch.core.learners import _pow2_bucket
    from repro_torch.core.partition import (dirichlet_partition,
                                            subsets_of_partition)
    parts = dirichlet_partition(data["y_train"], cfg.num_parties,
                                cfg.beta, cfg.seed)
    plan = subsets_of_partition(parts[0], cfg.num_partitions,
                                cfg.num_subsets, seed=cfg.seed)
    return _pow2_bucket(max(len(s) for p in plan for s in p))


# the L2 token vote's shape: B x S = 2 x 512 queries over phi4-mini's
# vocabulary (configs/phi4_mini_3_8b.py), with noise
TOKEN_VOTE = (5, 1024, 200_064)


def round_vote_shapes(rounds):
    """The (M, T, U, noise) shapes of the party votes the rounds give
    K1, in order, each once: t teachers over the queries a party answers
    (``query_budget``: under L2 a ``query_fraction`` of the public set,
    with noise), U the classes.  ``rounds``: (cfg, public-set size)."""
    from repro_torch.federation.party import query_budget
    shapes = []
    for cfg, num_public in rounds:
        shape = (cfg.num_subsets, query_budget(cfg, num_public)[0],
                 cfg.num_classes, cfg.privacy_level == "L2")
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def phase_votes(T, round_shapes):
    """The vote kernel bit for bit against ``ref.vote_aggregate_plain``
    on all five outputs at every shape the rounds give it
    (``round_shapes``: the tree and nn rounds' party votes, among them
    cnn_L0's 10 classes and the L2 rounds' noisy query subset), at the
    Adult round's (M 5 teachers, the T public queries) with noise at
    U 2 and U 512, and at the token vote's (``TOKEN_VOTE``).  Event
    time (20 back-to-back wrapper calls: at the round's size the host's
    enqueue) beside the device time (20 launches in a CUDA graph).  Its
    operations: an add a (query, class) and a compare a (teacher,
    query)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vote_aggregate as va
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    shapes = [(5, T, 2, False), (5, T, 2, True), (5, T, 512, True),
              (*TOKEN_VOTE, True)]
    for M, T, U, noisy in shapes + [s for s in round_shapes
                                    if s not in shapes]:
        preds = torch.randint(0, U, (M, T), device="cuda", generator=g,
                              dtype=torch.int32)
        noise = (torch.randn((T, U), device="cuda", generator=g) * 3.0
                 if noisy else None)
        got = va.vote_aggregate(preds, noise, num_classes=U)
        want = ref.vote_aggregate_plain(preds, U, noise)
        torch.cuda.synchronize()
        for name, a, b in zip(("labels", "top1", "top2", "clean1",
                               "clean2"), got, want):
            if not same_bits(a, b):
                raise AssertionError(
                    f"vote kernel != plain on {name} at M={M} T={T} "
                    f"U={U} noise={noisy}")
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        # the dispatch path the round takes
        lab, _, c1, c2 = ops.votes_with_clean(preds, U, noise)
        assert same_bits(lab, want[0]) and same_bits(c1, want[3])
        del want, got
        ms = cuda_ms(lambda: va.vote_aggregate(preds, noise,
                                               num_classes=U))
        dev = graph_ms(lambda: va.vote_aggregate(preds, noise,
                                                 num_classes=U))
        big = T * U > 1e8
        plain = cuda_ms(lambda: ref.vote_aggregate_plain(preds, U, noise),
                        reps=2 if big else 20, warmup=1 if big else 3)
        nbytes = 4 * (M * T + (T * U if noisy else 0) + 5 * T)
        b_ms, b_by = bound(nbytes, M * T + T * U)
        row = {"kernel": "vote_aggregate", "M": M, "T": T, "U": U,
               "noise": noisy, "main_path": (M, T, U, noisy) in
               round_shapes, "kernel_ms": ms, "graph_ms": dev,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "bit_identical": True}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
        del preds, noise
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, worst


def _hist_inputs(G, Gf, N, F, B, K, n, integer, g):
    xb = torch.randint(0, B, (Gf, N, F), device="cuda", generator=g,
                       dtype=torch.int32)
    node = torch.randint(0, n, (G, N), device="cuda", generator=g,
                         dtype=torch.int32)
    if integer:
        # bootstrap counts split over class channels, zero padding tail
        counts = torch.randint(0, 4, (G, N), device="cuda", generator=g)
        cls = torch.randint(0, K, (G, N), device="cuda", generator=g)
        w = torch.zeros((G, K, N), device="cuda")
        w.scatter_(1, cls[:, None], counts[:, None].float())
    else:
        w = torch.rand((G, K, N), device="cuda", generator=g) * 2 - 1
    w[:, :, N - N // 8:] = 0.0
    return xb, node, w.contiguous()


def _scatter_yardstick(xb, node, w, n, B, dtype=torch.float32):
    """One scatter_add_ over a precomputed flat index computing the same
    histogram (the nearest single-call library yardstick), accumulating
    in ``dtype``."""
    Gf, N, F = xb.shape
    G, K, _ = w.shape
    per = G // Gf
    g_ix = torch.arange(G, device="cuda")
    k_ix = torch.arange(K, device="cuda")
    f_ix = torch.arange(F, device="cuda")
    xbg = xb[g_ix // per]                                  # (G, N, F)
    idx = ((((g_ix[:, None, None, None] * K + k_ix[None, :, None, None])
             * n + node[:, None, :, None].long()) * F
            + f_ix[None, None, None, :]) * B
           + xbg[:, None].long())                          # (G,K,N,F)
    src = w[:, :, :, None].expand(G, K, N, F).to(dtype).contiguous()
    idx = idx.reshape(-1)
    src = src.reshape(-1)
    out = torch.empty((G * K * n * F * B,), dtype=dtype, device="cuda")

    def run():
        out.zero_()
        out.scatter_add_(0, idx, src)
        return out
    return run


def phase_hist(N_teacher, N_student):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tree_hist as th
    g = torch.Generator(device="cuda").manual_seed(1)
    F, B, K = ADULT_FEATURES, 32, 2
    worst = 0.0
    # RF teacher grid: 10 forests x 20 trees, every level, integer weights
    for n in (1, 2, 4, 8, 16, 32):
        xb, node, w = _hist_inputs(200, 10, N_teacher, F, B, K, n, True, g)
        got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
        want = ref.tree_hist_ref(xb, node, w, n, B)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"tree_hist != plain (integer weights) "
                                 f"at G=200 N={N_teacher} n={n}")
    # leaf build (node_hist) of the teacher grid, 2^6 leaves
    _, node, w = _hist_inputs(200, 10, N_teacher, 1, B, K, 64, True, g)
    if not torch.equal(ops.node_hist(node, w, num_nodes=64),
                       ref.node_hist_ref(node, w, 64)):
        raise AssertionError("node_hist != plain (integer weights)")
    # GBDT level: float g/h, 10 stacked GBDTs, level 5 and the leaves
    for n, Fk, Bk in ((32, F, B), (1, 1, 64)):
        xb, node, w = _hist_inputs(10, 10, N_teacher, Fk, Bk, K, n, False,
                                   g)
        a = th.tree_hist(xb, node, w, num_nodes=n, num_bins=Bk)
        b = th.tree_hist(xb, node, w, num_nodes=n, num_bins=Bk)
        torch.cuda.synchronize()
        if not same_bits(a, b):
            raise AssertionError("tree_hist float weights differ run to run")
        # each cell within what float32 summation of its own terms can
        # explain (ratio <= 1); a bfloat16-accumulated stand-in (atomic
        # adds into a bfloat16 histogram) is read beside it
        err, ratio = ref.tree_hist_f32_error(a, xb, node, w, n, Bk)
        bf16 = _scatter_yardstick(xb, node, w, n, Bk, torch.bfloat16)()
        bf_err, bf_ratio = ref.tree_hist_f32_error(
            bf16.float().reshape(a.shape), xb, node, w, n, Bk)
        log("[hist-f32] " + json.dumps({
            "G": 10, "N": N_teacher, "F": Fk, "n": n, "B": Bk,
            "max_abs_err": err, "err_over_limit": ratio,
            "bf16_standin_max_abs_err": bf_err,
            "bf16_standin_err_over_limit": str(bf_ratio)}))
        if not ratio <= 1.0:
            raise AssertionError(f"tree_hist float weights: max |err| "
                                 f"{err} is {ratio} x the float32 limit")
        worst = max(worst, err)
    # the RF level-5 shapes (2 students x 20 trees over 8192 rows; the
    # teacher grid's 10 forests x 20 trees), then every shape a GBDT
    # round launches: the teacher grid (G 10), the students (G 2) and
    # the final model (G 1), at levels 0 and 5 and at the leaf build
    rows = []
    shapes = [("student_level5", 40, 2, N_student, F, 32, B),
              ("teacher_level5", 200, 10, N_teacher, F, 32, B)]
    for who, G, N in (("gbdt_teachers", 10, N_teacher),
                      ("gbdt_students", 2, N_student),
                      ("gbdt_final", 1, N_student)):
        shapes += [(f"{who}_level0", G, G, N, F, 1, B),
                   (f"{who}_level5", G, G, N, F, 32, B),
                   (f"{who}_leaves", G, G, N, 1, 1, 64)]
    for label, G, Gf, N, Fs, n, Bs in shapes:
        xb, node, w = _hist_inputs(G, Gf, N, Fs, Bs, K, n, True, g)
        got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=Bs)
        assert torch.equal(got, ref.tree_hist_ref(xb, node, w, n, Bs))
        ms = cuda_ms(lambda: th.tree_hist(xb, node, w, num_nodes=n,
                                          num_bins=Bs))
        plain = cuda_ms(lambda: ref.tree_hist_ref(xb, node, w, n, Bs),
                        reps=5)
        lib = _scatter_yardstick(xb, node, w, n, Bs)
        assert torch.equal(lib().reshape(got.shape), got)
        lib_ms = cuda_ms(lib)
        nbytes = 4 * (Gf * N * Fs + G * N + G * K * N
                      + G * K * n * Fs * Bs)
        b_ms, b_by = bound(nbytes, G * K * N * Fs)
        row = {"kernel": "tree_hist", "shape": label, "G": G, "Gf": Gf,
               "N": N, "F": Fs, "K": K, "n": n, "B": Bs, "kernel_ms": ms,
               "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "kernel_over_library": ms / lib_ms,
               "bytes": nbytes, "plan": list(th.plan(N, Fs, K, n, Bs))}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
    torch.cuda.synchronize()
    return rows, worst


def valid_keys(Sq, Skv, causal, window, q_offset=0):
    """(query, key) pairs the mask lets through: the work this input
    needs."""
    q = np.arange(Sq) + q_offset
    hi = np.minimum(q + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_best(qt, kt, vt, **kw):
    """The fastest of SDPA's backends that take the call, each pinned
    with ``sdpa_kernel``: (ms, backend, output).  K/V are expanded to
    q's heads outside the timed call where a backend refuses
    ``enable_gqa`` (the backend is then named ``...+expanded_kv``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = qt.shape[1] // kt.shape[1]
    expanded = (kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1))
    best = None
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        for args, extra, label in (
                ((qt, kt, vt), {"enable_gqa": True}, name.lower()),
                ((qt,) + expanded, {}, name.lower() + "+expanded_kv")):
            def call(args=args, extra=extra):
                return F.scaled_dot_product_attention(*args, **kw, **extra)
            with sdpa_kernel([backend]):
                try:
                    out = call()
                    torch.cuda.synchronize()
                except RuntimeError:
                    continue
                ms = cuda_ms(call, reps=10)
            if best is None or ms < best[0]:
                best = (ms, label, out)
            break
    if best is None:
        raise AssertionError("no SDPA backend takes the call")
    return best


def phase_attention():
    """Flash attention against ``ref.attention_ref`` at (a) the phi4-mini
    prefill, (b) gemma2-27b's widths, (c) float32 MQA, (d) recurrentgemma's
    local attention (dh 256), (e) float32 at dh 256.  The library
    yardstick is SDPA's fastest backend under the explicit causal+window
    mask where there is a window, and under ``is_causal`` where the
    window is absent or covers S (then the mask IS the causal mask);
    ``library_ms`` is the faster of the two."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # label, B, S, H, KV, dh, dtype, window, softcap, library
        ("a_phi4_prefill", 8, 512, 24, 8, 128, torch.bfloat16, 0, 0.0,
         True),
        ("b_gemma2_window", 1, 6144, 32, 16, 128, torch.bfloat16, 4096,
         50.0, False),
        ("c_f32_mqa", 2, 384, 8, 1, 128, torch.float32, 0, 0.0, True),
        ("d_recurrentgemma_local", 4, 1024, 10, 1, 256, torch.bfloat16,
         2048, 0.0, True),
        ("e_f32_dh256", 2, 300, 4, 1, 256, torch.float32, 64, 0.0, True),
    ]
    rows, worst = [], 0.0
    for label, B, S, H, KV, dh, dt, window, cap, lib in cases:
        q = torch.randn((B, S, H, dh), device="cuda", generator=g).to(dt)
        k = torch.randn((B, S, KV, dh), device="cuda", generator=g).to(dt)
        v = torch.randn((B, S, KV, dh), device="cuda", generator=g).to(dt)
        kw = dict(causal=True, window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention differs run to run at "
                                 f"{label}")
        err = float((got.float() - want.float()).abs().max())
        tol = ATT_TOL[dt]
        if not torch.allclose(got.float(), want.float(), atol=tol,
                              rtol=tol):
            raise AssertionError(f"flash_attention != plain at {label}: "
                                 f"max |err| {err}")
        worst = max(worst, err)
        del want
        p = fa.plan(dh, dt)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=10)
        plain = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), reps=3,
                        warmup=1)
        yardsticks = {}
        if lib:   # SDPA computes the same function only without soft-cap
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window:   # the causal window as an explicit mask
                mask = ref._mask(torch.arange(S, device="cuda"), S, True,
                                 window, "cuda")
                yardsticks["explicit_mask"] = sdpa_best(qt, kt, vt,
                                                        attn_mask=mask)
            if not window or window >= S:
                yardsticks["is_causal"] = sdpa_best(qt, kt, vt,
                                                    is_causal=True)
            for _, _, out in yardsticks.values():
                torch.testing.assert_close(out.transpose(1, 2).float(),
                                           got.float(), atol=tol, rtol=tol)
        fastest = min(yardsticks.values(), key=lambda y: y[0],
                      default=None)
        lib_ms = None if fastest is None else fastest[0]
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        nops = 4 * B * H * valid_keys(S, S, True, window) * dh
        b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S
                           if dt == torch.bfloat16 else FP32_OPS_PER_S)
        row = {"kernel": "flash_attention", "shape": label, "B": B, "S": S,
               "H": H, "KV": KV, "dh": dh, "dtype": str(dt),
               "window": window, "softcap": cap, "max_abs_err": err,
               "tol": tol, "plan": p._asdict(), "kernel_ms": ms,
               "plain_ms": plain,
               "library_ms": lib_ms,
               "library_backend": None if fastest is None else fastest[1],
               "library_variants": {n: {"ms": y[0], "backend": y[1]}
                                    for n, y in yardsticks.items()},
               "bound_ms": b_ms, "bound_by": b_by,
               "kernel_over_library": None if lib_ms is None
               else ms / lib_ms, "bound_share": b_ms / ms,
               "bytes": nbytes, "flop": nops}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
        del q, k, v, got, again, yardsticks
        torch.cuda.empty_cache()
    return rows, worst


def _rec_row(kernel, label, shape, dt, err, tol, ms, plain, nbytes, nops):
    b_ms, b_by = bound(nbytes, nops)
    row = {"kernel": kernel, "shape": label, **shape, "dtype": str(dt),
           "max_abs_err": err, "tol": tol, "kernel_ms": ms,
           "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "ops": nops,
           "bit_identical_run_to_run": True}
    log("[kernel] " + json.dumps(row))
    return row


def phase_rglru():
    """The RG-LRU scan against ``ref.rglru_scan_ref``, bit for bit, at
    the recurrentgemma-2b prefill (4 x 1024 x 2560, bf16), at a ragged S
    and in float32, from a nonzero h0.  Its operations: exp, multiply,
    add per element."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [("recurrentgemma_prefill", 4, 1024, 2560, torch.bfloat16),
             ("ragged_S1000", 4, 1000, 2560, torch.bfloat16),
             ("f32_small", 2, 1000, 512, torch.float32)]
    rows, worst = [], 0.0
    for label, B, S, D, dt in cases:
        x = torch.randn((B, S, D), device="cuda", generator=g).to(dt)
        log_a = (-torch.rand((B, S, D), device="cuda", generator=g)
                 * 0.1).to(dt)
        h0 = torch.randn((B, D), device="cuda", generator=g) * 0.5
        h, hl = rg.rglru_scan(x, log_a, h0)
        h2, hl2 = rg.rglru_scan(x, log_a, h0)
        want_h, want_hl = ref.rglru_scan_ref(x, log_a, h0)
        torch.cuda.synchronize()
        if not (torch.equal(h, h2) and same_bits(hl, hl2)):
            raise AssertionError(f"rglru_scan differs run to run at {label}")
        err = max(float((h.float() - want_h.float()).abs().max()),
                  float((hl - want_hl).abs().max()))
        if not (same_bits(h.float(), want_h.float())
                and same_bits(hl, want_hl)):
            raise AssertionError(f"rglru_scan != plain bit for bit at "
                                 f"{label}: max |err| {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: rg.rglru_scan(x, log_a, h0))
        dev = graph_ms(lambda: rg.rglru_scan(x, log_a, h0))
        plain = cuda_ms(lambda: ref.rglru_scan_ref(x, log_a, h0), reps=3,
                        warmup=1)
        nbytes = x.element_size() * 3 * x.numel() + 4 * 2 * B * D
        rows.append(_rec_row("rglru_scan", label,
                             {"B": B, "S": S, "D": D, "graph_ms": dev},
                             dt, err, 0.0, ms, plain, nbytes, 3 * B * S * D))
    return rows, worst


def phase_wkv():
    """The WKV recurrence against ``ref.wkv6_ref`` at the rwkv6-7b
    prefill (4 x 1024 x 64 heads x 64, bf16) from the zero state, from a
    nonzero state, and in float32.  Its operations: at least three
    float32 instructions per state element per step (k_i v_j, the
    state's multiply-add, the output's multiply-add), counted as 6 at
    the 67 TFLOP/s that counts an FMA as 2."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [("rwkv6_prefill", 4, 1024, 64, torch.bfloat16, False),
             ("rwkv6_prefill_nonzero_s0", 4, 1024, 64, torch.bfloat16, True),
             ("f32_small", 2, 200, 8, torch.float32, True)]
    rows, worst = [], 0.0
    dh = 64
    for label, B, S, H, dt, nonzero in cases:
        r, k, v = (torch.randn((B, S, H, dh), device="cuda", generator=g)
                   .mul(0.5).to(dt) for _ in range(3))
        w = torch.sigmoid(torch.randn((B, S, H, dh), device="cuda",
                                      generator=g)).to(dt)
        u = torch.randn((H, dh), device="cuda", generator=g) * 0.1
        s0 = (torch.randn((B, H, dh, dh), device="cuda", generator=g) * 0.1
              if nonzero else torch.zeros((B, H, dh, dh), device="cuda"))
        o, sl = wk.wkv6(r, k, v, w, u, s0)
        o2, sl2 = wk.wkv6(r, k, v, w, u, s0)
        want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and same_bits(sl, sl2)):
            raise AssertionError(f"wkv6 differs run to run at {label}")
        err = max(float((o.float() - want_o.float()).abs().max()),
                  float((sl - want_s).abs().max()))
        tol = WKV_TOL[dt]
        if not (torch.allclose(o.float(), want_o.float(), atol=tol,
                               rtol=tol)
                and torch.allclose(sl, want_s, atol=tol, rtol=tol)):
            raise AssertionError(f"wkv6 != plain at {label}: max |err| "
                                 f"{err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: wk.wkv6(r, k, v, w, u, s0))
        p = wk.plan(S)
        del want_o, want_s
        plain = cuda_ms(lambda: ref.wkv6_ref(r, k, v, w, u, s0), reps=2,
                        warmup=1)
        nbytes = (r.element_size() * 5 * r.numel() + 4 * u.numel()
                  + 4 * 2 * s0.numel())
        row = _rec_row("wkv6", label, {"B": B, "S": S, "H": H, "dh": dh,
                                       "plan": p._asdict()},
                       dt, err, tol, ms, plain, nbytes,
                       6 * B * S * H * dh * dh)
        rows.append(row)
        del r, k, v, w, o, o2
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------
def expected_launches(cfg, kinds, final, depth=6, rounds=30):
    """Launch counts the config implies for one vmap round whose parties
    bind the learner ``kinds`` ("rf" | "gbdt" | "nn", one a party) and
    whose final model is a ``final``: every stacked tree fit runs one
    histogram launch per level and one per leaf build (per boosting
    round for GBDT), for each party's teacher grid and its s students,
    plus the final model; an nn fit launches none.  One vote launch per
    partition per party, whatever its learner."""
    def per_fit(kind):
        if kind == "nn":
            return 0
        return (depth + 1) * (rounds if kind == "gbdt" else 1)
    hist = sum(2 * per_fit(k) for k in kinds) + per_fit(final)
    votes = cfg.num_parties * cfg.num_partitions
    return hist, votes


def run_round(learner, data, cfg, device, engine="vmap",
              transport="inprocess", parallelism=None):
    from repro_torch.federation import FedKTSession
    sess = FedKTSession(learner, data, cfg, engine=engine, device=device,
                        transport=transport, parallelism=parallelism)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    res = sess.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.time() - t0


def tree_rounds():
    """The full-width tree rounds, each (name, learner, cfg, learner
    kind, depth, boosting rounds)."""
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import GBDTLearner, RFLearner
    return [("rf_L0", RFLearner(num_classes=2), FedKTConfig(num_classes=2),
             "rf", 6, 1),
            ("gbdt_L0", GBDTLearner(), FedKTConfig(num_classes=2),
             "gbdt", 6, 30),
            ("rf_L2", RFLearner(num_classes=2),
             FedKTConfig(num_classes=2, privacy_level="L2", gamma=0.1,
                         query_fraction=0.2), "rf", 6, 1)]


def phase_round(data):
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    runs = tree_rounds()
    totals = {"tree_hist": 0, "vote_aggregate": 0}
    rows, results = [], {}
    for name, learner, cfg, kind, depth, rounds in runs:
        torch.cuda.reset_peak_memory_stats()
        th.launches = 0
        va.launches = 0
        res, secs = run_round(learner, data, cfg, "cuda")
        got = (th.launches, va.launches)
        want = expected_launches(cfg, [kind] * cfg.num_parties, kind,
                                 depth, rounds)
        labels = next(iter(res.by_domain.values()))["labels"]
        row = {"round": name, "accuracy": res.accuracy,
               "epsilon": res.epsilon, "wall_s": secs,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "tree_hist_launches": got[0], "vote_launches": got[1],
               "expected": list(want), "party_s": res.meta["seconds"],
               "wire_bytes": res.meta["wire_bytes"]["updates"]}
        log("[round] " + json.dumps(row))
        if got != want:
            raise AssertionError(f"{name}: launches {got} != {want}")
        if labels.shape != (len(data["X_public"]),) or \
                not set(np.unique(labels)) <= {0, 1}:
            raise AssertionError(f"{name}: bad server labels")
        if not (0.6 < res.accuracy <= 1.0):
            raise AssertionError(f"{name}: accuracy {res.accuracy}")
        if cfg.privacy_level == "L2" and not np.isfinite(res.epsilon):
            raise AssertionError(f"{name}: epsilon {res.epsilon}")
        totals["tree_hist"] += got[0]
        totals["vote_aggregate"] += got[1]
        rows.append(row)
        results[name] = res
    return rows, totals, results


# ---------------------------------------------------------------------------
# Phase 3b: the fleet
# ---------------------------------------------------------------------------
# the parity cell's round through the launcher's flags (n 6000, 5
# parties, s 2, t 4, RF 16 trees of depth 5)
FLEET_FLAGS = ["--parties", "5", "--partitions", "2", "--subsets", "4",
               "--n-train", "6000", "--learner", "rf", "--trees", "16",
               "--depth", "5", "--engine", "vmap", "--seed", "0"]


def same_round(name, got, want):
    """Raises unless two rounds agree bit for bit: server labels, vote
    counts, accuracy, epsilon, every party's frame digest and the wire
    bytes."""
    (g,), (w,) = ([row["vote"] for row in res.by_domain.values()]
                  for res in (got, want))
    checks = {
        "labels": torch.equal(g.labels.cpu(), w.labels.cpu()),
        "counts": torch.equal(g.counts.cpu(), w.counts.cpu()),
        "accuracy": got.accuracy == want.accuracy,
        "epsilon": got.epsilon == want.epsilon,
        "frames": got.meta["frame_sha256"] == want.meta["frame_sha256"],
        "wire_bytes": got.meta["wire_bytes"] == want.meta["wire_bytes"]}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{name}: differs from the in-process round "
                             f"in {bad}")


def phase_fleet(data, base, smi):
    """rf_L0 through the thread, subprocess and socket transports on the
    card, each against phase 3's in-process card round (``base``).  The
    thread and socket rounds launch K1 and K2 from several host threads
    of this process, so their counters must equal the config's counts
    exactly; a subprocess round's parties launch in their own processes
    (and the parent only the server's final fit).  Returns the launches
    of the rounds this process counted."""
    from repro_torch.federation import SocketTransport
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    name, learner, cfg, kind, depth, rounds = tree_rounds()[0]
    want = expected_launches(cfg, [kind] * cfg.num_parties, kind, depth,
                             rounds)
    journal = os.path.join(ROOT, "build", "fleet_rf_L0.jrnl")
    if os.path.exists(journal):
        os.unlink(journal)
    totals = {"tree_hist": 0, "vote_aggregate": 0}
    for tname, transport, par in (
            ("thread", "thread", 10), ("subprocess", "subprocess", 5),
            ("socket", SocketTransport(parallelism=10,
                                       journal_path=journal), None)):
        th.launches = va.launches = 0
        res, secs = run_round(learner, data, cfg, "cuda",
                              transport=transport, parallelism=par)
        got = (th.launches, va.launches)
        row = {"fleet": f"{name}_{tname}", "wall_s": secs,
               "seconds": res.meta["seconds"], "launches": list(got),
               "expected": list(want), "accuracy": res.accuracy,
               "wire_bytes": res.meta["wire_bytes"]["updates"],
               "card": smi}
        if tname == "socket":
            sock = res.meta["socket"]
            row["arrived"] = len(sock["arrived"])
            row["dropped"] = sock["dropped"]
        log("[fleet] " + json.dumps(row))
        same_round(f"{name} {tname}", res, base)
        if tname == "subprocess":
            # the parties ran in the workers, on the card (a worker
            # without a card raises; nothing falls back)
            want_here = (expected_launches(cfg, [], kind, depth,
                                           rounds)[0], 0)
        else:
            want_here = want
            totals["tree_hist"] += got[0]
            totals["vote_aggregate"] += got[1]
        if got != want_here:
            raise AssertionError(f"{name} {tname}: launches {got} != "
                                 f"{want_here}")
        if tname == "socket" and (row["arrived"] != cfg.num_parties
                                  or row["dropped"]):
            raise AssertionError(f"{name} socket: {row}")
    return totals


def _report_json(text):
    """The launcher's JSON report: everything from its first brace."""
    out = json.loads(text[text.index("{"):])
    out.pop("seconds")
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_fleet_processes(smi):
    """The parity cell's round as separate OS processes on the card:
    one ``repro_torch.launch.federate coordinator`` and five ``party``
    processes over TCP, against the ``local`` role in this process; a
    coordinator killed between journaling party 0's frame and its ACK,
    then resumed, against the uninterrupted round; one seeded chaos
    round (``--chaos``)."""
    import contextlib
    import io
    from repro_torch.federation import (FaultPlan, QuorumError,
                                        SocketTransport)
    from repro_torch.launch import federate
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        federate.main(["local", "--port", "0", *FLEET_FLAGS])
    local_s = time.time() - t0
    local = _report_json(buf.getvalue())

    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.federate"]
    common = ["--port", port, *FLEET_FLAGS]
    t0 = time.time()
    procs = [subprocess.Popen(cmd + ["coordinator", *common,
                                     "--deadline-s", "300"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT)]
    procs += [subprocess.Popen(cmd + ["party", "--party-id", str(i),
                                      "--retries", "12", *common],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env,
                               cwd=ROOT) for i in range(5)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    fleet_s = time.time() - t0
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"fleet process {p.args[3:5]} exited "
                                 f"{p.returncode}:\n{out}\n{err}")
    coord = _report_json(outs[0][0])
    log("[fleet] " + json.dumps({
        "fleet": "parity_processes", "local_wall_s": local_s,
        "processes_wall_s": fleet_s, "arrived": coord["arrived"],
        "dropped": coord["dropped_parties"],
        "accuracy": coord["accuracy"], "epsilon": coord["epsilon"],
        "wire_bytes": coord["wire_bytes"]["updates"], "card": smi}))
    if coord != local or coord["arrived"] != 5 or coord["dropped_parties"]:
        raise AssertionError(f"coordinator + 5 parties {coord} != the "
                             f"local role {local}")

    # kill and resume, then a seeded chaos round: sessions built from
    # the same flags, against the uninterrupted in-process round
    args = federate.parse_args(["local", *FLEET_FLAGS])
    base = federate.build_session(args, "inprocess").run()
    journal = os.path.join(ROOT, "build", "fleet_crash.jrnl")
    if os.path.exists(journal):
        os.unlink(journal)
    plan = FaultPlan(kill_coordinator_on_party=0)
    t0 = time.time()
    try:
        federate.build_session(args, SocketTransport(
            parallelism=1, journal_path=journal, chaos_plan=plan,
            connect_retries=2, backoff_s=0.01)).run()
        raise AssertionError("the killed coordinator's round finished")
    except QuorumError:
        pass
    crash_s = time.time() - t0
    t0 = time.time()
    res = federate.build_session(args, SocketTransport(
        parallelism=5, journal_path=journal, resume=True)).run()
    resume_s = time.time() - t0
    sock = res.meta["socket"]
    log("[fleet] " + json.dumps({
        "fleet": "parity_kill_resume", "crash_wall_s": crash_s,
        "resume_wall_s": resume_s, "replayed": sock["replayed_parties"],
        "killed_log": plan.log, "card": smi}))
    same_round("parity kill/resume", res, base)
    if sock["replayed_parties"] != [0] or not sock["resumed"]:
        raise AssertionError(f"resume replayed {sock['replayed_parties']}")

    args.chaos, args.chaos_seed = True, 4
    chaos = federate._chaos_plan(args)
    t0 = time.time()
    res = federate.build_session(args, SocketTransport(
        chaos_plan=chaos)).run()
    log("[fleet] " + json.dumps({
        "fleet": "parity_chaos", "wall_s": time.time() - t0,
        "chaos": res.meta["socket"]["chaos"], "card": smi}))
    same_round("parity chaos", res, base)
    if not res.meta["socket"]["chaos"]:
        raise AssertionError("the chaos plan fired no fault")


def phase_parity():
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import RFLearner
    from repro_torch.data.synthetic import tabular_binary
    data = tabular_binary(n=6000, seed=0)
    cfg = FedKTConfig(num_parties=5, num_partitions=2, num_subsets=4,
                      num_classes=2, beta=0.5)
    learner = RFLearner(num_classes=2, num_trees=16, depth=5)
    card, t_card = run_round(learner, data, cfg, "cuda")
    cpu, t_cpu = run_round(learner, data, cfg, "cpu")
    lc = next(iter(card.by_domain.values()))["labels"]
    lp = next(iter(cpu.by_domain.values()))["labels"]
    row = {"parity": "rf_bench_row", "card_accuracy": card.accuracy,
           "cpu_accuracy": cpu.accuracy, "card_epsilon": card.epsilon,
           "cpu_epsilon": cpu.epsilon, "labels_equal": bool(
               np.array_equal(lc, lp)), "card_s": t_card, "cpu_s": t_cpu}
    log("[parity] " + json.dumps(row))
    if not (row["labels_equal"] and card.accuracy == cpu.accuracy
            and card.epsilon == cpu.epsilon):
        raise AssertionError("card and CPU rounds disagree")


# ---------------------------------------------------------------------------
# Phase 4b: the neural learners and the paper's baselines
# ---------------------------------------------------------------------------
def nn_rounds(data):
    """The full-size nn rounds, each {name, learner (or a roster of
    bindings), final learner, data, cfg, each party's learner kind}:
    the Adult-size MLP round, the paper's digits CNN round
    (``benchmarks/common.py``'s ``--full`` task) and a mixed nn/rf/gbdt
    roster under L2 with an MLP final model."""
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import GBDTLearner, NNLearner, RFLearner
    from repro_torch.data.synthetic import digits
    from repro_torch.federation import PartyBinding
    from repro_torch.models.smallnets import MLP, PaperCNN
    mlp = NNLearner(MLP(ADULT_FEATURES, 2), num_classes=2)
    cnn = NNLearner(PaperCNN(16, 1, 10), num_classes=10, steps=400)
    by_kind = {"nn": mlp, "rf": RFLearner(num_classes=2),
               "gbdt": GBDTLearner()}
    kinds = (["nn", "rf", "gbdt"] * 4)[:10]
    return [
        dict(name="nn_L0", learner=mlp, final=mlp, data=data,
             cfg=FedKTConfig(num_classes=2), kinds=["nn"] * 10),
        dict(name="cnn_L0", learner=cnn, final=cnn,
             data=digits(n=12_000, image_size=16, seed=0),
             cfg=FedKTConfig(num_parties=10, num_partitions=2,
                             num_subsets=3, num_classes=10, beta=0.5,
                             seed=0), kinds=["nn"] * 10),
        dict(name="mixed_L2", learner=[PartyBinding(by_kind[k])
                                       for k in kinds],
             final=mlp, data=data,
             cfg=FedKTConfig(num_classes=2, privacy_level="L2", gamma=0.1,
                             query_fraction=0.2), kinds=kinds),
    ]


def phase_nn_rounds(rounds):
    """The full-size nn rounds (``nn_rounds``) through FedKTSession on
    the card (engine ``vmap``): host wall after a synchronise, peak
    memory, accuracy, epsilon; the launch counts must be those the
    roster implies (K1 a (party, partition), K2 only for tree fits)."""
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    totals = {"tree_hist": 0, "vote_aggregate": 0}
    for r in rounds:
        name, d, cfg = r["name"], r["data"], r["cfg"]
        sess = FedKTSession(r["learner"], d, cfg, engine="vmap",
                            final_learner=r["final"], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        th.launches = 0
        va.launches = 0
        t0 = time.time()
        res = sess.run()
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = (th.launches, va.launches)
        want = expected_launches(cfg, r["kinds"], "nn")
        labels = next(iter(res.by_domain.values()))["labels"]
        row = {"round": name, "accuracy": res.accuracy,
               "epsilon": res.epsilon, "wall_s": secs,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "tree_hist_launches": got[0], "vote_launches": got[1],
               "expected": list(want), "party_s": res.meta["seconds"],
               "wire_bytes": res.meta["wire_bytes"]["updates"],
               "bindings": sorted({b["learner"] for b in
                                   res.meta["party_bindings"]})}
        log("[nn-round] " + json.dumps(row))
        if got != want:
            raise AssertionError(f"{name}: launches {got} != {want}")
        if labels.shape != (len(d["X_public"]),) or \
                not set(np.unique(labels)) <= set(range(cfg.num_classes)):
            raise AssertionError(f"{name}: bad server labels")
        floor = 0.2 if cfg.num_classes == 10 else 0.6
        if not (floor < res.accuracy <= 1.0):
            raise AssertionError(f"{name}: accuracy {res.accuracy}")
        if cfg.privacy_level == "L2" and not np.isfinite(res.epsilon):
            raise AssertionError(f"{name}: epsilon {res.epsilon}")
        totals["tree_hist"] += got[0]
        totals["vote_aggregate"] += got[1]
    return totals


def phase_nn_parity():
    """The reference's nn learner (MLP hidden 64, 300 steps) in phase
    4's round, on the card and on the CPU: not bit for bit (cuBLAS and
    the CPU round otherwise and Adam amplifies it), so >= 99 % equal
    server labels and accuracy within 0.01.  The model must learn (both
    classes among the card's labels, accuracy above 0.75; the CPU
    reaches 0.832), or equal labels would say little."""
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import NNLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.models.smallnets import MLP
    data = tabular_binary(n=6000, seed=0)
    cfg = FedKTConfig(num_parties=5, num_partitions=2, num_subsets=4,
                      num_classes=2, beta=0.5)
    learner = NNLearner(MLP(ADULT_FEATURES, 2), num_classes=2)
    card, t_card = run_round(learner, data, cfg, "cuda")
    cpu, t_cpu = run_round(learner, data, cfg, "cpu")
    lc = next(iter(card.by_domain.values()))["labels"]
    lp = next(iter(cpu.by_domain.values()))["labels"]
    share = float((lc == lp).mean())
    row = {"parity": "nn_mlp_h64", "labels_equal_share": share,
           "card_accuracy": card.accuracy, "cpu_accuracy": cpu.accuracy,
           "card_label_counts": np.bincount(lc, minlength=2).tolist(),
           "card_s": t_card, "cpu_s": t_cpu}
    log("[nn-parity] " + json.dumps(row))
    if len(np.unique(lc)) < 2 or not card.accuracy > 0.75:
        raise AssertionError(f"the card's nn round did not learn: {row}")
    if share < 0.99 or abs(card.accuracy - cpu.accuracy) > 0.01:
        raise AssertionError(f"card and CPU nn rounds disagree: {row}")
    return row


def phase_strategies():
    """The paper's baselines on ``tabular_binary(n=6000)`` with the MLP
    on the card: SOLO, central PATE, and FedAvg / FedProx / SCAFFOLD
    for 5 rounds.  Accuracy and host wall of each."""
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.baselines import IterConfig
    from repro_torch.core.learners import NNLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import (CentralPATEStrategy,
                                        IterativeStrategy, SoloStrategy)
    from repro_torch.models.smallnets import MLP
    data = tabular_binary(n=6000, seed=0)
    cfg = FedKTConfig(num_classes=2)
    learner = NNLearner(MLP(ADULT_FEATURES, 2), num_classes=2)
    runs = [SoloStrategy(learner), CentralPATEStrategy(learner)] + [
        IterativeStrategy(MLP(ADULT_FEATURES, 2),
                          IterConfig(algo=algo, rounds=5))
        for algo in ("fedavg", "fedprox", "scaffold")]
    rows = []
    for strategy in runs:
        torch.cuda.synchronize()
        t0 = time.time()
        res = strategy.run(data, cfg)
        torch.cuda.synchronize()
        row = {"strategy": res.name, "accuracy": res.accuracy,
               "wall_s": time.time() - t0,
               "acc_per_round": res.meta.get("acc_per_round")}
        log("[strategy] " + json.dumps(row))
        if not (np.isfinite(res.accuracy) and res.accuracy > 0.5):
            raise AssertionError(f"{res.name}: accuracy {res.accuracy}")
        rows.append(row)
    return rows


def _profiled(name, fn):
    """Runs ``fn`` under torch.profiler and logs device time by kernel
    and the device's busy share of the wall time (profiler overhead
    included in the wall; kernels that overlap would count twice, but
    everything here runs on one stream)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        secs = time.time() - t0
    from torch.autograd import DeviceType
    # device-side events only (kernels, memcpy, memset): an aten op's
    # device time is its kernels' time, which would count twice
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log("[profile] " + json.dumps({
        "run": name, "wall_s": secs, "device_busy_s": busy,
        "busy_share": busy / secs,
        "top": [{"name": k[:60], "device_ms": us / 1e3, "calls": c}
                for us, k, c in rows[:10]]}))


def phase_profile(data):
    """``--profile``: where the time of each full-width round goes (the
    RF and GBDT rounds, and the nn_L0 and cnn_L0 rounds).  The nn
    rounds are profiled at a tenth of their steps a fit: every step of
    a fit is the same work, and the profiler's record of the whole
    round's million launches takes longer to read than the script's
    time limit."""
    import dataclasses

    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import GBDTLearner, RFLearner
    cfg = FedKTConfig(num_classes=2)
    runs = [("rf_L0", RFLearner(num_classes=2), data, cfg),
            ("gbdt_L0", GBDTLearner(), data, cfg)]
    for r in nn_rounds(data):
        if r["name"] in ("nn_L0", "cnn_L0"):
            lrn = r["learner"]
            runs.append((r["name"] + "_steps_div10", dataclasses.replace(
                lrn, steps=lrn.steps // 10), r["data"], r["cfg"]))
    for name, learner, d, cfg in runs:
        run_round(learner, d, cfg, "cuda")          # warm
        _profiled(name, lambda: run_round(learner, d, cfg, "cuda"))


# ---------------------------------------------------------------------------
# Phases 5 and 6: serving
# ---------------------------------------------------------------------------
def serve_prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (int(m),)).astype(np.int32)
            for m in lens]


def hold_to_serial(model, params, results, prompts, idx, rtol):
    """Streams ``idx`` of an engine run (kept logits) against solo
    ``serve_batch`` runs of the same prompts, under the parity rule:
    identical, or first differing at a step whose reference top-1 minus
    top-2 gap the measured logit difference can flip.  Returns the
    comparisons; raises where the rule fails or the logits are further
    apart than ``rtol`` of the largest reference logit."""
    from repro_torch.serving import compare_stream, serve_batch
    out = []
    for i in idx:
        r = results[i]
        toks, stats = serve_batch(model, params, prompts[i][None],
                                  r.num_tokens, verbose=False,
                                  keep_logits=True)
        ref_logits = stats["logits"][0]
        info = compare_stream(r.tokens, r.logits, toks[0].tolist(),
                              ref_logits)
        info["rid"] = i
        info["logit_scale"] = float(ref_logits.abs().max())
        if not bool(torch.isfinite(ref_logits).all()):
            raise AssertionError(f"stream {i}: non-finite logits")
        if not info["explained"] or \
                info["max_diff"] > rtol * info["logit_scale"]:
            raise AssertionError(f"stream {i} breaks the parity rule: "
                                 f"{info}")
        out.append(info)
    return out


def serve_run(model, params, prompts, max_tokens, device, keep_logits,
              **engine_kw):
    """Warms an engine on the prompts' buckets, zeroes the kernel's
    launch count, serves the prompts closed loop.  Returns (engine,
    results, wall seconds, launches, peak bytes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import Engine
    eng = Engine(model, params, device=device, keep_logits=keep_logits,
                 **engine_kw)
    eng.warmup(buckets=[len(p) for p in prompts])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    res = eng.serve(prompts, max_tokens=max_tokens)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return eng, res, wall, launches, peak


def serving_metrics(eng, res, wall):
    lats = [t for r in res for t in r.timing["token_latencies"][1:]]
    ttft = [r.timing["ttft"] for r in res]
    toks = sum(r.num_tokens for r in res)
    return {"streams": len(res), "tokens": toks, "wall_s": wall,
            "tok_per_s": toks / wall,
            "ttft_s": {"p50": percentile(ttft, .5),
                       "p95": percentile(ttft, .95), "max": max(ttft)},
            "token_latency_ms": {"p50": percentile(lats, .5) * 1e3,
                                 "p95": percentile(lats, .95) * 1e3},
            "dispatches": dict(eng.dispatches),
            "prefill_ms_by_bucket": {
                f"{b}x{n}": [1e3 * s for s in secs]
                for (b, n), secs in sorted(eng.prefill_seconds.items())}}


def phase_serving(cfg, lens, device="cuda", max_tokens=32, num_slots=8,
                  cache_len=1024, compare=3, rtol=0.25, profile=False):
    """The serving path at ``cfg``'s widths: a timed engine run over
    prompts of ``lens`` tokens, then a replay that keeps logits (it must
    give the same streams), then ``compare`` streams held to solo
    serve_batch runs."""
    from repro_torch.models import Model
    model = Model(cfg)
    dev = torch.device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompts = serve_prompts(cfg, lens)
    n_requests = len(prompts)
    kw = dict(num_slots=num_slots, cache_len=cache_len)
    eng, res, wall, launches, peak = serve_run(
        model, params, prompts, max_tokens, device, False, **kw)
    m = serving_metrics(eng, res, wall)
    m.update({"arch": cfg.name, "dtype": cfg.dtype,
              "attention_launches": launches, "peak_mem_bytes": peak})
    log("[serve] " + json.dumps(m))
    if len(res) != n_requests or any(
            r.num_tokens != max_tokens or r.finish_reason != "length"
            for r in res):
        raise AssertionError("a request did not complete its budget")
    want = cfg.num_layers * eng.dispatches["prefill"]
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"attention launches {launches} != {want} "
                             f"(layers x prefill dispatches)")
    if any(not 0 <= t < cfg.vocab_size for r in res for t in r.tokens):
        raise AssertionError("token id out of the vocabulary")
    del eng
    _, replay, _, _, _ = serve_run(model, params, prompts, max_tokens,
                                   device, True, **kw)
    if [r.tokens for r in replay] != [r.tokens for r in res]:
        raise AssertionError("the engine's streams differ run to run")
    checks = hold_to_serial(model, params, replay, prompts,
                            range(compare), rtol)
    log("[serve-parity] " + json.dumps({
        "arch": cfg.name, "compared": len(checks),
        "matched_whole": sum(c["match"] for c in checks),
        "streams": checks}))
    if profile:
        eng, _, _, _, _ = serve_run(model, params, prompts[:num_slots],
                                    max_tokens, device, False, **kw)
        for p in prompts[num_slots:]:
            eng.submit(p, max_tokens)
        _profiled(f"serve_{cfg.name}", eng.run)
    return m, launches


def phase_window(device="cuda"):
    """gemma2's sliding window and soft-caps at the smoke widths in
    float32: prompts shorter and longer than the 64-key window."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("gemma2-27b").replace(dtype="float32",
                                          param_dtype="float32")
    return phase_serving(cfg, [30, 70, 100, 129, 64, 5], device,
                         max_tokens=8, num_slots=2, cache_len=256,
                         compare=6, rtol=1e-4)


# ---------------------------------------------------------------------------
# Phases 7 and 8: recurrent serving
# ---------------------------------------------------------------------------
LAUNCH_KINDS = {"rglru_scan": ("rglru",), "wkv6": ("rwkv",),
                "flash_attention": ("attn", "attn_local")}


def _kernel_modules():
    from repro_torch.kernels import flash_attention, rglru_scan, wkv6
    return {"rglru_scan": rglru_scan, "wkv6": wkv6,
            "flash_attention": flash_attention}


def phase_recurrent_serving(cfg, device="cuda", batch=4, prompt_len=1024,
                            gen=32, reps=5, profile=False):
    """``serve_batch`` at ``cfg``'s widths: a short warm-up, then one
    timed run over ``batch`` prompts of ``prompt_len`` tokens with the
    launch counts zeroed just before it.  Its one prefill must launch
    one kernel per layer of the kernel's kinds (on the card).  Then
    ``reps`` runs of the same prompts with one sampled token each, whose
    prefill walls (host clock, so they spread with the host's load) are
    kept with their median; with ``profile``, one such run's device busy
    time.  Returns (metrics, launches by kernel)."""
    from repro_torch.models import Model
    from repro_torch.serving import serve_batch
    mods = _kernel_modules()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    serve_batch(model, params, prompts[:, :32], 2, verbose=False)  # warm
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    toks, stats = serve_batch(model, params, prompts, gen, verbose=False,
                              keep_logits=True)
    launches = {n: m.launches for n, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    finite = bool(torch.isfinite(stats["logits"]).all())
    runs = [serve_batch(model, params, prompts, 1, verbose=False)[1]
            ["prefill_s"] * 1e3 for _ in range(reps)]
    metrics = {"arch": cfg.name, "dtype": cfg.dtype, "batch": batch,
               "prompt_len": prompt_len, "gen": gen,
               "prefill_ms": stats["prefill_s"] * 1e3,
               "prefill_ms_runs": runs,
               "prefill_ms_median": float(np.median(runs)),
               "decode_s": stats["decode_s"],
               "decode_tok_per_s": stats["tok_per_s"],
               "generated": stats["generated"], "peak_mem_bytes": peak,
               "launches": launches, "logits_finite": finite}
    log("[recurrent] " + json.dumps(metrics))
    want = {n: sum(cfg.layer_kinds.count(k) for k in kinds)
            for n, kinds in LAUNCH_KINDS.items()}
    if on_card and launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches} != {want} "
                             "(one per layer of each kernel's kinds)")
    if toks.shape != (batch, gen) or stats["generated"] != batch * gen:
        raise AssertionError(f"{cfg.name}: not every stream completed")
    if not finite or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: non-finite logits or a token "
                             "out of the vocabulary")
    del stats
    if profile:
        _profiled(f"serve_batch_{cfg.name}", lambda: serve_batch(
            model, params, prompts, gen, verbose=False))
        _profiled(f"prefill_{cfg.name}", lambda: serve_batch(
            model, params, prompts, 1, verbose=False))
    return metrics, launches


def phase_recurrent_parity(arch, device="cuda", prompt_len=100, gen=8,
                           rtol=1e-4):
    """The smoke of ``arch`` in float32 through ``serve_batch`` on
    ``device`` and on the CPU with the same weights: streams under the
    parity rule, logits within ``rtol`` of the largest; and prefill(P)
    followed by decode steps against one prefill(P + n) on ``device``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.serving import compare_stream, serve_batch
    cfg = get_smoke(arch).replace(dtype="float32", param_dtype="float32")
    model = Model(cfg)
    dev = torch.device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cpu_params = model.init(device="cpu")
    cpu_params.load_state_dict({n: t.cpu() for n, t in
                                params.state_dict().items()})
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, prompt_len)).astype(np.int32)
    toks, stats = serve_batch(model, params, prompts, gen, verbose=False,
                              keep_logits=True)
    ctoks, cstats = serve_batch(model, cpu_params, prompts, gen,
                                verbose=False, keep_logits=True)
    scale = float(cstats["logits"].abs().max())
    checks = []
    for i in range(len(prompts)):
        info = compare_stream(toks[i].tolist(), stats["logits"][i],
                              ctoks[i].tolist(), cstats["logits"][i])
        checks.append(info)
        if not info["explained"] or info["max_diff"] > rtol * scale:
            raise AssertionError(f"{cfg.name} stream {i}: card and CPU "
                                 f"break the parity rule: {info}")
    longer = np.concatenate([prompts, toks[:, :gen - 1]], axis=1)
    with torch.inference_mode():
        lg, _ = model.logits(params, {"tokens": torch.as_tensor(
            longer, device=dev)}, mode="prefill")
    handoff = float((lg[:, -1] - stats["logits"][:, gen - 1]).abs().max())
    row = {"arch": cfg.name, "compared": len(checks),
           "matched_whole": sum(c["match"] for c in checks),
           "max_diff": max(c["max_diff"] for c in checks),
           "logit_scale": scale, "handoff_max_diff": handoff}
    log("[rec-parity] " + json.dumps(row))
    if handoff > rtol * scale:
        raise AssertionError(f"{cfg.name}: prefill(P) + decode != "
                             f"prefill(P + n): {handoff}")
    return row


def main():
    profile_rounds = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs "
              "only on a GPU host", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import _pow2_bucket
    from repro_torch.data.synthetic import tabular_binary

    t_start = time.time()
    device_name, smi = phase_device()
    torch.cuda.synchronize()

    data = tabular_binary(n=ADULT_ROWS, num_features=ADULT_FEATURES,
                          seed=0)
    log(f"[data] train {len(data['X_train'])}, public "
        f"{len(data['X_public'])}, test {len(data['X_test'])}")
    T = len(data["X_public"])
    n_teacher = teacher_bucket(data, FedKTConfig(num_classes=2))
    n_student = _pow2_bucket(T)
    rounds = nn_rounds(data)
    vote_rows, vote_err = phase_votes(T, round_vote_shapes(
        [(r[2], T) for r in tree_rounds()]
        + [(r["cfg"], len(r["data"]["X_public"])) for r in rounds]))
    hist_rows, hist_err = phase_hist(n_teacher, n_student)
    att_rows, att_err = phase_attention()
    rg_rows, rg_err = phase_rglru()
    wk_rows, wk_err = phase_wkv()
    log(f"[phase] kernels ok at {time.time() - t_start:.1f} s")

    _, launches, tree_results = phase_round(data)
    torch.cuda.synchronize()
    log(f"[phase] round ok at {time.time() - t_start:.1f} s")
    for kname, n in phase_fleet(data, tree_results["rf_L0"], smi).items():
        launches[kname] += n
    torch.cuda.synchronize()
    log(f"[phase] fleet transports ok at {time.time() - t_start:.1f} s")
    phase_fleet_processes(smi)
    torch.cuda.synchronize()
    log(f"[phase] fleet processes ok at {time.time() - t_start:.1f} s")
    phase_parity()
    torch.cuda.synchronize()
    log(f"[phase] parity ok at {time.time() - t_start:.1f} s")
    for kname, n in phase_nn_rounds(rounds).items():
        launches[kname] += n
    torch.cuda.synchronize()
    log(f"[phase] nn rounds ok at {time.time() - t_start:.1f} s")
    phase_nn_parity()
    torch.cuda.synchronize()
    log(f"[phase] nn parity ok at {time.time() - t_start:.1f} s")
    phase_strategies()
    torch.cuda.synchronize()
    log(f"[phase] strategies ok at {time.time() - t_start:.1f} s")
    if profile_rounds:
        phase_profile(data)
        torch.cuda.synchronize()
        log(f"[phase] profile ok at {time.time() - t_start:.1f} s")

    from repro_torch.configs import get_config
    phi4 = get_config("phi4-mini-3.8b")
    lens = np.random.default_rng(0).integers(1, 513, 16)
    _, launches["flash_attention"] = phase_serving(
        phi4, lens, max_tokens=32, num_slots=8, cache_len=1024,
        profile=profile_rounds)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[phase] serving ok at {time.time() - t_start:.1f} s")
    phase_window()
    torch.cuda.synchronize()
    log(f"[phase] window ok at {time.time() - t_start:.1f} s")

    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        _, rec = phase_recurrent_serving(get_config(arch),
                                         profile=profile_rounds)
        for kname, n in rec.items():
            launches[kname] = launches.get(kname, 0) + n
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[phase] {arch} serving ok at {time.time() - t_start:.1f} s")
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        phase_recurrent_parity(arch)
    torch.cuda.synchronize()
    log(f"[phase] recurrent parity ok at {time.time() - t_start:.1f} s")

    v = next(r for r in vote_rows if r["U"] == 2 and r["noise"])
    h = hist_rows[0]
    a = att_rows[0]
    rg, wk = rg_rows[0], wk_rows[0]
    kernels = [
        {"name": "vote_aggregate", "route": "cuda",
         "source": "src/repro_torch/csrc/vote_aggregate.cu",
         "replaces": "src/repro/kernels/vote_aggregate.py:104",
         "launches": launches["vote_aggregate"], "max_abs_err": vote_err,
         "ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
         "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
         "library_ms": None},
        {"name": "tree_hist", "route": "cuda",
         "source": "src/repro_torch/csrc/tree_hist.cu",
         "replaces": "src/repro/kernels/tree_hist.py:61",
         "launches": launches["tree_hist"], "max_abs_err": hist_err,
         "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
         "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
         "library_ms": h["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": launches["flash_attention"], "max_abs_err": att_err,
         "ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
         "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
         "library_ms": a["library_ms"]},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:48",
         "launches": launches["rglru_scan"], "max_abs_err": rg_err,
         "ms": rg["kernel_ms"], "plain_ms": rg["plain_ms"],
         "bound_ms": rg["bound_ms"], "bound_by": rg["bound_by"],
         "library_ms": None},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:53",
         "launches": launches["wkv6"], "max_abs_err": wk_err,
         "ms": wk["kernel_ms"], "plain_ms": wk["plain_ms"],
         "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
         "library_ms": None},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
