"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # as the GPU host's check runs it
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown

Phases, each failing loudly (a failed check raises and the script exits
non-zero before printing a result):

  1. device   : the card's name, count, power limit; both CUDA kernels
                built from ``src/repro_torch/csrc`` (nvcc -Xptxas -v
                report printed per kernel).
  2. kernels  : each kernel against its plain PyTorch version on the
                card, at the round's shapes: the vote kernel bit for
                bit on all five outputs; the histogram kernel exact on
                integer weights, and on float weights run-to-run
                identical and within float32 summation's own limit cell
                by cell (a bfloat16-accumulated stand-in is read beside
                it).  Times with CUDA events beside each kernel's
                bound and the plain version's time.
  3. round    : the one-shot FedKT round at full width (Adult's size:
                48,842 rows x 14 features; 10 parties, s=2, t=5) for RF
                and GBDT at L0 and RF at L2, through FedKTSession on
                the card; the launch counters must equal the counts the
                config implies.
  4. parity   : a smaller RF round on the card and on the CPU (plain
                versions): identical server labels, accuracy, epsilon.
  --profile    : device time by kernel and the device's busy share of
                each full-width round (torch.profiler).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
where torch sees no CUDA device or the repository's sources are absent.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA cores, float32
ADULT_ROWS, ADULT_FEATURES = 48_842, 14


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


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the float32 CUDA-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


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


def phase_votes(T):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vote_aggregate as va
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for M, U, noisy in ((5, 2, False), (5, 2, True), (5, 512, True)):
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
        ms = cuda_ms(lambda: va.vote_aggregate(preds, noise,
                                               num_classes=U))
        plain = cuda_ms(lambda: ref.vote_aggregate_plain(preds, U, noise))
        nbytes = 4 * (M * T + (T * U if noisy else 0) + 5 * T)
        b_ms, b_by = bound(nbytes, M * T * U + (T * U if noisy else 0))
        row = {"kernel": "vote_aggregate", "M": M, "T": T, "U": U,
               "noise": noisy, "kernel_ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "bit_identical": True}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
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
    # the student level-5 shape: 2 students x 20 trees over 8192 rows
    rows = []
    for label, G, Gf, N, n in (("student_level5", 40, 2, N_student, 32),
                               ("teacher_level5", 200, 10, N_teacher, 32)):
        xb, node, w = _hist_inputs(G, Gf, N, F, B, K, n, True, g)
        got = th.tree_hist(xb, node, w, num_nodes=n, num_bins=B)
        assert torch.equal(got, ref.tree_hist_ref(xb, node, w, n, B))
        ms = cuda_ms(lambda: th.tree_hist(xb, node, w, num_nodes=n,
                                          num_bins=B))
        plain = cuda_ms(lambda: ref.tree_hist_ref(xb, node, w, n, B),
                        reps=5)
        lib = _scatter_yardstick(xb, node, w, n, B)
        assert torch.equal(lib().reshape(got.shape), got)
        lib_ms = cuda_ms(lib)
        nbytes = 4 * (Gf * N * F + G * N + G * K * N + G * K * n * F * B)
        b_ms, b_by = bound(nbytes, G * K * N * F)
        row = {"kernel": "tree_hist", "shape": label, "G": G, "Gf": Gf,
               "N": N, "F": F, "K": K, "n": n, "B": B, "kernel_ms": ms,
               "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
    torch.cuda.synchronize()
    return rows, worst


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------
def expected_launches(cfg, kind, depth, rounds):
    """Launch counts the config implies for one vmap round: every
    stacked fit runs one histogram launch per level and one per leaf
    build (per boosting round for GBDT), for each party's teacher grid
    and its s students, plus the final model; one vote launch per
    partition per party."""
    per_fit = (depth + 1) * (rounds if kind == "gbdt" else 1)
    hist = cfg.num_parties * 2 * per_fit + per_fit
    votes = cfg.num_parties * cfg.num_partitions
    return hist, votes


def run_round(learner, data, cfg, device, engine="vmap"):
    from repro_torch.federation import FedKTSession
    sess = FedKTSession(learner, data, cfg, engine=engine, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    res = sess.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.time() - t0


def phase_round(data):
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import GBDTLearner, RFLearner
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    runs = [("rf_L0", RFLearner(num_classes=2), FedKTConfig(num_classes=2),
             "rf", 6, 1),
            ("gbdt_L0", GBDTLearner(), FedKTConfig(num_classes=2),
             "gbdt", 6, 30),
            ("rf_L2", RFLearner(num_classes=2),
             FedKTConfig(num_classes=2, privacy_level="L2", gamma=0.1,
                         query_fraction=0.2), "rf", 6, 1)]
    totals = {"tree_hist": 0, "vote_aggregate": 0}
    rows = []
    for name, learner, cfg, kind, depth, rounds in runs:
        torch.cuda.reset_peak_memory_stats()
        th.launches = 0
        va.launches = 0
        res, secs = run_round(learner, data, cfg, "cuda")
        got = (th.launches, va.launches)
        want = expected_launches(cfg, kind, depth, rounds)
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
    return rows, totals


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


def phase_profile(data):
    """``--profile``: where the time of each full-width round goes, from
    torch.profiler: device time by kernel, and the device's busy share
    of the round's wall time (profiler overhead included in the wall)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import GBDTLearner, RFLearner
    for name, learner in (("rf_L0", RFLearner(num_classes=2)),
                          ("gbdt_L0", GBDTLearner())):
        cfg = FedKTConfig(num_classes=2)
        run_round(learner, data, cfg, "cuda")          # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, secs = run_round(learner, data, cfg, "cuda")
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        log("[profile] " + json.dumps({
            "round": name, "wall_s": secs, "device_busy_s": busy,
            "busy_share": busy / secs,
            "top": [{"name": k[:60], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:8]]}))


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
    name, smi = phase_device()
    torch.cuda.synchronize()

    data = tabular_binary(n=ADULT_ROWS, num_features=ADULT_FEATURES,
                          seed=0)
    log(f"[data] train {len(data['X_train'])}, public "
        f"{len(data['X_public'])}, test {len(data['X_test'])}")
    T = len(data["X_public"])
    n_teacher = teacher_bucket(data, FedKTConfig(num_classes=2))
    n_student = _pow2_bucket(T)
    vote_rows, vote_err = phase_votes(T)
    hist_rows, hist_err = phase_hist(n_teacher, n_student)
    log(f"[phase] kernels ok at {time.time() - t_start:.1f} s")

    _, launches = phase_round(data)
    torch.cuda.synchronize()
    log(f"[phase] round ok at {time.time() - t_start:.1f} s")
    phase_parity()
    torch.cuda.synchronize()
    log(f"[phase] parity ok at {time.time() - t_start:.1f} s")
    if profile_rounds:
        phase_profile(data)
        torch.cuda.synchronize()

    v = next(r for r in vote_rows if r["U"] == 2 and r["noise"])
    h = hist_rows[0]
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
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
