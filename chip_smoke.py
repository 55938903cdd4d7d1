"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # as the GPU host's check runs it
    python3 chip_smoke.py --profile    # plus a torch.profiler breakdown

Phases, each failing loudly (a failed check raises and the script exits
non-zero before printing a result):

  1. device   : the card's name, count, power limit; the eight CUDA
                kernel sources (the five TPU kernels' counterparts and
                the backward kernels of attention, the RG-LRU scan and
                the WKV recurrence) built from
                ``src/repro_torch/csrc``, one nvcc each, all started
                together (-Xptxas -v report printed
                per kernel, and a summary line of the registers and
                spills of the wgmma attention kernels, forward and
                backward, and the WKV and recurrence-backward kernels).
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
                attention at head dim 256, (e) float32 at head dim 256,
                and at the new archs' prefills: (f) stablelm-3b's dh 80
                (launched at 80) and (f') the same in float32,
                (g) granite-20b's 48:1 MQA, (h) mixtral-8x7b's 4608
                positions past its 4096 window, (i) llava's 2 x 3008,
                (j) deepseek-moe-16b's 8 x 512 bucket, and whisper-tiny's
                non-causal calls over 1500 frames (a ragged last key
                tile): (k) the encoder (8, 1500 x 1500), (l) cross
                attention (8, 64 x 1500) and (l') the same in float32;
                gemma2-27b's engine buckets (b') 8 x 512 and (b'') 1 x
                5120 (window 4096, soft-cap 50), (j') deepseek's
                train forward (4, 512) writing the row LSE, and the same
                at one batch row of gemma2_train's step (1, 8192, 32:16,
                soft-cap 50): (b4) a local layer (window 4096) and (b5)
                a global one; and (r) the float32 recurrentgemma train
                step's local attention with the LSE (4, 512, 10:1, dh
                256, window 2048); the float32 rows on the split-TF32
                kernels, bound by 3 TF32 products a float32 one;
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
                the kernel's time over the faster); the vote,
                attention and RG-LRU kernels' device time also from 20
                launches in a CUDA graph (a small call's event time reads
                the host's).
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
  6b. gemma2_serve: gemma2-27b at full width, all 46 layers (bf16,
                random weights) behind ``Engine(num_slots=8,
                cache_len=5120)``: 16 requests, 32 tokens each, closed
                loop, 14 prompts of 1-512 tokens and two of 4352 and
                4608, past the 4096-key window (their local layers'
                caches become rings at insert; the cache cap binds their
                bucket).  K3 (soft-cap 50, the window sliding) launches
                = 46 x prefill dispatches; the replay's streams equal;
                streams 0, 1 and the 4608-token prompt's held to solo
                ``serve_batch`` runs; TTFT, per-token latency, tok/s,
                the timed run's and the whole phase's peak memory.
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
  8b. moe_serving: deepseek-moe-16b at full width, all 28 layers (bf16,
                random weights) behind ``Engine(num_slots=8,
                cache_len=1024)``: 8 requests of 1-512 prompt tokens, 32
                tokens each, at the config's capacity factor 1.25 (the
                share of picks dropped, counted in the untimed replay,
                printed) and at the no-drop 11.0, where none may drop and
                the streams are held to solo ``serve_batch`` runs under
                the parity rule; K3 launches = 28 x prefill dispatches;
                one MoE block's ``moe_apply`` twice on one 8 x 512 input
                at each factor, equal bit for bit.
  8c. dense_archs: through ``serve_batch`` at full width, granite-20b (52
                layers, 48 q heads on one kv head) and stablelm-3b (K3
                at head dim 80, launched at 80; its median prefill and
                K3 launches on a line of their own) on 4 prompts of
                1024 tokens, 32 tokens each, and mixtral-8x7b at 16 of
                its 32 layers (a depth cut: 32 do not fit one card) on one
                prompt of 4608 tokens, past its 4096-key window; then
                llava-next-mistral-7b's prefill over 2880 stub patch
                embeddings + 128 tokens and 8 decode steps at positions
                3008 + i.  Finite logits, K3 once a layer of every
                prefill, prefill and decode times, peak memory.
  8d. arch_parity: the five new smokes in float32 on the card against
                the CPU through ``serve_batch`` (logits within 1e-4 of
                the largest; the MoE smokes at their no-drop capacity),
                llava's embeddings path, and one train step of
                deepseek-moe's smoke (loss and gradients within 1e-4,
                AdamW parameters as in phase 9, exact K3 and N1
                launches); then whisper-tiny's smoke with 100 frames,
                streams and one train step the same way.
  8e. whisper   : whisper-tiny (the encoder-decoder) at full width (4 + 4
                layers, d 384; bf16, random weights): ``serve_batch`` of
                8 x 64-token prompts with 1500 random stub frames each,
                32 tokens (exactly 12 K3 launches a prefill, none a
                decode step; prefill ms, median of 5; a decode step's
                ms; tok/s; peak memory); then 8 ``make_train_step``
                steps (AdamW, remat) of B 8 x S 128 tokens + 1500
                frames: step ms, tokens/s, peak memory, exact K3 (20)
                and N1 (12 calls) launches a step, finite and falling
                losses.
  9. lm_train : the LM training path.  N1, the flash-attention
                backward, against its plain version at phi4-mini's
                training shape (B 4, S 512, H 24, KV 8, dh 128, bf16), a
                gemma2-like one (window 1024 < S 2048, soft-cap 50), a
                float32 dh-32 one, whisper-tiny's non-causal (m)
                encoder (8, 1500 x 1500) and (n) cross attention (8,
                128 x 1500: Sq != Skv), a granite-like 48:1 group
                (1, 1024, dh 128, causal), and recurrentgemma's local
                attention at dh 256 (10:1, window 2048) at (4, 512) and
                (1, 4096), stablelm-3b's (dh 80) and deepseek-moe-16b's
                (4, 512, 16:16) train shapes and one batch row of
                gemma2_train's (1, 8192, 32:16, soft-cap 50) at a local
                layer (window 4096) and a global one, and in float32
                (the split-TF32 kernels, within 1e-5 of the largest
                |gradient|) phi4's, stablelm's and recurrentgemma's
                train shapes and whisper's (m), identical run to run,
                timed beside its bound and the backward of one SDPA
                call (an explicit window
                mask where the window is shorter than S); then
                ``launch.train.train_lm`` on phi4-mini-3.8b at full
                width (bf16 on float32 masters, AdamW, remat, B 4 x S
                512, 8 steps): finite, falling losses, exact K3 / N1
                launches a step, no K4 / K5; ``make_train_step`` on the
                card against the CPU at the phi4, gemma2, recurrentgemma
                and rwkv6 smokes in float32 (AdamW losses and first-step
                gradients, SGD parameters, within 1e-4; AdamW parameters
                within 1e-4 where the first step's gradient fixes the
                update's sign, within the bound of a free sign
                elsewhere; rwkv6's all within that bound, its smoke's
                gradients being ten times as sensitive to rounding on
                the CPU alone: ``ADAMW_SIGN_FREE_ARCHS``);
                ``fedkt_lm`` at L0 and L2 card against CPU (>= 99 %
                equal server labels, equal epsilon, K1 a party
                partition); 3 full-width phi4-mini
                members' label step with the noisy token vote, K1 at
                (3, 2048, 200,064) bit for bit against its plain
                version; the trained parameters saved as a checkpoint
                in the reference's format and served by ``launch.serve
                --checkpoint``, streams equal to the in-memory ones.
                Then the recurrences' backward kernels: N2a (K4's)
                bit for bit against ``ref.rglru_scan_backward_plain`` at
                recurrentgemma's train shape (4, 512, 2560), at S 1024,
                a ragged S 1000 and in float32, from a nonzero h0 with a
                nonzero dh_last; N2b (K5's) within 2e-2 (bf16) or 1e-5
                (float32) of each gradient's largest against
                ``ref.wkv6_backward_plain`` at rwkv6's (4, 512, 64 x 64)
                from the zero state and from a nonzero one with
                ds_last, and in float32; each also composed with its
                forward through its autograd Function, identical run to
                run, timed (events and a CUDA graph) beside its bound
                and the plain version.  Then ``train_lm`` on
                recurrentgemma-2b (26 layers) and rwkv6-7b cut to 12 of
                its 32 layers (32 layers' masters, gradients and AdamW
                moments are 120.6 GB) as on phi4: exact K3, N1, K4, N2a,
                K5 and N2b launches a step from the layer pattern, the
                first loss within [ln V, ln V + 1.79], the first batch's
                loss lower after the 8 steps, step ms, tokens/s, peak;
                then stablelm-3b (32 layers, N1 at dh 80) and
                deepseek-moe-16b cut to 6 of its 28 layers
                (``DEEPSEEK_TRAIN_LAYERS``: the dense head block and 5
                MoE blocks at capacity factor 1.25) the same way, 12 K3
                and 18 N1 launches a step, and one of its steps taken
                twice from one set of masters on one batch: the loss
                and every gradient leaf equal bit for bit; then
                gemma2-27b cut to 4 of its 46 layers
                (``GEMMA2_TRAIN_LAYERS``: 2 local, 2 global) at B 2 x S
                8192, its own context, the same way: the 4096-key window
                binds in K3 and N1 under soft-cap 50, the head's 16
                chunks are soft-capped at 30, the tied embedding's
                gradient sums the lookup's and the chunks'; 8 K3 and 12
                N1 launches a step, the repeated step bit for bit.
                Between stablelm and deepseek, recurrentgemma-2b in
                float32 (26 layers, full width) the same way: K3 and N1
                on their float32 kernels at dh 256 (16 and 24 launches
                a step, all counted as float32), K4 and N2a in float32,
                the repeated step bit for bit.  After gemma2, the cuts
                of granite-20b (8 of 52), mixtral-8x7b (2 of 32) and
                llava-next-mistral-7b (16 of 32, B 1 x S 4096) the same
                way.  Last, the LM FedKT round (``launch.train.
                fedkt_lm``, the CLI's ``--fedkt`` config: 2 parties, s
                2, t 2, B 8 x S 128, in-process transport) at
                phi4-mini-3.8b's full width cut to 8 of its 32 layers,
                8 steps a fit, at L0 and at L2 (gamma 0.1): launches
                exactly as derived from the config (K1 once a party
                partition under L2, none under L0: the sort path), each
                L2 party vote's K1 bit for bit ``ref.vote_aggregate_
                plain`` on the card on the recorded predictions and
                noise, each L0 party vote and the server's vote
                recomputed on the CPU, epsilon, the update wire bytes
                equal to ``codec.lm_protocol_bytes``' price, the peak
                under 72 GB beside its price, K1 timed at the round's
                shape (2, 4096, 200,064); one ``[lm-fedkt-cut]`` line
                a level.
  10. dryrun  : the port's dry-run on the meta device (no kernel
                launch; host time): one arch per family (phi4-mini,
                mixtral, recurrentgemma, whisper) x the four input
                shapes x both production meshes, each pair's dominant
                term, per-device peak against the card's 80 GB and the
                seconds of its terms, the skips equal to ``SKIPS``
                (these pairs are priced in phase 1, while nvcc runs);
                then lm_train's exact steps (phi4-mini, recurrentgemma-2b,
                rwkv6-7b's 12-layer cut, stablelm-3b, deepseek-moe-16b's
                6-layer cut and recurrentgemma-2b in float32 at B 4 x S
                512, gemma2-27b's 4-layer cut at B 2 x S 8192; remat,
                AdamW,
                float32 masters) on a one-device mesh, predicted beside
                that phase's measured step ms and peak memory (the
                params, gradients and AdamW state it predicts may not
                exceed the measured peak; its calls of K3, N1, K4, N2a,
                K5 and N2b must equal the launches the card counted);
                FedKT's label step
                at 16 members (protocol bytes), and at lm_label's 3
                members and (2, 1024) block beside its measured wall.
  --profile    : device time by kernel and the device's busy share of
                each full-width round (RF, GBDT, nn_L0, cnn_L0), of the
                serving runs, of one recurrent prefill, and (last) of
                one whisper prefill (8 x 64, 1500 frames) and one
                whisper train step (torch.profiler; the host-bound
                phases after it read slower than without the flag).

The line before the last is the kernels' JSON record (K3's and N1's
float32 kernels have entries of their own, ``flash_attention_f32`` and
``flash_attention_backward_f32``; a listed kernel that the main path
never launched fails the run); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
where torch sees no CUDA device or the repository's sources are absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the H100's rates (one owner: the port's roofline, launch/analysis.py)
from repro_torch.federation.engines import LMEngine  # noqa: E402
from repro_torch.launch.analysis import (FP32_FLOPS, HBM_BW,  # noqa: E402
                                         PEAK_FLOPS, TF32_FLOPS)
ADULT_ROWS, ADULT_FEATURES = 48_842, 14
ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py
# K3's row log-sum-exp against the plain version's, absolute (as
# tests/test_torch_cuda_lm.py holds it)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# N1's gradients against the plain backward's, of the largest |gradient|
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}    # test_kernels.py


def log(msg=""):
    print(msg, flush=True)


def _sync(device):
    """Waits for the card's queued work (nothing to wait for on the
    CPU)."""
    if device == "cuda":
        torch.cuda.synchronize()


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


def bound(nbytes, nops, ops_per_s=FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate for their type (float32 CUDA cores
    unless given)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(nbytes, nops, dt):
    """K3's and N1's (bound_ms, bound_by) for ``nops`` float32-equivalent
    operations: bf16 on its tensor cores' peak; float32 in split TF32,
    three TF32 products a float32 one, on the TF32 tensor cores."""
    if dt == torch.bfloat16:
        return bound(nbytes, nops, PEAK_FLOPS)
    return bound(nbytes, 3 * nops, TF32_FLOPS)


def percentile(xs, q):
    return sorted(xs)[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# kernels whose registers and spills get a summary line of their own
PTXAS_KERNELS = ("flash_attention_wgmma", "bwd_dkdv_wgmma", "bwd_dq_wgmma",
                 "bwd_dkdv_wg2", "bwd_dq_wg2", "flash_attention_tf32",
                 "bwd_dkdv_tf32", "bwd_dq_tf32", "wkv6_kernel",
                 "wkv6_bwd_chains", "wkv6_bwd_chunk", "rglru_scan_bwd_tma",
                 "rglru_scan_bwd_direct")


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
def phase_device(during_build=None):
    """The card's name and ``nvidia-smi`` line; the kernel sources built
    (one nvcc each, all started together) and their ptxas reports.
    ``during_build(smi)``, where given, runs on this thread while the
    build runs on another (host work that needs no kernel)."""
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
    with ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(build.build)
        if during_build is not None:
            during_build(smi)
            log(f"[device] host work during the build took "
                f"{time.time() - t0:.1f} s")
        reports = building.result()
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


def phase_hist(N_teacher, N_student, extra_shapes=()):
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
    # and any other round's (the vertical round's masked widths)
    shapes += list(extra_shapes)
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
    local attention (dh 256), (e) float32 at dh 256, (f) stablelm-3b's
    dh 80 (launched at 80: five 32-byte-swizzled boxes a tile) and (f')
    the same in float32, (g) granite-20b's 48 q heads on one kv head,
    (h) mixtral-8x7b's prefill past its 4096-key window, (i) llava's
    2880 embeds + 128 tokens (S 3008) and (j) deepseek-moe-16b's
    largest engine bucket, each at the shape its main path launches;
    then whisper-tiny's non-causal calls over 1500 frames (a ragged last
    64-key tile): (k) the encoder's self-attention (Sq = Skv = 1500),
    (l) cross attention (Sq 64 prompt tokens, Skv 1500) and (l') the
    same in float32; then gemma2-27b's engine buckets (window 4096,
    soft-cap 50): (b') the (8, 512) bucket of its short prompts and
    (b'') the (1, 5120) bucket, capped at the engine's cache length,
    of a prompt past the window; (j') deepseek-moe-16b's train
    forward (4, 512), which also writes the row LSE for N1 (held to
    ``ref.attention_plain``'s within ``LSE_TOL``), and the same with
    LSE at one batch row of gemma2_train's step (1, 8192, 32:16,
    soft-cap 50): (b4) a local layer, window 4096, and (b5) a global
    one.  The library
    yardstick is SDPA's fastest backend under the explicit causal+window
    mask where there is a window, and under ``is_causal`` where the
    window is absent or covers S (then the mask IS the causal mask), and
    with no mask at all for the non-causal rows; ``library_ms`` is the
    fastest."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels.meta import valid_pairs
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
        # stablelm-3b's prefill: dh 80, launched at 80
        ("f_stablelm_dh80", 4, 1024, 32, 32, 80, torch.bfloat16, 0, 0.0,
         True),
        ("f2_stablelm_dh80_f32", 4, 1024, 32, 32, 80, torch.float32, 0,
         0.0, True),
        # granite-20b's MQA: 48 q heads on one kv head
        ("g_granite_mqa", 4, 1024, 48, 1, 128, torch.bfloat16, 0, 0.0,
         True),
        ("h_mixtral_window", 1, 4608, 32, 8, 128, torch.bfloat16, 4096,
         0.0, True),
        ("i_llava_embeds", 2, 3008, 32, 8, 128, torch.bfloat16, 0, 0.0,
         True),
        ("j_deepseek_bucket", 8, 512, 16, 16, 128, torch.bfloat16, 0, 0.0,
         True),
    ]
    # (Sq, Skv, causal) of each case: the rows above are causal prefills
    # (Sq = Skv = S); whisper-tiny's are non-causal over 1500 frames
    # ... then whether the call also writes the row LSE (training)
    cases = [c[:2] + (c[2],) + c[2:] + (True, False) for c in cases] + [
        ("k_whisper_encoder", 8, 1500, 1500, 6, 6, 64, torch.bfloat16, 0,
         0.0, True, False, False),
        ("l_whisper_cross", 8, 64, 1500, 6, 6, 64, torch.bfloat16, 0, 0.0,
         True, False, False),
        ("l2_whisper_cross_f32", 8, 64, 1500, 6, 6, 64, torch.float32, 0,
         0.0, True, False, False),
        # gemma2-27b's engine buckets (SDPA has no soft-cap)
        ("b2_gemma2_bucket_8x512", 8, 512, 512, 32, 16, 128,
         torch.bfloat16, 4096, 50.0, False, True, False),
        ("b3_gemma2_bucket_1x5120", 1, 5120, 5120, 32, 16, 128,
         torch.bfloat16, 4096, 50.0, False, True, False),
        ("j2_deepseek_train_lse", 4, 512, 512, 16, 16, 128, torch.bfloat16,
         0, 0.0, True, True, True),
        # one batch row of gemma2_train's forward (and recompute), LSE
        # out: a local layer (window 4096 binding at S 8192), a global one
        ("b4_gemma2_train_local_lse", 1, 8192, 8192, 32, 16, 128,
         torch.bfloat16, 4096, 50.0, False, True, True),
        ("b5_gemma2_train_global_lse", 1, 8192, 8192, 32, 16, 128,
         torch.bfloat16, 0, 50.0, False, True, True),
        # recurrentgemma_f32_train's local attention forward (and
        # recompute), LSE out: float32 at dh 256, 10:1, window 2048
        ("r_recurrentgemma_train_f32_lse", 4, 512, 512, 10, 1, 256,
         torch.float32, 2048, 0.0, True, True, True)]
    rows, worst = [], 0.0
    for (label, B, S, Skv, H, KV, dh, dt, window, cap, lib, causal,
         lse) in cases:
        q = torch.randn((B, S, H, dh), device="cuda", generator=g).to(dt)
        k = torch.randn((B, Skv, KV, dh), device="cuda", generator=g).to(dt)
        v = torch.randn((B, Skv, KV, dh), device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        fkw = dict(kw, return_lse=lse)
        got = fa.flash_attention(q, k, v, **fkw)
        again = fa.flash_attention(q, k, v, **fkw)
        want = ref.attention_ref(q, k, v, **kw)
        lse_err = None
        if lse:
            (got, got_lse), (again, again_lse) = got, again
            want_lse = ref.attention_plain(q, k, v, return_lse=True,
                                           **kw)[1]
            lse_err = float((got_lse - want_lse).abs().max())
            if not torch.equal(got_lse, again_lse) \
                    or lse_err > LSE_TOL[dt]:
                raise AssertionError(f"K3's LSE at {label}: {lse_err}, "
                                     "or not identical run to run")
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
        p = fa.plan(fa.padded_head_dim(dh), dt)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **fkw), reps=10)
        # a small call's event time is the wrapper's host time (tensor
        # maps, allocation); 20 launches in a CUDA graph read the device
        graph = graph_ms(lambda: fa.flash_attention(q, k, v, **fkw))
        plain = cuda_ms(lambda: ref.attention_plain(q, k, v, **fkw)
                        if lse else ref.attention_ref(q, k, v, **kw),
                        reps=3, warmup=1)
        yardsticks = {}
        if lib:   # SDPA computes the same function only without soft-cap
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if not causal:
                yardsticks["no_mask"] = sdpa_best(qt, kt, vt)
            elif window:   # the causal window as an explicit mask
                mask = ref._mask(torch.arange(S, device="cuda"), S, True,
                                 window, "cuda")
                yardsticks["explicit_mask"] = sdpa_best(qt, kt, vt,
                                                        attn_mask=mask)
            if causal and (not window or window >= S):
                yardsticks["is_causal"] = sdpa_best(qt, kt, vt,
                                                    is_causal=True)
            for _, _, out in yardsticks.values():
                torch.testing.assert_close(out.transpose(1, 2).float(),
                                           got.float(), atol=tol, rtol=tol)
        fastest = min(yardsticks.values(), key=lambda y: y[0],
                      default=None)
        lib_ms = None if fastest is None else fastest[0]
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        if lse:
            nbytes += 4 * B * H * S
        nops = 4 * B * H * valid_pairs(S, Skv, causal, window) * dh
        b_ms, b_by = attention_bound(nbytes, nops, dt)
        row = {"kernel": "flash_attention", "shape": label, "B": B, "S": S,
               "Skv": Skv, "causal": causal, "H": H, "KV": KV, "dh": dh,
               "launched_dh": fa.padded_head_dim(dh), "dtype": str(dt),
               "window": window, "softcap": cap, "max_abs_err": err,
               "tol": tol, "return_lse": lse, "lse_max_abs_err": lse_err,
               "plan": p._asdict(), "kernel_ms": ms,
               "graph_ms": graph, "plain_ms": plain,
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


def _rec_row(kernel, label, shape, dt, err, tol, ms, plain, nbytes, nops,
             bnd=None):
    b_ms, b_by = bound(nbytes, nops) if bnd is None else bnd
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


# the fleet's vertical round: its other flags, 3 feature-split silos
# (nn, rf and gbdt, each on its own slice of the 14 columns), an MLP
# final model on the server
VERTICAL_FLAGS = [*FLEET_FLAGS, "--parties", "3", "--learners",
                  "nn,rf,gbdt", "--vertical"]


def vertical_hist_shapes(flags=VERTICAL_FLAGS):
    """K2's shapes at the deepest level of the vertical round's masked
    rf and gbdt parties (``launch/federate --vertical`` with ``flags``),
    as ``_hist_inputs`` takes them: (label, G, Gf, N, F, nodes, bins),
    F the party's mask width; the teacher grid (s t models, each rf
    model a forest) over its largest subset's bucket and the s students
    over the party's queries' bucket."""
    from repro_torch.core.learners import (GBDTLearner, RFLearner,
                                           _pow2_bucket)
    from repro_torch.core.trees import NUM_BINS
    from repro_torch.federation.party import query_budget
    from repro_torch.launch import federate
    args = federate.parse_args(["local", *flags])
    sess = federate.build_session(args, "inprocess")
    cfg = sess.cfg
    s, t = cfg.num_partitions, cfg.num_subsets
    n_student = _pow2_bucket(query_budget(cfg, len(sess.data["X_public"]))[0])
    level = args.depth - 1
    shapes = []
    for party in sess.parties:
        lrn = party.learner
        if isinstance(lrn, RFLearner):
            kind, trees = "rf", lrn.num_trees
        elif isinstance(lrn, GBDTLearner):
            kind, trees = "gbdt", 1
        else:
            continue
        plan = party.subset_plan()
        n_teacher = _pow2_bucket(max(len(sub) for p in plan for sub in p))
        F = len(lrn.feature_mask)
        shapes += [(f"vertical_{kind}_teachers_level{level}", s * t * trees,
                    s * t, n_teacher, F, 2 ** level, NUM_BINS),
                   (f"vertical_{kind}_students_level{level}", s * trees, s,
                    n_student, F, 2 ** level, NUM_BINS)]
    return shapes


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
    round (``--chaos``); the vertical round (``fleet_vertical``), whose
    launches it returns."""
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
    return fleet_vertical(smi)


def fleet_vertical(smi, device="cuda", flags=VERTICAL_FLAGS):
    """The fleet's vertical round: ``launch/federate local --vertical``
    with ``flags`` (3 feature-split silos, nn, rf and gbdt, each on its
    own column slice, their updates over TCP sockets), held bit for bit
    to the same session run in process on ``device`` (``same_round``),
    both rounds' K1 and K2 launches exactly what the roster implies
    (``expected_launches``), one shared example domain that every party
    votes in, its wire bytes those of all updates; then to the same
    session on the CPU by the whole-round rule: at least 99 % equal
    server labels and equal epsilon.  Prints one ``[fleet-vertical]``
    line; returns the two card rounds' launches.  ``device="cpu"``
    rehearses it on the CPU (no launch counted)."""
    import io
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    from repro_torch.launch import federate
    argv = ["local", *flags, "--device", device]
    args = federate.parse_args(argv)
    sess = federate.build_session(args, "inprocess")
    want = expected_launches(sess.cfg, federate.party_kinds(args), "nn",
                             args.depth, args.trees)
    if device != "cuda":        # the plain versions count no launch
        want = (0, 0)
    th.launches = va.launches = 0
    t0 = time.time()
    base = sess.run()
    _sync(device)
    base_s = time.time() - t0
    got_base = (th.launches, va.launches)
    th.launches = va.launches = 0
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = federate.main([*argv, "--port", "0"])
    _sync(device)
    socket_s = time.time() - t0
    got_socket = (th.launches, va.launches)
    report = _report_json(buf.getvalue())
    t0 = time.time()
    cpu = federate.build_session(federate.parse_args(
        ["local", *flags, "--device", "cpu"]), "inprocess").run()
    cpu_s = time.time() - t0
    (ident, row), = res.by_domain.items()
    (cpu_row,) = cpu.by_domain.values()
    agree = float((row["labels"] == cpu_row["labels"]).mean())
    sock = res.meta["socket"]
    out = {"fleet": "vertical", "flags": flags, "device": device,
           "inprocess_wall_s": base_s, "socket_wall_s": socket_s,
           "cpu_wall_s": cpu_s, "seconds": res.meta["seconds"],
           "launches": {"inprocess": list(got_base),
                        "socket": list(got_socket)},
           "expected": list(want),
           "masks": [b.learner.feature_mask for b in sess.bindings],
           "domain_unit": row["domain"].unit, "parties": row["parties"],
           "arrived": sock["arrived"], "framed_bytes": sock["framed_bytes"],
           "wire_bytes": res.meta["wire_bytes"]["updates"],
           "accuracy": res.accuracy, "cpu_accuracy": cpu.accuracy,
           "epsilon": res.epsilon, "label_agreement_vs_cpu": agree,
           "card": smi}
    log("[fleet-vertical] " + json.dumps(out, default=str))
    same_round("vertical socket", res, base)
    if got_base != want or got_socket != want:
        raise AssertionError(f"vertical: launches {got_base} in process, "
                             f"{got_socket} over sockets != {want}")
    n = sess.cfg.num_parties
    if row["domain"].unit != "example" or row["parties"] != list(range(n)) \
            or len(sock["framed_bytes"]) != n or sock["dropped"] \
            or res.meta["wire_bytes"]["by_domain"][ident] != \
            res.meta["wire_bytes"]["updates"]:
        raise AssertionError(f"vertical: not one shared example domain of "
                             f"{n} arrived parties: {out}")
    if report["arrived"] != n or report["accuracy"] != \
            round(float(res.accuracy), 4):
        raise AssertionError(f"vertical: the launcher reported {report}")
    if agree < 0.99 or cpu.epsilon != res.epsilon:
        raise AssertionError(f"vertical: {agree} of the server labels and "
                             f"epsilon {res.epsilon} against the CPU's "
                             f"{cpu.epsilon}")
    return {"tree_hist": got_base[0] + got_socket[0],
            "vote_aggregate": got_base[1] + got_socket[1]}


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


def _profiled(name, fn, watch=()):
    """Runs ``fn`` under torch.profiler and logs device time by kernel
    and the device's busy share of the wall time (profiler overhead
    included in the wall; kernels that overlap would count twice, but
    everything here runs on one stream); and for each kernel whose name
    holds one of ``watch``, its rank by device time, time and calls."""
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
                for us, k, c in rows[:10]],
        "watched": [{"rank": i + 1, "name": k[:80], "device_ms": us / 1e3,
                     "calls": c} for i, (us, k, c) in enumerate(rows)
                    if any(w in k for w in watch)]}))


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
              counter=None, **engine_kw):
    """Warms an engine on the prompts' buckets, zeroes the kernel's
    launch count, serves the prompts closed loop (inside ``counter``, a
    context manager, where one is given).  Returns (engine, results,
    wall seconds, launches, the run's peak bytes, the peak bytes from
    the engine's creation to the end of its warm-up, which runs each
    bucket at every batch size up to the engine's largest)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import Engine
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, params, device=device, keep_logits=keep_logits,
                 **engine_kw)
    eng.warmup(buckets=[len(p) for p in prompts])
    warm_peak = 0
    if on_card:
        torch.cuda.synchronize()
        warm_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    with counter or contextlib.nullcontext():
        res = eng.serve(prompts, max_tokens=max_tokens)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return eng, res, wall, launches, peak, warm_peak


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
                  cache_len=1024, compare=3, rtol=0.25, profile=False,
                  params=None, counter=None, tag="serve", smi=None):
    """The serving path at ``cfg``'s widths: a timed engine run over
    prompts of ``lens`` tokens, then a replay that keeps logits (it must
    give the same streams; ``counter``, a context manager, is entered
    around it, outside the timed run), then streams held to solo
    serve_batch runs: the first ``compare`` where it is an int, else the
    indices it lists.  ``params``: the weights (default: drawn from
    seed 0); ``smi``: the card's name and power limit, printed in the
    row.  Returns (the row, with the held streams' indices under
    "held_to_serial", the timed run's K3 launches)."""
    from repro_torch.models import Model
    model = Model(cfg)
    dev = torch.device(device)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    prompts = serve_prompts(cfg, lens)
    n_requests = len(prompts)
    kw = dict(num_slots=num_slots, cache_len=cache_len)
    eng, res, wall, launches, peak, warm_peak = serve_run(
        model, params, prompts, max_tokens, device, False, **kw)
    m = serving_metrics(eng, res, wall)
    m.update({"arch": cfg.name, "layers": cfg.num_layers,
              "dtype": cfg.dtype, "attention_launches": launches,
              "peak_mem_bytes": peak, "warmup_peak_mem_bytes": warm_peak})
    if smi:
        m["card"] = smi
    if cfg.moe:
        m["capacity_factor"] = cfg.moe.capacity_factor
    log(f"[{tag}] " + json.dumps(m))
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
    replay = serve_run(model, params, prompts, max_tokens, device, True,
                       counter=counter, **kw)[1]
    if [r.tokens for r in replay] != [r.tokens for r in res]:
        raise AssertionError("the engine's streams differ run to run")
    idx = range(compare) if isinstance(compare, int) else compare
    m["held_to_serial"] = list(idx)
    if idx:
        checks = hold_to_serial(model, params, replay, prompts, idx, rtol)
        log(f"[{tag}-parity] " + json.dumps({
            "arch": cfg.name, "compared": len(checks),
            "matched_whole": sum(c["match"] for c in checks),
            "streams": checks}))
    if profile:
        eng = serve_run(model, params, prompts[:num_slots], max_tokens,
                        device, False, **kw)[0]
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


# gemma2_serve's two prompts past gemma2-27b's 4096-key window: their
# local layers' prefill caches become rings at insert, and the cap of
# the engine's 5120-slot cache, not a power of two, binds their bucket
GEMMA2_LONG_PROMPTS = (4352, 4608)


def phase_gemma2_serving(smi=None, device="cuda", cfg=None, cache_len=5120,
                         long=GEMMA2_LONG_PROMPTS, short_max=512,
                         n_short=14, max_tokens=32):
    """gemma2-27b at full width, all 46 layers (bf16, random weights
    from a seeded generator; local layers of window 4096 alternating
    with global ones, attention soft-cap 50, final soft-cap 30, tied
    embeddings), through ``phase_serving`` behind ``Engine(num_slots=8,
    cache_len=5120)``: 16 requests, 32 tokens each, closed loop, of
    which ``n_short`` prompts of 1-``short_max`` tokens (drawn as
    phi4_serve draws them) and the ``long`` ones past the window.  Every
    prefill layer launches K3 (the window sliding and the soft-cap on);
    streams 0, 1 and the last long prompt's are held to solo
    ``serve_batch`` runs (the engine dropped first: a solo run of the
    4608-token prompt computes float32 logits at every position).
    ``cfg``, ``device`` and the sizes are for a rehearsal at smoke
    width.  Prints one summary line with the whole phase's peak memory
    (the engine's warm-up prefills included).  Returns (the row, its K3
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = cfg or get_config("gemma2-27b")
    dev = torch.device(device)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    lens = [*np.random.default_rng(0).integers(1, short_max + 1, n_short),
            *long]
    past = [i for i, n in enumerate(lens) if n > cfg.window]
    if len(past) != len(long) or max(lens) + max_tokens > cache_len:
        raise ValueError("the long prompts must pass the window and fit "
                         "the cache")
    rtol = 0.25 if cfg.dtype == "bfloat16" else 1e-4
    m, launches = phase_serving(
        cfg, lens, device, max_tokens=max_tokens, num_slots=8,
        cache_len=cache_len, compare=(0, 1, past[-1]), rtol=rtol,
        params=params, tag="gemma2_serve", smi=smi)
    del params
    row = {"arch": cfg.name, "layers": cfg.num_layers,
           "window": cfg.window, "cache_len": cache_len,
           "requests": len(lens),
           # phase_serving raises unless each completed its budget
           "completed_budget": m["streams"], "max_tokens": max_tokens,
           "tokens": m["tokens"], "prompt_lens_past_window":
               [int(lens[i]) for i in past],
           "buckets": sorted({k.split("x")[1]
                              for k in m["prefill_ms_by_bucket"]}, key=int),
           "prefill_dispatches": m["dispatches"]["prefill"],
           "attention_launches": launches,
           "attention_launches_want":
               cfg.num_layers * m["dispatches"]["prefill"],
           "held_to_serial": m["held_to_serial"],
           "ttft_s": m["ttft_s"], "token_latency_ms": m["token_latency_ms"],
           "tok_per_s": m["tok_per_s"], "peak_mem_bytes": m["peak_mem_bytes"],
           # the first engine's warm-up (its (8, 5120) bucket), or the
           # replay and the solo runs, whose peak serve_run left running
           "phase_peak_mem_bytes": max(
               m["warmup_peak_mem_bytes"], torch.cuda.max_memory_allocated()
               if dev.type == "cuda" else 0), "card": smi}
    log("[gemma2_serve] " + json.dumps(row))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, launches


# ---------------------------------------------------------------------------
# Phases 7 and 8: recurrent serving
# ---------------------------------------------------------------------------
LAUNCH_KINDS = {"rglru_scan": ("rglru",), "wkv6": ("rwkv",),
                "flash_attention": ("attn", "attn_local")}


def _kernel_modules():
    from repro_torch.kernels import flash_attention, rglru_scan, wkv6
    return {"rglru_scan": rglru_scan, "wkv6": wkv6,
            "flash_attention": flash_attention}


def phase_batch_serving(cfg, device="cuda", batch=4, prompt_len=1024,
                        gen=32, reps=5, profile=False, tag="recurrent"):
    """``serve_batch`` at ``cfg``'s widths: a short warm-up, then one
    timed run over ``batch`` prompts of ``prompt_len`` tokens with the
    launch counts zeroed just before it.  Its one prefill must launch
    one kernel per layer of the kernel's kinds (on the card).  Then
    ``reps`` runs of the same prompts with one sampled token each, whose
    prefill walls and one decode step's (host clock after a
    synchronise, so they spread with the host's load) are kept with
    their medians; with ``profile``, one such run's device busy
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
    reruns = [serve_batch(model, params, prompts, 1, verbose=False)[1]
              for _ in range(reps)]
    runs = [r["prefill_s"] * 1e3 for r in reruns]
    steps = [r["decode_s"] * 1e3 for r in reruns]
    metrics = {"arch": cfg.name, "layers": cfg.num_layers,
               "dtype": cfg.dtype, "batch": batch,
               "prompt_len": prompt_len, "gen": gen,
               "prefill_ms": stats["prefill_s"] * 1e3,
               "prefill_ms_runs": runs,
               "prefill_ms_median": float(np.median(runs)),
               "decode_step_ms_runs": steps,
               "decode_step_ms_median": float(np.median(steps)),
               "decode_s": stats["decode_s"],
               "decode_tok_per_s": stats["tok_per_s"],
               "generated": stats["generated"], "peak_mem_bytes": peak,
               "launches": launches, "logits_finite": finite}
    log(f"[{tag}] " + json.dumps(metrics))
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


def phase_smoke_parity(arch, device="cuda", prompt_len=100, gen=8,
                       rtol=1e-4, cfg=None, tag="rec-parity"):
    """The smoke of ``arch`` (or ``cfg``) in float32 through
    ``serve_batch`` on ``device`` and on the CPU with the same weights:
    streams under the parity rule, logits within ``rtol`` of the
    largest; and prefill(P) followed by decode steps against one
    prefill(P + n) on ``device``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.serving import compare_stream, serve_batch
    cfg = (cfg or get_smoke(arch)).replace(dtype="float32",
                                           param_dtype="float32")
    model = Model(cfg)
    dev = torch.device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cpu_params = model.init(device="cpu")
    cpu_params.load_state_dict({n: t.cpu() for n, t in
                                params.state_dict().items()})
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, prompt_len)).astype(
        np.int32)
    extra = {}
    if cfg.is_encoder_decoder:     # the stubbed frontend's frames
        extra["frames"] = rng.normal(
            0, 1, (3, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    toks, stats = serve_batch(model, params, prompts, gen, extra=extra,
                              verbose=False, keep_logits=True)
    ctoks, cstats = serve_batch(model, cpu_params, prompts, gen,
                                extra=extra, verbose=False,
                                keep_logits=True)
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
        lg, _ = model.logits(params, {
            "tokens": torch.as_tensor(longer, device=dev),
            **{k: torch.as_tensor(v, device=dev) for k, v in extra.items()}},
            mode="prefill")
    handoff = float((lg[:, -1] - stats["logits"][:, gen - 1]).abs().max())
    row = {"arch": cfg.name, "compared": len(checks),
           "matched_whole": sum(c["match"] for c in checks),
           "max_diff": max(c["max_diff"] for c in checks),
           "logit_scale": scale, "handoff_max_diff": handoff}
    log(f"[{tag}] " + json.dumps(row))
    if handoff > rtol * scale:
        raise AssertionError(f"{cfg.name}: prefill(P) + decode != "
                             f"prefill(P + n): {handoff}")
    return row


# ---------------------------------------------------------------------------
# Phases 8b-8d: the MoE archs and the other decoder archs
# ---------------------------------------------------------------------------
NEW_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b", "stablelm-3b", "granite-20b",
             "llava-next-mistral-7b")
# mixtral-8x7b's depth on one card: 16 of its 32 layers (23.5 B
# parameters, 47.0 GB in bf16; all 32 are 93.4 GB)
MIXTRAL_LAYERS = 16


def no_drop(cfg):
    """``cfg`` at capacity factor ceil(E / K): every expert can hold
    every token, so nothing drops and a token's routing does not depend
    on the other rows of its batch."""
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=float(math.ceil(m.num_experts / m.top_k))))


class DropCount:
    """While entered, counts every MoE dispatch's picks and the picks it
    dropped past the capacity (``moe.route`` wrapped; the device counts
    are read once, after the run).  It adds a reduction to each
    dispatch, so it wraps only an untimed run."""

    def __enter__(self):
        from repro_torch.models import moe as M
        self.module, self.route = M, M.route
        self.dropped, self.picks = [], 0

        def counting(cfg, p, xf):
            r = self.route(cfg, p, xf)
            self.dropped.append((r.pos == r.slot_tok.shape[1]).sum())
            self.picks += r.pos.numel()
            return r

        M.route = counting
        return self

    def __exit__(self, *exc):
        self.module.route = self.route

    @property
    def share(self):
        n = int(torch.stack(self.dropped).sum()) if self.dropped else 0
        return n / max(self.picks, 1)


def moe_run_to_run(cfg, block, batch=8, seq=512, seed=4):
    """One full-width MoE block's ``moe_apply`` on one bf16 input
    (``batch`` x ``seq`` tokens: the engine's largest bucket), twice at
    ``cfg``'s capacity factor: the outputs and aux losses must be equal
    bit for bit (the combine gathers; no float atomics)."""
    from repro_torch.models import moe as M
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        y, aux = M.moe_apply(cfg, block.ffn, x)
        y2, aux2 = M.moe_apply(cfg, block.ffn, x)
    torch.cuda.synchronize()
    same = torch.equal(y, y2) and torch.equal(aux, aux2)
    row = {"arch": cfg.name, "capacity_factor": cfg.moe.capacity_factor,
           "tokens": batch * seq, "identical_run_to_run": same,
           "finite": bool(torch.isfinite(y).all())}
    log("[moe-repeat] " + json.dumps(row))
    if not same or not row["finite"]:
        raise AssertionError(f"moe_apply differs run to run: {row}")


def phase_moe_serving(n_requests=8, max_tokens=32, compare=3):
    """deepseek-moe-16b at full width, all 28 layers (bf16, random
    weights from a seeded generator), through ``phase_serving`` behind
    ``Engine(num_slots=8, cache_len=1024)``: 8 requests of 1-512 prompt
    tokens, 32 tokens each, closed loop, at the config's capacity
    factor 1.25 (the share of picks dropped, counted in the untimed
    replay, printed; rows couple through the drops there) and at the
    no-drop 11.0, where nothing may drop and the streams are held to
    solo ``serve_batch`` runs under the gap-guarded rule.  Then one MoE
    block's ``moe_apply`` twice on one input at each factor, equal bit
    for bit.  Every prefill layer launches K3.  Returns the two timed
    runs' K3 launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("deepseek-moe-16b")
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    lens = np.random.default_rng(0).integers(1, 513, n_requests)
    total = 0
    for c, k in ((cfg, 0), (no_drop(cfg), compare)):
        drops = DropCount()
        _, launches = phase_serving(c, lens, max_tokens=max_tokens,
                                    compare=k, params=params,
                                    counter=drops, tag="moe-serve")
        log("[moe-drops] " + json.dumps({
            "arch": cfg.name, "capacity_factor": c.moe.capacity_factor,
            "dropped_share": drops.share, "picks": drops.picks}))
        total += launches
        moe_run_to_run(c, params.blocks[cfg.moe.first_k_dense])
    if drops.share != 0.0:
        raise AssertionError("picks dropped at the no-drop capacity")
    del params
    torch.cuda.empty_cache()
    return total


def phase_llava(batch=2, prompt_len=128, gen=8, reps=3):
    """llava-next-mistral-7b at full width (bf16, random weights): a
    prefill over 2880 stub patch embeddings + 128 tokens a row (K3 once
    a layer at S = 3008), then ``gen`` greedy decode steps at positions
    2880 + 128 + i, each timed to a synchronise; ``reps`` more prefills
    for a median.  Returns the first prefill's K3 launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.distill import make_decode_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    cfg = get_config("llava-next-mistral-7b")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    Se = cfg.frontend_embeds
    embeds = (torch.randn((batch, Se, cfg.d_model), generator=g,
                          device="cuda") * 0.02).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device="cuda")
    decode = make_decode_step(model)

    @torch.inference_mode()
    def prefill():
        lg, cache = model.logits(params, {"tokens": tokens,
                                          "embeds": embeds}, mode="prefill")
        return lg[:, -1], cache

    prefill()                                         # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = fa.launches
    cache = model.grow_cache(cache, gen)
    tok = torch.argmax(logits, dim=-1)[:, None]
    kept, toks, steps = [logits], [tok], []
    for i in range(gen):
        t0 = time.perf_counter()
        tok, cache, logits = decode(params, tok, cache, Se + prompt_len + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        kept.append(logits)
        toks.append(tok)
    peak = torch.cuda.max_memory_allocated()
    del cache
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    finite = bool(torch.isfinite(torch.stack(kept)).all())
    ids = torch.cat(toks, dim=1)
    row = {"arch": cfg.name, "dtype": cfg.dtype, "batch": batch,
           "frontend_embeds": Se, "prompt_len": prompt_len, "gen": gen,
           "prefill_positions": Se + prompt_len,
           "decode_positions": [Se + prompt_len, Se + prompt_len + gen - 1],
           "prefill_ms": t_prefill * 1e3, "prefill_ms_runs": runs,
           "prefill_ms_median": float(np.median(runs)),
           "decode_step_ms_runs": steps,
           "decode_step_ms_median": float(np.median(steps)),
           "decode_tok_per_s": batch * gen / sum(steps) * 1e3,
           "peak_mem_bytes": peak, "attention_launches": launches,
           "logits_finite": finite}
    log("[llava] " + json.dumps(row))
    if launches != cfg.num_layers:
        raise AssertionError(f"llava prefill: {launches} K3 launches != "
                             f"{cfg.num_layers} layers")
    if not finite or not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError("llava: non-finite logits or a token out of "
                             "the vocabulary")
    del params, kept
    torch.cuda.empty_cache()
    return launches


def phase_dense_archs():
    """granite-20b (all 52 layers, 48 q heads on one kv head) and
    stablelm-3b (K3 at head dim 80) through ``serve_batch`` at full
    width: 4 prompts of 1024 tokens, 32 tokens each; mixtral-8x7b at
    full width and 16 of its 32 layers: one prompt of 4608 tokens
    (past its 4096-key window: the sliding-window prefill and the
    ring), 8 tokens; then llava (``phase_llava``).  Each prefill
    launches K3 once a layer.  Returns the timed runs' K3 launches."""
    from repro_torch.configs import get_config
    mixtral = get_config("mixtral-8x7b").replace(num_layers=MIXTRAL_LAYERS)
    log(f"[dense] mixtral-8x7b runs {MIXTRAL_LAYERS} of its "
        f"{get_config('mixtral-8x7b').num_layers} layers (a depth cut: all "
        "of them do not fit one card)")
    total = 0
    for cfg, kw in ((get_config("granite-20b"), dict(batch=4)),
                    (get_config("stablelm-3b"), dict(batch=4)),
                    (mixtral, dict(batch=1, prompt_len=4608, gen=8))):
        m, launches = phase_batch_serving(cfg, reps=3, tag="dense", **kw)
        if cfg.head_dim_ == 80:   # stablelm-3b: K3 launched at dh 80
            log("[dense-dh80] " + json.dumps({
                "arch": cfg.name, "batch": m["batch"],
                "prompt_len": m["prompt_len"],
                "prefill_ms_median": m["prefill_ms_median"],
                "prefill_ms_runs": m["prefill_ms_runs"],
                "k3_launches": launches["flash_attention"]}))
        total += launches["flash_attention"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return total + phase_llava()


def llava_embeds_parity(prompt_len=24, gen=4, rtol=1e-4):
    """llava's smoke in float32 with its stub embeddings, card against
    CPU with the same weights: the prefill's logits and ``gen`` decode
    steps at positions Se + P + i (both fed the CPU's tokens) within
    ``rtol`` of the CPU's largest |logit|."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    cfg = get_smoke("llava-next-mistral-7b").replace(dtype="float32",
                                                     param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cpu = model.init(device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in params.state_dict().items()})
    rng = np.random.default_rng(3)
    Se = cfg.frontend_embeds
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)),
        "embeds": torch.from_numpy(rng.normal(
            0, 1, (2, Se, cfg.d_model)).astype(np.float32))}
    with torch.inference_mode():
        want, ccache = model.logits(cpu, batch, mode="prefill")
        got, gcache = model.logits(params, {k: t.cuda() for k, t in
                                            batch.items()}, mode="prefill")
        errs = [float((got.cpu() - want).abs().max())]
        scale = float(want.abs().max())
        ccache, gcache = model.grow_cache(ccache, gen), \
            model.grow_cache(gcache, gen)
        tok = torch.argmax(want[:, -1], dim=-1)[:, None]
        for i in range(gen):
            w, ccache = model.logits(cpu, {"tokens": tok}, mode="decode",
                                     cache=ccache, pos=Se + prompt_len + i)
            g, gcache = model.logits(params, {"tokens": tok.cuda()},
                                     mode="decode", cache=gcache,
                                     pos=Se + prompt_len + i)
            errs.append(float((g.cpu() - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
            tok = torch.argmax(w[:, -1], dim=-1)[:, None]
    row = {"arch": cfg.name, "frontend_embeds": Se, "prompt_len": prompt_len,
           "gen": gen, "max_diff": max(errs), "logit_scale": scale}
    log("[arch-parity] " + json.dumps(row))
    if max(errs) > rtol * scale:
        raise AssertionError(f"llava embeds: card != CPU: {row}")
    return row


def phase_arch_parity():
    """Every new arch's smoke in float32 on the card against the CPU
    (``phase_smoke_parity``: serve_batch streams, logits within 1e-4 of
    the largest, prefill(P) + decode against prefill(P + n); the MoE
    smokes at their no-drop capacity, where the handoff is exact),
    llava's embeddings path, and one train step of the deepseek-moe,
    granite (8:1 MQA), mixtral and llava (its stub embeddings) smokes,
    the MoE smokes at their own capacity, card against CPU
    (``lm_card_vs_cpu``: loss and gradients within 1e-4, exact K3 and
    N1 launches); then whisper-tiny's smoke with 100
    frames (a ragged last key tile) through ``serve_batch`` and one
    train step the same way.  Returns those steps' launches."""
    from repro_torch.configs import get_smoke
    for arch in NEW_ARCHS:
        cfg = get_smoke(arch)
        phase_smoke_parity(arch, cfg=no_drop(cfg) if cfg.moe else cfg,
                           tag="arch-parity")
    llava_embeds_parity()
    runs = [lm_card_vs_cpu(arch, steps=1) for arch in (
        "deepseek-moe-16b", "granite-20b", "mixtral-8x7b",
        "llava-next-mistral-7b")]
    whisper = whisper_smoke()
    phase_smoke_parity("whisper-tiny", cfg=whisper, prompt_len=40,
                       tag="arch-parity")
    runs.append(lm_card_vs_cpu("whisper-tiny", steps=1, cfg=whisper))
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def whisper_smoke():
    """whisper-tiny's smoke with 100 frames beside the reference's 64:
    1500's last 64-key tile is ragged, and so is 100's."""
    from repro_torch.configs import get_smoke
    return get_smoke("whisper-tiny").replace(encoder_seq_len=100,
                                             frontend_embeds=100)


# ---------------------------------------------------------------------------
# Phase 8e: whisper-tiny, the encoder-decoder, at full width
# ---------------------------------------------------------------------------
def whisper_model(seed=0):
    """(cfg, Model, serving module): whisper-tiny at full width (4 + 4
    layers, d 384, 6 heads of 64, vocab 51,865), bf16, random weights
    from a seeded generator on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("whisper-tiny")
    model = Model(cfg)
    return cfg, model, model.init(
        torch.Generator(device="cuda").manual_seed(seed))


def whisper_serve(smi, batch=8, prompt_len=64, gen=32, reps=5):
    """whisper_serve: ``serve_batch`` of ``batch`` rows of ``prompt_len``
    prompt tokens with 1500 random stub frames each, ``gen`` tokens.
    The timed run's launches are counted from 0: its one prefill must
    launch K3 once an encoder layer and twice a decoder layer (self and
    cross attention: 12), its decode steps none (one query row takes the
    plain path).  Then ``reps`` runs of one token, whose prefill walls
    give the median and whose one decode step each gives one step's
    wall, each with its own 12 launches.  Every stream completes, every
    logit is finite.  Returns (row, K3 launches, a closure that runs one
    prefill, for ``--profile``)."""
    from repro_torch.core.distill import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.serving import serve_batch
    cfg, model, params = whisper_model()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)
    frames = torch.as_tensor(rng.normal(
        0, 1, (batch, cfg.encoder_seq_len, cfg.d_model))).to(
            L.dtype_of(cfg.dtype)).cuda()
    extra = {"frames": frames}
    serve_batch(model, params, prompts[:, :8], 2, extra=extra,
                verbose=False)                                  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_prefill = cfg.num_encoder_layers + 2 * cfg.num_layers
    fa.launches = 0
    toks, stats = serve_batch(model, params, prompts, gen, extra=extra,
                              verbose=False, keep_logits=True)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(stats["logits"]).all())
    reruns, rerun_launches = [], []
    for _ in range(reps):
        fa.launches = 0
        reruns.append(serve_batch(model, params, prompts, 1, extra=extra,
                                  verbose=False)[1])
        rerun_launches.append(fa.launches)
    runs = [r["prefill_s"] * 1e3 for r in reruns]
    steps = [r["decode_s"] * 1e3 for r in reruns]
    row = {"arch": cfg.name, "layers": [cfg.num_encoder_layers,
                                        cfg.num_layers],
           "dtype": cfg.dtype, "batch": batch, "prompt_len": prompt_len,
           "frames": cfg.encoder_seq_len, "gen": gen,
           "prefill_ms": stats["prefill_s"] * 1e3, "prefill_ms_runs": runs,
           "prefill_ms_median": float(np.median(runs)),
           "decode_step_ms_runs": steps,
           "decode_step_ms_median": float(np.median(steps)),
           "decode_s": stats["decode_s"],
           "decode_tok_per_s": stats["tok_per_s"],
           "generated": stats["generated"], "peak_mem_bytes": peak,
           "k3_launches": launches, "k3_per_prefill": per_prefill,
           "k3_in_decode_steps": launches - per_prefill,
           "k3_launches_reruns": rerun_launches, "logits_finite": finite,
           "card": smi}
    log("[whisper-serve] " + json.dumps(row))
    if launches != per_prefill or set(rerun_launches) != {per_prefill}:
        raise AssertionError(f"whisper serving launched K3 {launches} "
                             f"times ({rerun_launches} in the reruns), not "
                             f"{per_prefill} a prefill and 0 a decode step")
    if toks.shape != (batch, gen) or stats["generated"] != batch * gen:
        raise AssertionError("whisper: not every stream completed")
    if not finite or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError("whisper: non-finite logits or a token out "
                             "of the vocabulary")
    prefill = make_prefill_step(model)
    batch_in = {"tokens": torch.as_tensor(prompts, device="cuda"),
                "frames": frames}
    return row, launches + sum(rerun_launches), \
        lambda: prefill(params, batch_in)


# whisper-tiny's peak learning rate (arXiv:2212.04356, its training
# hyperparameters), and the ids its synthetic transcripts are drawn from:
# a sparse bigram stream over the whole 51,865-id vocabulary has a flat
# unigram distribution that 8 steps of 1,024 tokens cannot learn, so the
# loss could not fall; over the first 4,096 ids it has the skew real
# transcripts have
WHISPER_LR = 1.5e-3
WHISPER_DATA_VOCAB = 4096


def whisper_train(smi, batch=8, seq=128, steps=8):
    """whisper_train: ``make_train_step`` at full width (bf16 compute on
    float32 masters, AdamW, remat), ``batch`` x ``seq`` decoder tokens
    plus 1500 random frames a row, ``steps`` steps, warmup 2, lr
    ``WHISPER_LR``, tokens from a synthetic bigram stream over
    ``WHISPER_DATA_VOCAB`` ids.
    Step walls (host clock; ``float(loss)`` synchronises), tokens/s over
    the median of the last 6, peak memory, and the launches of the run
    (counted from 0 just before it): per step K3 4 + 2 x 8 and N1 4 + 8
    calls (three kernels each).  Finite losses, the last below the
    first.  Returns (row, launches, a closure that runs one step, for
    ``--profile``)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.distill import make_train_step
    from repro_torch.data import TokenDataset, synthetic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.tree_util import tree_leaves
    cfg, model, module = whisper_model()
    params = transformer.tree_of(module)
    del module
    tcfg = TrainConfig(batch_size=batch, seq_len=seq, steps=steps,
                       warmup_steps=2, learning_rate=WHISPER_LR)
    step, opt = make_train_step(model, tcfg)
    state = opt.init(params)
    data = synthetic.tokens(n_seqs=2 * batch * steps, seq_len=seq + 1,
                            vocab=WHISPER_DATA_VOCAB, seed=1)["train"]
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for b in TokenDataset(data).batches(batch, steps=steps):
        b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        b["frames"] = torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                                  generator=g, device="cuda")
        batches.append(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    got = _lm_counts()
    want = {k: n * steps for k, n in step_launches(cfg).items()}
    med = float(np.median(step_ms[-6:]))
    row = {"arch": cfg.name, "params": sum(t.numel() for t in
                                           tree_leaves(params)),
           "dtype": cfg.dtype, "B": batch, "S": seq,
           "frames": cfg.encoder_seq_len, "steps": steps,
           "lr": WHISPER_LR, "data_vocab": WHISPER_DATA_VOCAB,
           "losses": losses,
           "step_ms": step_ms, "step_ms_median_last6": med,
           "tokens_per_s": batch * seq / med * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v // steps for k, v in got.items()},
           "card": smi}
    log("[whisper-train] " + json.dumps(row))
    if got != want:
        raise AssertionError(f"whisper train launches {got} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite whisper training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"whisper loss did not fall: {losses}")
    return row, got, lambda: step(params, state, batches[0])


def phase_whisper(smi):
    """Phase 8e: whisper_serve, then whisper_train.  Returns (rows, the
    main path's launches, [(name, closure)] for ``--profile``)."""
    serve_row, k3, prefill = whisper_serve(smi)
    torch.cuda.empty_cache()
    train_row, counts, train_step = whisper_train(smi)
    torch.cuda.empty_cache()
    counts = dict(counts, flash_attention=counts["flash_attention"] + k3)
    return [serve_row, train_row], counts, [
        ("prefill_whisper-tiny_8x64", prefill),
        ("train_step_whisper-tiny_8x128", train_step)]


# ---------------------------------------------------------------------------
# Phase 9: LM training (lm_train)
# ---------------------------------------------------------------------------
def sdpa_backward_best(q, k, v, do, want, tol, causal=True, mask=None,
                       required=True):
    """The library yardstick of the attention backward: autograd of one
    ``scaled_dot_product_attention`` call (``is_causal`` = ``causal``,
    or the explicit boolean ``mask`` (Sq, Skv) where one is given: a
    sliding window shorter than S) at the same shape, its backward alone
    (CUDA events over repeated ``autograd.grad`` on one retained graph),
    on the fastest of SDPA's backends that take the call, each pinned
    with ``sdpa_kernel``, as ``sdpa_best`` times the forward: (ms,
    backend, {backend: ms} of every backend that took it).  Each
    backend's gradients are held to ``want`` (N1's) within ``tol`` of
    the largest |gradient|; where a backend refuses ``enable_gqa``, k
    and v are expanded to q's heads and their gradients summed over the
    group outside the timed call.  Where no backend takes the call it
    raises, or returns None when not ``required``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    B, H, _, dh = qt.shape
    KV, Skv = kt.shape[1], kt.shape[2]
    g = do.transpose(1, 2)
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        for expand in (False, True):
            kv = (t.repeat_interleave(H // KV, 1) if expand else t
                  for t in (kt, vt))
            leaves = [t.detach().requires_grad_(True) for t in (qt, *kv)]
            with sdpa_kernel([backend]):
                try:
                    out = F.scaled_dot_product_attention(
                        *leaves, **({"attn_mask": mask} if mask is not None
                                    else {"is_causal": causal}),
                        **({} if expand else {"enable_gqa": True}))
                    grads = torch.autograd.grad(out, leaves, g,
                                                retain_graph=True)
                    torch.cuda.synchronize()
                except RuntimeError:
                    continue
                ms = cuda_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), reps=10)
            dq, dk, dv = grads
            if expand:
                dk, dv = (t.reshape(B, KV, H // KV, Skv, dh).sum(2)
                          for t in (dk, dv))
            label = name.lower() + ("+expanded_kv" if expand else "")
            for a, w in zip((dq, dk, dv), want):
                e = float((a.transpose(1, 2).float() - w.float()).abs()
                          .max())
                if e > tol * float(w.float().abs().max()):
                    raise AssertionError(f"SDPA backward ({label}) != N1: "
                                         f"{e}")
            times[label] = ms
            del out, grads, leaves
            break
    if not times:
        if not required:
            return None
        raise AssertionError("no SDPA backend takes the backward")
    label = min(times, key=times.get)
    return times[label], label, times


def lm_backward_rows():
    """N1, the flash-attention backward, against
    ``ref.attention_backward_plain`` on the card at phi4-mini's training
    shape, a gemma2-like one (window shorter than S, soft-cap 50), a
    float32 dh-32 one, whisper-tiny's non-causal ones over 1500
    frames: (m) the encoder (Sq = Skv = 1500) and (n) cross attention
    (N1b: Sq 128 decoder tokens, Skv 1500), a granite-like 48:1 group
    (one kv head: 16 key tiles, the group's q heads split over 9 CTAs
    each) and granite_train's (4, 512, 48:1; 32 tiles, 5 splits),
    recurrentgemma's local attention at dh 256 (10:1, window
    2048) at its train shape (4, 512) and at (1, 4096), where the window
    is shorter than S, stablelm-3b's train shape at its native head
    dim 80 (4, 512, MHA 32:32), deepseek-moe-16b's (4, 512, MHA
    16:16, dh 128), llava_train's (1, 4096, 32:8, dh 128) and one batch
    row of gemma2_train's (1, 8192, 32:16, dh 128, soft-cap 50) at a
    local layer (window 4096) and a global one; then in float32 (the
    split-TF32 kernels) phi4's, stablelm's (dh 80) and recurrentgemma's
    (dh 256) train shapes and whisper's (m): within ``BWD_TOL`` of the
    largest |gradient| (2e-2 bf16, 1e-5 float32), identical run to run;
    kernel, plain and library times beside the bound (SDPA under an
    explicit window mask where the window is shorter than S, null where
    no backend takes that).  The forward's row LSE is held to
    ``ref.attention_plain``'s, and N1's gradients (from K3's o and LSE)
    also to the plain backward from the plain forward's own o and LSE,
    so that forward and backward together are held to the plain
    versions.  Returns (rows, the worst absolute error, the worst error
    relative to the largest |gradient|)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels.meta import valid_pairs
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [  # label, B, Sq, Skv, H, KV, dh, dtype, window, softcap, causal
        ("phi4_train", 4, 512, 512, 24, 8, 128, torch.bfloat16, 0, 0.0,
         True),
        ("gemma2_like", 1, 2048, 2048, 32, 16, 128, torch.bfloat16, 1024,
         50.0, True),
        ("f32_dh32", 2, 384, 384, 8, 2, 32, torch.float32, 64, 30.0, True),
        ("m_whisper_encoder", 8, 1500, 1500, 6, 6, 64, torch.bfloat16, 0,
         0.0, False),
        ("n_whisper_cross", 8, 128, 1500, 6, 6, 64, torch.bfloat16, 0, 0.0,
         False),
        ("granite_like", 1, 1024, 1024, 48, 1, 128, torch.bfloat16, 0, 0.0,
         True),
        ("granite_train", 4, 512, 512, 48, 1, 128, torch.bfloat16, 0, 0.0,
         True),
        ("recurrentgemma_train", 4, 512, 512, 10, 1, 256, torch.bfloat16,
         2048, 0.0, True),
        ("recurrentgemma_long", 1, 4096, 4096, 10, 1, 256, torch.bfloat16,
         2048, 0.0, True),
        ("stablelm_train", 4, 512, 512, 32, 32, 80, torch.bfloat16, 0, 0.0,
         True),
        ("deepseek_train", 4, 512, 512, 16, 16, 128, torch.bfloat16, 0,
         0.0, True),
        ("llava_train", 1, 4096, 4096, 32, 8, 128, torch.bfloat16, 0, 0.0,
         True),
        # one batch row of gemma2_train's step: a local layer (the window
        # binds) and a global one, both soft-capped
        ("gemma2_train_local", 1, 8192, 8192, 32, 16, 128, torch.bfloat16,
         4096, 50.0, True),
        ("gemma2_train_global", 1, 8192, 8192, 32, 16, 128, torch.bfloat16,
         0, 50.0, True),
        # float32 (split TF32): phi4's and stablelm's train shapes,
        # recurrentgemma's (dh 256, window 2048: recurrentgemma_f32_train's
        # N1) and whisper's (m) encoder
        ("phi4_train_f32", 4, 512, 512, 24, 8, 128, torch.float32, 0, 0.0,
         True),
        ("stablelm_train_f32", 4, 512, 512, 32, 32, 80, torch.float32, 0,
         0.0, True),
        ("recurrentgemma_train_f32", 4, 512, 512, 10, 1, 256, torch.float32,
         2048, 0.0, True),
        ("m_whisper_encoder_f32", 8, 1500, 1500, 6, 6, 64, torch.float32, 0,
         0.0, False)]
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    for label, B, S, Skv, H, KV, dh, dt, window, cap, causal in cases:
        q, do = (torch.randn((B, S, H, dh), device="cuda", generator=g)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((B, Skv, KV, dh), device="cuda", generator=g)
                .to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        if not bool(torch.isfinite(lse).all()):
            raise AssertionError(f"a training row sees no key at {label}")
        o_plain, lse_plain = ref.attention_plain(q, k, v, return_lse=True,
                                                 **kw)
        lse_err = float((lse - lse_plain).abs().max())
        if lse_err > LSE_TOL[dt]:
            raise AssertionError(f"K3's LSE != plain at {label}: {lse_err}"
                                 f" > {LSE_TOL[dt]}")
        got = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
        again = fa.flash_attention_backward(q, k, v, o, do, lse, **kw)
        want = ref.attention_backward_plain(q, k, v, o, do, lse, **kw)
        whole = ref.attention_backward_plain(q, k, v, o_plain, do,
                                             lse_plain, **kw)
        torch.cuda.synchronize()
        tol, err, rel, whole_rel = BWD_TOL[dt], 0.0, 0.0, 0.0
        for name, a, b, w, p in zip(("dq", "dk", "dv"), got, again, want,
                                    whole):
            if not torch.equal(a, b):
                raise AssertionError(f"N1 {name} differs run to run at "
                                     f"{label}")
            e = float((a.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            if e > tol * scale:
                raise AssertionError(f"N1 {name} != plain at {label}: "
                                     f"{e} > {tol} x {scale}")
            e_whole = float((a.float() - p.float()).abs().max())
            s_whole = float(p.float().abs().max())
            if e_whole > tol * s_whole:
                raise AssertionError(
                    f"K3 + N1 {name} != plain forward + backward at "
                    f"{label}: {e_whole} > {tol} x {s_whole}")
            err, rel = max(err, e), max(rel, e / scale)
            whole_rel = max(whole_rel, e_whole / s_whole)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        # SDPA under is_causal where the window covers S; an explicit
        # mask where it does not (not every backend takes one)
        covers = window == 0 or window >= Skv
        lib_call = f"is_causal={causal}" if covers else "a window mask"
        mask = None if covers else ref._mask(
            torch.arange(S, device="cuda"), Skv, causal, window, "cuda")
        lib = None if cap else sdpa_backward_best(
            q, k, v, do, got, ATT_TOL[dt], causal=causal, mask=mask,
            required=covers)
        del again, want, whole, o_plain, lse_plain
        ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, do,
                                                         lse, **kw), reps=10)
        dev = graph_ms(lambda: fa.flash_attention_backward(
            q, k, v, o, do, lse, **kw), reps=10)
        plain = cuda_ms(lambda: ref.attention_backward_plain(
            q, k, v, o, do, lse, **kw), reps=3, warmup=1)
        e = q.element_size()
        nbytes = (e * (3 * q.numel() + 2 * (k.numel() + v.numel())
                       + o.numel()) + 4 * lse.numel())
        nops = 10 * B * H * valid_pairs(S, Skv, causal, window) * dh
        b_ms, b_by = attention_bound(nbytes, nops, dt)
        row = {"kernel": "flash_attention_backward", "shape": label,
               "B": B, "S": S, "Skv": Skv, "causal": causal, "H": H,
               "KV": KV, "dh": dh, "dtype": str(dt),
               "window": window, "softcap": cap, "max_abs_err": err,
               "max_rel_err": rel, "tol": tol,
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL[dt],
               "max_rel_err_vs_plain_forward_backward": whole_rel,
               "kernel_ms": ms, "graph_ms": dev, "plain_ms": plain,
               "library_ms": None if lib is None else lib[0],
               "library": None if lib is None else
               f"autograd of SDPA ({lib_call}), backward only, fastest "
               "backend",
               "library_backend": None if lib is None else lib[1],
               "library_variants": None if lib is None else lib[2],
               "kernel_over_library": None if lib is None else ms / lib[0],
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
               "bytes": nbytes, "flop": nops,
               "head_splits": fa.bwd_head_splits(
                   B, Skv, KV, H, dh, torch.cuda.get_device_properties(0)
                   .multi_processor_count),
               "bit_identical_run_to_run": True}
        log("[kernel] " + json.dumps(row))
        rows.append(row)
        del q, k, v, o, lse, do, got
        torch.cuda.empty_cache()
    return rows, worst_abs, worst_rel


def rglru_backward_rows():
    """N2a, the RG-LRU scan's backward, against
    ``ref.rglru_scan_backward_plain`` bit for bit (dx, dlog_a, dh0) at
    recurrentgemma-2b's train shape (4 x 512 x 2560, bf16), at S 1024, at
    a ragged S 1000 and in float32, each from a nonzero h0 with a nonzero
    dh_last, from the checkpoints K4 wrote (as training runs it), and the
    checkpoints themselves bit for bit the plain carries; identical run
    to run.  Composed with its forward through ``RGLRUScan`` (autograd:
    K4, then N2a): h, h_last and the gradients equal the plain forward's
    and the plain backward's bit for bit.  Bound: x, log_a, dh and the
    checkpoints read, dx, dlog_a written, dh_last read and dh0 written; 7
    operations an element (the carry rebuilt once: exp, multiply, add;
    the reverse walk's + dh, g a, its product with h_{t-1}, a g).
    Returns (rows, the worst absolute error)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = [("recurrentgemma_train", 4, 512, 2560, torch.bfloat16),
             ("S1024", 4, 1024, 2560, torch.bfloat16),
             ("ragged_S1000", 4, 1000, 2560, torch.bfloat16),
             ("f32_small", 2, 1000, 512, torch.float32)]
    rows, worst = [], 0.0
    for label, B, S, D, dt in cases:
        x, dh = (torch.randn((B, S, D), device="cuda", generator=g).to(dt)
                 for _ in range(2))
        log_a = (-torch.rand((B, S, D), device="cuda", generator=g)
                 * 0.5).to(dt)
        h0, dl = (torch.randn((B, D), device="cuda", generator=g) * 0.5
                  for _ in range(2))
        _, _, ck = rg.rglru_scan(x, log_a, h0, checkpoints=True)
        got = rg.rglru_scan_backward(x, log_a, ck, dh, dl)
        again = rg.rglru_scan_backward(x, log_a, ck, dh, dl)
        want = ref.rglru_scan_backward_plain(x, log_a, h0, dh, dl)
        carry, want_ck = h0, []
        for t in range(S):
            if t % rg.CHECKPOINT_STEPS[dt] == 0:
                want_ck.append(carry)
            carry = torch.exp(log_a[:, t].float()) * carry + x[:, t].float()
        if not same_bits(ck, torch.stack(want_ck, 1)):
            raise AssertionError(f"K4's checkpoints != the plain carries at "
                                 f"{label}")
        leaves = [t.clone().requires_grad_(True) for t in (x, log_a, h0)]
        h, hl = rg.RGLRUScan.apply(*leaves)
        comp = torch.autograd.grad((h, hl), leaves, (dh, dl))
        want_h, want_hl = ref.rglru_scan_ref(x, log_a, h0)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b, w, c in zip(("dx", "dlog_a", "dh0"), got, again,
                                    want, comp):
            if not same_bits(a, b):
                raise AssertionError(f"N2a {name} differs run to run at "
                                     f"{label}")
            e = float((a.float() - w.float()).abs().max())
            if not (same_bits(a, w) and same_bits(c, w)):
                raise AssertionError(f"N2a {name} != plain bit for bit at "
                                     f"{label} (kernel alone or after K4 "
                                     f"through RGLRUScan): max |err| {e}")
            err = max(err, e)
        if not (same_bits(h.detach(), want_h)
                and same_bits(hl.detach(), want_hl)):
            raise AssertionError(f"RGLRUScan's forward != plain at {label}")
        worst = max(worst, err)
        del leaves, h, hl, comp, again, want, want_h, want_hl, want_ck
        ms = cuda_ms(lambda: rg.rglru_scan_backward(x, log_a, ck, dh, dl))
        dev = graph_ms(lambda: rg.rglru_scan_backward(x, log_a, ck, dh, dl))
        plain = cuda_ms(lambda: ref.rglru_scan_backward_plain(
            x, log_a, h0, dh, dl), reps=2, warmup=1)
        nbytes = (x.element_size() * 5 * x.numel() + 4 * 2 * B * D
                  + 4 * ck.numel())
        rows.append(_rec_row("rglru_scan_backward", label,
                             {"B": B, "S": S, "D": D, "graph_ms": dev,
                              "checkpoint_steps":
                                  rg.CHECKPOINT_STEPS[dt]},
                             dt, err, 0.0, ms, plain, nbytes, 7 * B * S * D))
        del x, dh, log_a, got, ck
        torch.cuda.empty_cache()
    return rows, worst


def wkv_backward_bound(B, S, H, dh, dt, nonzero):
    """(bound_ms, bound_by, operations) of N2b at (B, S, H, dh) in ``dt``.
    Bytes: r, k, v, w, dO read and dr, dk, dv, dw written, u, s0 (and
    ds_last where ``nonzero``) read, du and ds0 written.  Operations as
    the chunked design does them on these inputs (C = ``BWD_CHUNK``,
    padded steps): 10 dh^2 a step for the state-sized products (the two
    chains', X1, X2, X3) and 2 C dh for A = dO v^T, on the tensor cores
    in TF32 for bf16 (495 TFLOP/s) and as float32 FMAs for float32 (67),
    plus 9 (C - 1) dh a step (the intra-chunk terms) and 2 dh^2 a chunk
    (rowsum(G_c * S_c)) in float32; the two types' times add."""
    from repro_torch.kernels import wkv6 as wk
    C = wk.BWD_CHUNK
    nc = -(-S // C)
    steps = B * H * nc * C
    el = 2 if dt == torch.bfloat16 else 4
    nbytes = (el * 9 * B * S * H * dh + 4 * 2 * H * dh
              + 4 * (3 if nonzero else 2) * B * H * dh * dh)
    mm = (10 * dh * dh + 2 * C * dh) * steps
    fp = 9 * (C - 1) * dh * steps + 2 * dh * dh * B * H * nc
    t_ops = (mm / (TF32_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)
             + fp / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, mm + fp


def wkv_backward_rows():
    """N2b, the WKV recurrence's backward, against
    ``ref.wkv6_backward_plain`` at rwkv6-7b's train shape (4 x 512 x 64
    heads x 64, bf16) from the zero state, from a nonzero s0 with a
    nonzero ds_last, and in float32 at (2, 200, 8, 64): each of dr, dk,
    dv, dw, du, ds0 within 2e-2 (bf16) or 1e-5 (float32) of its largest
    |gradient|, identical run to run.  Composed with its forward through
    ``WKV6`` (autograd: K5, then N2b): o and s_last within K5's
    tolerances of the plain forward's, the gradients within the same
    tolerance of the plain backward's.  Bound: ``wkv_backward_bound``.
    Returns (rows, the worst absolute error, the worst error relative to
    the largest |gradient|)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    g = torch.Generator(device="cuda").manual_seed(13)
    cases = [("rwkv6_train", 4, 512, 64, torch.bfloat16, False),
             ("rwkv6_train_nonzero_s0", 4, 512, 64, torch.bfloat16, True),
             ("f32_small", 2, 200, 8, torch.float32, True)]
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
    rows, worst, worst_rel = [], 0.0, 0.0
    dh = 64
    for label, B, S, H, dt, nonzero in cases:
        r, k, v, do = (torch.randn((B, S, H, dh), device="cuda",
                                   generator=g).mul(0.5).to(dt)
                       for _ in range(4))
        w = torch.sigmoid(torch.randn((B, S, H, dh), device="cuda",
                                      generator=g) + 2.0).to(dt)
        u = torch.randn((H, dh), device="cuda", generator=g) * 0.1
        s0 = (torch.randn((B, H, dh, dh), device="cuda", generator=g) * 0.1
              if nonzero else torch.zeros((B, H, dh, dh), device="cuda"))
        dsl = (torch.randn((B, H, dh, dh), device="cuda", generator=g)
               * 0.1 if nonzero else None)
        got = wk.wkv6_backward(r, k, v, w, u, s0, do, dsl)
        again = wk.wkv6_backward(r, k, v, w, u, s0, do, dsl)
        want = ref.wkv6_backward_plain(r, k, v, w, u, s0, do, dsl)
        leaves = [t.clone().requires_grad_(True)
                  for t in (r, k, v, w, u, s0)]
        o, sl = wk.WKV6.apply(*leaves)
        comp = torch.autograd.grad(
            (o, sl), leaves, (do, torch.zeros_like(sl) if dsl is None
                              else dsl))
        want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err, rel = 0.0, 0.0
        for name, a, b, w_, c in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                                     got, again, want, comp):
            if not same_bits(a, b):
                raise AssertionError(f"N2b {name} differs run to run at "
                                     f"{label}")
            scale = float(w_.float().abs().max())
            e = float((a.float() - w_.float()).abs().max())
            e_comp = float((c.float() - w_.float()).abs().max())
            if e > tol[dt] * scale or e_comp > tol[dt] * scale:
                raise AssertionError(
                    f"N2b {name} != plain at {label}: {e} (after K5 "
                    f"through WKV6: {e_comp}) > {tol[dt]} x {scale}")
            err, rel = max(err, e), max(rel, e / scale)
        ftol = WKV_TOL[dt]
        if not (torch.allclose(o.detach().float(), want_o.float(),
                               atol=ftol, rtol=ftol)
                and torch.allclose(sl.detach(), want_s, atol=ftol,
                                   rtol=ftol)):
            raise AssertionError(f"WKV6's forward != plain at {label}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        del leaves, o, sl, comp, again, want, want_o, want_s
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: wk.wkv6_backward(r, k, v, w, u, s0, do, dsl),
                     reps=10)
        dev = graph_ms(lambda: wk.wkv6_backward(r, k, v, w, u, s0, do,
                                                dsl), reps=10)
        plain = cuda_ms(lambda: ref.wkv6_backward_plain(
            r, k, v, w, u, s0, do, dsl), reps=1, warmup=1)
        n_state = 3 if nonzero else 2            # s0, ds0 (and ds_last)
        nbytes = (r.element_size() * 9 * r.numel() + 4 * 2 * u.numel()
                  + 4 * n_state * s0.numel())
        b_ms, b_by, nops = wkv_backward_bound(B, S, H, dh, dt, nonzero)
        rows.append(_rec_row("wkv6_backward", label,
                             {"B": B, "S": S, "H": H, "dh": dh,
                              "chunk": wk.BWD_CHUNK, "graph_ms": dev,
                              "max_rel_err": rel},
                             dt, err, tol[dt], ms, plain, nbytes, nops,
                             (b_ms, b_by)))
        del r, k, v, w, do, got
        torch.cuda.empty_cache()
    return rows, worst, worst_rel


def _lm_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import vote_aggregate as va
    from repro_torch.kernels import wkv6 as wk
    return fa, va, rg, wk


def _zero_lm_counts():
    """Sets the launch counts of the LM path's kernels to 0, just before
    a main-path run."""
    fa, va, rg, wk = _lm_modules()
    fa.launches = fa.bwd_launches = fa.f32_launches = fa.f32_bwd_launches = 0
    rg.launches = rg.bwd_launches = wk.launches = wk.bwd_launches = 0
    va.launches = 0


def _lm_counts():
    """The counts since ``_zero_lm_counts``, read just after the run."""
    fa, va, rg, wk = _lm_modules()
    return {"flash_attention": fa.launches,
            "flash_attention_backward": fa.bwd_launches,
            "flash_attention_f32": fa.f32_launches,
            "flash_attention_backward_f32": fa.f32_bwd_launches,
            "vote_aggregate": va.launches, "rglru_scan": rg.launches,
            "rglru_scan_backward": rg.bwd_launches, "wkv6": wk.launches,
            "wkv6_backward": wk.bwd_launches}


def lm_train_data(cfg, S):
    """lm_full_train's token rows: 48 training sequences of S + 1 tokens
    from a seeded random bigram process over ``cfg``'s vocabulary."""
    from repro_torch.data import synthetic
    return synthetic.tokens(n_seqs=64, seq_len=S + 1, vocab=cfg.vocab_size,
                            seed=1)["train"]


def first_lm_batch(data, B, extra=None):
    """The first batch lm_full_train's data loader yields, on the card,
    with ``extra``'s entries (llava's embeddings) beside its tokens."""
    from repro_torch.data import TokenDataset
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             next(iter(TokenDataset(data).batches(B, steps=1))).items()}
    return {**batch, **(extra or {})}


def text_len(cfg, S):
    """The token columns of a row of S positions: S less the frontend's
    stub embeddings (llava's 2880), all S elsewhere."""
    return S - cfg.frontend_embeds


def lm_full_train(cfg, smi, steps=8, B=4, S=512, extra=None, lr=3e-4):
    """``launch.train.train_lm`` on ``cfg`` at full width: bf16 compute
    on float32 masters (random weights from a seeded generator), AdamW,
    remat, B x S positions a step (4 x 512 unless given; for llava
    ``extra``'s stub embeddings and ``text_len(cfg, S)`` tokens, the
    loss over the tokens alone), ``steps`` steps, warmup 2, peak
    learning rate ``lr``.  Exact
    launches a step (``train_launches``), losses finite, the first about
    ln(vocab) (near-uniform logits): within [ln V rounded to 0.01, that
    + 1.79] ([12.21, 14] at phi4-mini's 200,064), and falling: the first
    batch's loss, taken again after the last step, below its loss at the
    first step (each step sees a fresh batch of a random bigram process
    over the whole vocabulary, so the step losses of the recurrent archs
    move within the batches' spread over 8 steps); for phi4-mini also,
    as before, the last step's loss below the first.  Returns (the
    trained masters, the launches, the row)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.launch.train import train_lm
    from repro_torch.models import Model, transformer
    from repro_torch.tree_util import tree_leaves
    model = Model(cfg)
    module = model.init(torch.Generator(device="cuda").manual_seed(0))
    params = transformer.tree_of(module)
    del module
    n_params = sum(t.numel() for t in tree_leaves(params))
    tcfg = TrainConfig(batch_size=B, seq_len=S, steps=steps,
                       warmup_steps=2, learning_rate=lr)
    data = lm_train_data(cfg, text_len(cfg, S))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    out = train_lm(model, TokenDataset(data), tcfg, params=params,
                   log_every=1, extra_batch=extra, verbose=False,
                   device="cuda")
    torch.cuda.synchronize()
    got = _lm_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        again = float(model.loss(out["params"],
                                 first_lm_batch(data, B, extra)))
    L = cfg.num_layers
    want = {k: n * steps for k, n in step_launches(cfg).items()}
    if got != want:
        raise AssertionError(f"train launches {got} != {want}")
    losses = [h["loss"] for h in out["history"]]
    secs = [h["seconds"] for h in out["history"]]
    step_ms = [1e3 * (b - a) for a, b in zip(secs, secs[1:])]
    med = float(np.median(step_ms[-6:]))
    row = {"arch": cfg.name, "layers": L, "params": n_params,
           "dtype": cfg.dtype, "B": B, "S": S,
           "text_tokens": text_len(cfg, S), "steps": steps, "lr": lr,
           "losses": losses, "first_batch_loss_after": again,
           "step_ms": step_ms, "step_ms_median_last6": med,
           "tokens_per_s": B * S / med * 1e3, "peak_mem_bytes": peak,
           "launches_per_step": {k: v // steps for k, v in got.items()},
           "card": smi}
    log("[lm-train] " + json.dumps(row))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    lo = round(math.log(cfg.vocab_size), 2)
    hi = round(lo + 1.79, 2)
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"first loss {losses[0]} outside "
                             f"[ln(vocab) {lo}, {hi}]")
    if not again < losses[0]:
        raise AssertionError(f"the first batch's loss did not fall: "
                             f"{losses[0]} -> {again}")
    if cfg.name == "phi4-mini-3.8b" and not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return out["params"], got, row


# An element's first-step gradient fixes its AdamW update's sign on both
# devices when the signs agree and |g| >= this share of its leaf's
# largest |g| (the card-CPU gradient error is ~2e-6 of it).  The
# lm-parity line also reads the split at 1e-4 and 1e-3, and at
# per-element agreement, to show the margin.
ADAMW_GRAD_FLOOR = 1e-2


def adam_free_bound(lrs, b1=0.9, b2=0.999):
    """The most two AdamW runs (the optimizer's default betas) can part
    on one element when every step's update sign is free: each step
    moves each run by at most lr_t * |m_hat / sqrt(v_hat)|, which
    Cauchy-Schwarz bounds by (1 - b1) / (1 - b1^t) * sqrt((1 - b2^t) /
    (1 - b2)) * sqrt(sum_{k<t} (b1^2 / b2)^k) whatever the gradients."""
    total = 0.0
    for t, lr in enumerate(lrs, start=1):
        r = b1 * b1 / b2
        total += 2 * lr * (1 - b1) / (1 - b1 ** t) * math.sqrt(
            (1 - b2 ** t) / (1 - b2) * (1 - r ** t) / (1 - r))
    return total


def train_launches(cfg):
    """The kernel launches of one remat train step of ``cfg``, by counter,
    from its layer pattern (``cfg.layer_kinds``): an attention layer
    launches K3 twice (the forward and the recompute) and N1 once
    (``BWD_KERNELS`` kernels); an RG-LRU layer K4 twice and N2a once; an
    RWKV layer K5 twice and N2b once (its ``BWD_KERNELS``).  An
    encoder-decoder adds one K3 and one N1 call an encoder layer (not
    recomputed), and its decoder layers run two attentions each (self and
    cross)."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, RGLRU, RWKV
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import wkv6 as wk
    if cfg.is_encoder_decoder:
        E, L = cfg.num_encoder_layers, cfg.num_layers
        k3, n1, rg, rw = E + 2 * 2 * L, E + 2 * L, 0, 0
    else:
        kinds = cfg.layer_kinds
        att = sum(k in (ATTN, ATTN_LOCAL) for k in kinds)
        rg, rw = kinds.count(RGLRU), kinds.count(RWKV)
        if att + rg + rw != cfg.num_layers:
            raise ValueError(f"train_launches: unknown block kinds in "
                             f"{kinds}")
        k3, n1 = 2 * att, att
    return {"flash_attention": k3,
            "flash_attention_backward": fa.BWD_KERNELS * n1,
            "vote_aggregate": 0, "rglru_scan": 2 * rg,
            "rglru_scan_backward": rgs.BWD_KERNELS * rg, "wkv6": 2 * rw,
            "wkv6_backward": wk.BWD_KERNELS * rw}


def step_launches(cfg):
    """``train_launches(cfg)`` with K3's and N1's float32 kernels' share,
    as ``_lm_counts`` reads it (the ``_f32`` keys): all of their
    launches in a float32 config, none in a bf16 one."""
    want = train_launches(cfg)
    f32 = cfg.dtype == "float32"
    return dict(want, flash_attention_f32=want["flash_attention"] * f32,
                flash_attention_backward_f32=f32 * want[
                    "flash_attention_backward"])


# Archs whose float32 smoke is too ill-conditioned for the fixed-sign
# AdamW rule.  The lm-parity line's "cpu_grad_sensitivity" (the CPU's
# own first-step gradients under a 1e-7 relative perturbation of the
# init) reads 2.1e-5 of a leaf's largest at rwkv6, 1.5e-6 to 2.8e-6 at
# every other smoke, and rwkv6's card-CPU gap, 3.0e-5, is of the order
# of its own sensitivity (in a design call it stayed so with the WKV
# forward and backward swapped for their plain versions on the card).
# AdamW's later steps then part on sign-free elements and carry the
# fixed ones with them: rwkv6's AdamW elements are all held to the
# sign-free bound.
ADAMW_SIGN_FREE_ARCHS = ("rwkv6-7b",)


def lm_card_vs_cpu(arch, steps=5, cfg=None):
    """``make_train_step`` on the card and on the CPU from one init (the
    port's, drawn on the CPU and moved) at ``arch``'s smoke widths (or
    ``cfg``'s) in float32; an encoder-decoder's batches carry seeded
    random frames, llava's seeded random stub embeddings.  With AdamW
    (the main path's optimizer): losses within 1e-4 relative and the
    first step's gradients within 1e-4 of each leaf's largest
    |gradient|.  AdamW's first step moves an element by
    the learning rate times the SIGN of its gradient, so an element whose
    gradient is a cancelling sum near 0 (whose sign the two devices'
    orders round differently) moves one way on the card and the other
    on the CPU.  So the AdamW parameters are held in two sets, split by
    the first step's gradients: an element whose gradient has one sign
    on both devices and |g| >= ``ADAMW_GRAD_FLOOR`` of its leaf's
    largest |g| (the sign is then fixed with a margin far above the
    gradient error) must be within 1e-4 of its leaf's largest |value|,
    every one; any other element within ``adam_free_bound`` (the most
    two AdamW runs can part when every step's update sign is free) plus
    that 1e-4.  With SGD, whose update is linear in the gradient, every
    element is within 1e-4 after the same steps.  The first step's
    gradients are taken outside the counted run; the counts are the
    AdamW card run's alone.  For an arch of ``ADAMW_SIGN_FREE_ARCHS``
    every AdamW element is held to the sign-free bound (the fixed-sign
    split is still logged); the line also reads, for every arch, the
    CPU's own gradient sensitivity: the largest change, relative to each
    leaf's largest |gradient|, of the first-step gradients when the
    init is perturbed by 1e-7 of each element, on the CPU alone."""
    from repro_torch import device as D
    from repro_torch import prng
    from repro_torch.configs import TrainConfig, get_smoke
    from repro_torch.core.distill import make_train_step
    from repro_torch.data import TokenDataset, synthetic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.tree_util import flatten_tree, tree_map
    cfg = (cfg or get_smoke(arch)).replace(dtype="float32",
                                           param_dtype="float32")
    model = Model(cfg)
    init = model.init_tree(prng.PRNGKey(0), "cpu")
    data = synthetic.tokens(n_seqs=32, seq_len=97, vocab=cfg.vocab_size,
                            seed=2)["train"]
    # an encoder-decoder's frames, or a VLM's stub patch embeddings
    extra_key, n_extra = (
        ("frames", cfg.encoder_seq_len) if cfg.is_encoder_decoder
        else ("embeds", cfg.frontend_embeds))
    extra = np.random.default_rng(3).normal(
        0, 1, (steps, 4, n_extra, cfg.d_model)).astype(
            np.float32) if n_extra else None

    def batches(dev):
        for i, b in enumerate(TokenDataset(data, 0).batches(4, steps=steps)):
            if extra is not None:
                b = dict(b, **{extra_key: extra[i]})
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def first_grads(dev):
        leaves = tree_map(
            lambda t: t.clone().to(dev).requires_grad_(True), init)
        flat = flatten_tree(leaves)
        with D.full_float32(torch.device(dev)):
            g = torch.autograd.grad(model.loss(leaves, next(batches(dev))),
                                    list(flat.values()))
        return {n: x.cpu() for n, x in zip(flat, g)}

    def train(dev, optimizer):
        tcfg = TrainConfig(batch_size=4, seq_len=96, steps=steps,
                           warmup_steps=1, learning_rate=1e-3,
                           optimizer=optimizer)
        params = tree_map(lambda t: t.clone().to(dev), init)
        step, opt = make_train_step(model, tcfg)
        losses, lrs = [], []
        with D.full_float32(torch.device(dev)):
            state = opt.init(params)
            for b in batches(dev):
                params, state, m = step(params, state, b)
                losses.append(float(m["loss"]))
                lrs.append(float(m["lr"]))
        return losses, {n: t.cpu() for n, t in
                        flatten_tree(params).items()}, lrs

    def rel(a, b):
        return max(float((a[n] - b[n]).abs().max())
                   / max(float(b[n].abs().max()), 1e-30) for n in b)

    gc, gh = first_grads("cuda"), first_grads("cpu")
    noise = torch.Generator().manual_seed(5)
    clean_init = init
    init = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=noise)), clean_init)
    g_noisy = first_grads("cpu")
    init = clean_init
    torch.cuda.synchronize()
    _zero_lm_counts()
    lc, pc, lrs = train("cuda", "adamw")
    torch.cuda.synchronize()
    counts = _lm_counts()
    lh, ph, _ = train("cpu", "adamw")
    sgd_card, sgd_cpu = train("cuda", "sgd")[1], train("cpu", "sgd")[1]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    n_params = sum(t.numel() for t in ph.values())
    free = adam_free_bound(lrs)
    def floor(f):
        return lambda g, h: (torch.sign(g) == torch.sign(h)) & (
            h.abs() >= f * h.abs().max())

    rules = {"floor_1e-4": floor(1e-4), "floor_1e-3": floor(1e-3),
             "floor_1e-2": floor(ADAMW_GRAD_FLOOR),
             "agree_1e-2": lambda g, h: (g - h).abs() <= 1e-2 * h.abs()}
    by_rule = {r: {"fixed_beyond": 0, "free": 0, "free_worst": 0.0}
               for r in rules}
    for n in ph:
        diff = (pc[n] - ph[n]).abs()
        tol = 1e-4 * float(ph[n].abs().max())
        for r, rule in rules.items():
            fixed = rule(gc[n], gh[n])
            b = by_rule[r]
            b["fixed_beyond"] += int((diff[fixed] > tol).sum())
            if bool((~fixed).any()):
                b["free"] += int((~fixed).sum())
                b["free_worst"] = max(b["free_worst"], float(
                    diff[~fixed].max()) / (free + tol))
    chosen = by_rule["floor_1e-2"]
    sign_free = arch in ADAMW_SIGN_FREE_ARCHS
    all_worst = max(float((pc[n] - ph[n]).abs().max())
                    / (free + 1e-4 * float(ph[n].abs().max())) for n in ph)
    row = {"arch": arch, "steps": steps, "losses_card": lc,
           "losses_cpu": lh, "max_loss_rel_err": loss_err,
           "max_grad_rel_err_step1": rel(gc, gh),
           "adamw_max_param_rel_err": rel(pc, ph),
           "adamw_grad_floor": ADAMW_GRAD_FLOOR,
           "adamw_fixed_sign_beyond_1e-4": chosen["fixed_beyond"],
           "adamw_free_sign_elements": chosen["free"],
           "adamw_free_bound": free,
           "adamw_free_worst_over_bound": chosen["free_worst"],
           "adamw_by_rule": by_rule,
           "adamw_all_sign_free": sign_free,
           "adamw_all_worst_over_bound": all_worst,
           "cpu_grad_sensitivity": rel(g_noisy, gh),
           "params": n_params,
           "sgd_max_param_rel_err": rel(sgd_card, sgd_cpu)}
    log("[lm-parity] " + json.dumps(row))
    adamw_bad = all_worst > 1.0 if sign_free else (
        chosen["fixed_beyond"] or chosen["free_worst"] > 1.0)
    if loss_err > 1e-4 or row["max_grad_rel_err_step1"] > 1e-4 or \
            row["sgd_max_param_rel_err"] > 1e-4 or adamw_bad:
        raise AssertionError(f"card != CPU training at {arch}: {row}")
    # each step a forward and its recompute (remat) and a backward a layer
    want = {k: n * steps for k, n in step_launches(cfg).items()}
    if counts != want:
        raise AssertionError(f"card training launches {counts} != {want}")
    return counts


def lm_fedkt(level, gamma=0.0):
    """``launch.train.fedkt_lm`` at the CLI's ``--fedkt --smoke`` config
    (phi4-mini's smoke, 2 parties, s 2, t 2, vocab 512, 10 steps of B 8
    x S 64 a fit; in float32, as
    an untrained model's near-tied logits would flip labels between
    bf16 runs), card against CPU: >= 99 % equal server labels, equal
    epsilon.  At the smoke's
    vocabulary (512 <= 2048) every party partition's vote goes through
    K1, with or without noise; at phi4-mini's full vocabulary a
    noise-free vote takes ``ops.votes_sort`` instead (no kernel)."""
    from repro_torch.configs import FedKTConfig, TrainConfig, get_smoke
    from repro_torch.data import synthetic
    from repro_torch.launch.train import fedkt_lm
    from repro_torch.models import Model
    cfg = get_smoke("phi4-mini-3.8b").replace(dtype="float32")
    model = Model(cfg)
    tcfg = TrainConfig(batch_size=8, seq_len=64, steps=10,
                       learning_rate=3e-3)
    fcfg = FedKTConfig(num_parties=2, num_partitions=2, num_subsets=2,
                       num_classes=cfg.vocab_size, privacy_level=level,
                       gamma=gamma)
    data = synthetic.tokens(n_seqs=256, seq_len=65, vocab=cfg.vocab_size)
    res, walls, counts = {}, {}, None
    for dev in ("cuda", "cpu"):
        _zero_lm_counts()
        t0 = time.perf_counter()
        res[dev] = fedkt_lm(model, data["train"], data["public"], fcfg,
                            tcfg, test=data["test"], verbose=False,
                            device=dev)["result"]
        walls[dev] = time.perf_counter() - t0
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = _lm_counts()

    def labels(r):
        (row,) = r.by_domain.values()
        return np.asarray(row["labels"])

    agree = float((labels(res["cuda"]) == labels(res["cpu"])).mean())
    votes = fcfg.num_parties * fcfg.num_partitions
    row = {"level": level, "gamma": gamma, "wall_s": walls,
           "server_label_agreement": agree,
           "epsilon": {d: r.epsilon for d, r in res.items()},
           "accuracy": {d: r.accuracy for d, r in res.items()},
           "launches": counts}
    log("[lm-fedkt] " + json.dumps(row))
    if agree < 0.99:
        raise AssertionError(f"fedkt {level}: labels agree on {agree}")
    if res["cuda"].epsilon != res["cpu"].epsilon:
        raise AssertionError(f"fedkt {level}: epsilon differs: {row}")
    if counts["vote_aggregate"] != votes or counts["rglru_scan"] or \
            counts["wkv6"] or not counts["flash_attention_backward"]:
        raise AssertionError(f"fedkt {level}: launches {counts}")
    return row, counts


def lm_label_step(cfg, smi, members=3, gamma=0.1):
    """The token vote at full width: ``members`` phi4-mini members
    (random weights, bf16) predict a (2, 1024) public batch through
    ``LMLearner.vote_members`` (K3 once a layer a member), then the
    noisy token vote through K1 at (members, 2048, vocab), held bit for
    bit against ``ref.vote_aggregate_plain`` on the same predictions and
    noise.  A noise-free vote at this vocabulary launches no K1."""
    from repro_torch import prng
    from repro_torch.configs import TrainConfig
    from repro_torch.core import voting
    from repro_torch.core.learners import LMLearner
    from repro_torch.data import synthetic
    from repro_torch.federation.domain import token_domain
    from repro_torch.kernels import ref
    from repro_torch.kernels import vote_aggregate as va
    from repro_torch.models import Model
    model = Model(cfg)
    bank = [model.init(torch.Generator(device="cuda").manual_seed(s))
            for s in range(1, members + 1)]
    X = synthetic.tokens(n_seqs=16, seq_len=1025, vocab=cfg.vocab_size,
                         seed=3)["public"][:2]
    learner = LMLearner(model, TrainConfig(), device="cuda")
    key = prng.PRNGKey(5)
    learner.vote_members(bank, X, gamma=gamma, key=key)     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    t0 = time.perf_counter()
    labels, gap = learner.vote_members(bank, X, gamma=gamma, key=key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _lm_counts()
    want = {"flash_attention": members * cfg.num_layers,
            "flash_attention_backward": 0, "flash_attention_f32": 0,
            "flash_attention_backward_f32": 0, "vote_aggregate": 1,
            "rglru_scan": 0, "rglru_scan_backward": 0, "wkv6": 0,
            "wkv6_backward": 0}
    if got != want:
        raise AssertionError(f"label step launches {got} != {want}")
    preds = learner.predict_stacked(bank, X)
    T, U = preds.shape[1], cfg.vocab_size
    noise = voting.laplace(key, (T, U), 1.0 / gamma, "cuda")
    k_out = va.vote_aggregate(preds, noise, num_classes=U)
    p_out = ref.vote_aggregate_plain(preds, U, noise)
    torch.cuda.synchronize()
    same = all(same_bits(a, b) for a, b in zip(k_out, p_out))
    if not same or not torch.equal(k_out[0], labels) or \
            not torch.equal(k_out[3] - k_out[4], gap):
        raise AssertionError("K1 at the label step's shape != plain")
    va.launches = 0
    voting.token_teacher_vote(preds.reshape(members, 2, -1),
                              token_domain(T, U))
    sort_path = va.launches == 0
    row = {"arch": cfg.name, "members": members, "queries": list(X.shape),
           "T": T, "U": U, "gamma": gamma, "label_step_wall_s": wall,
           "peak_mem_bytes": peak,
           "launches": got, "k1_bit_identical_to_plain": same,
           "noise_free_vote_launches_no_k1": sort_path, "card": smi}
    log("[lm-label] " + json.dumps(row))
    if not sort_path:
        raise AssertionError("a noise-free vocabulary vote launched K1")
    return got, row


def lm_checkpoint_serve(cfg, params, smi, prompt_len=256):
    """Saves the trained masters in the reference's checkpoint format,
    serves 4 requests of 32 tokens through ``launch.serve --checkpoint``
    at full width, and holds the streams to the same parameters served
    from memory."""
    import shutil
    from repro_torch import checkpoint, convert
    from repro_torch.launch import serve
    from repro_torch.models import Model, transformer
    from repro_torch.serving import Engine
    path = os.path.join(ROOT, "build", "lm_checkpoint", "phi4")
    t0 = time.perf_counter()
    checkpoint.save(path, convert.lm_params_to_reference(cfg, params),
                    step=8)
    save_s = time.perf_counter() - t0
    args = ["--arch", cfg.name, "--checkpoint", path, "--concurrent", "4",
            "--max-tokens", "32", "--prompt-len", str(prompt_len),
            "--slots", "4", "--cache-len", "512"]
    _zero_lm_counts()
    t0 = time.perf_counter()
    served = serve.main(args)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _lm_counts()
    shutil.rmtree(os.path.dirname(path))
    module = transformer.to_module(cfg, params)
    eng = Engine(Model(cfg), module, num_slots=4, cache_len=512,
                 device="cuda")
    rng = np.random.default_rng(0)          # the serve CLI's prompts
    for n in rng.integers(1, prompt_len + 1, 4):
        eng.submit(rng.integers(0, cfg.vocab_size, (int(n),))
                   .astype(np.int32), 32)
    mem = eng.run()
    same = [r.tokens for r in mem] == [r.tokens for r in served]
    row = {"arch": cfg.name, "streams": len(served),
           "tokens": [len(r.tokens) for r in served],
           "save_s": save_s, "serve_cli_s": serve_s,
           "streams_equal_in_memory": same, "card": smi}
    log("[lm-serve] " + json.dumps(row))
    if not same or any(len(r.tokens) != 32 for r in served):
        raise AssertionError("checkpoint-served streams != in-memory ones")
    return counts


# the LM path's kernels, as the profiler names them (their rank is logged)
LM_KERNEL_NAMES = ("flash_attention_wgmma", "flash_attention_tf32",
                   "bwd_dot", "bwd_dkdv", "bwd_dq",
                   "rglru_scan_tma", "rglru_scan_direct", "rglru_scan_bwd",
                   "wkv6_kernel", "wkv6_bwd")


def lm_profile_steps(cfg, params, steps=2, B=4, S=512):
    """``--profile``: where a full-width train step's time goes (one
    warm step, then ``steps`` profiled, B x S tokens each), from the
    trained masters; the LM kernels' ranks among the step's device
    costs."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.distill import make_train_step
    from repro_torch.data import TokenDataset
    from repro_torch.models import Model
    tcfg = TrainConfig(batch_size=B, seq_len=S, steps=8, warmup_steps=2,
                       learning_rate=3e-4)
    step, opt = make_train_step(Model(cfg), tcfg)
    state = opt.init(params)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in TokenDataset(lm_train_data(cfg, S)).batches(
                   B, steps=steps + 1)]
    step(params, state, batches[0])

    def run():
        for b in batches[1:]:
            step(params, state, b)

    _profiled(f"lm_train_{cfg.name}_L{cfg.num_layers}_{B}x{S}_x{steps}",
              run, watch=LM_KERNEL_NAMES)


RWKV_TRAIN_LAYERS = 12   # rwkv6-7b's cut: 32 layers' masters, gradients
                         # and AdamW moments alone are 120.6 GB, 12's 50.6


# deepseek-moe-16b's cut: the dense head block and 5 MoE blocks.  Its
# 28 layers' float32 masters, gradients and AdamW moments are 16.38 B x
# 16 B = 262 GB; 6 layers' 3.445 B x 16 B = 55.1 GB, and the dry-run
# puts the step's peak at 59.5 GB (7 layers': 69.0 GB, too close to 80
# beside the allocator's slack)
DEEPSEEK_TRAIN_LAYERS = 6


def deepseek_train_config():
    """deepseek-moe-16b at ``DEEPSEEK_TRAIN_LAYERS`` of its 28 layers, at
    its own capacity factor 1.25 (picks drop as in its training)."""
    from repro_torch.configs import get_config
    return get_config("deepseek-moe-16b").replace(
        num_layers=DEEPSEEK_TRAIN_LAYERS)


# gemma2-27b's cut: 2 local and 2 global layers, trained at its own
# 8192-token context.  The dry-run (remat, AdamW, float32 masters, one
# device) prices 4 layers (2.765 B parameters, 44.24 GB of state) at a
# 67.84 GB peak, 6 layers (3.558 B, 56.93 GB) at 80.52 and 8 (4.351 B,
# 69.61 GB) at 93.20, at (1, 8192) and (2, 8192) alike: AdamW's
# float32 temporaries of the 1.18 B-element tied embedding set the
# peak, not the activations
GEMMA2_TRAIN_LAYERS = 4
GEMMA2_TRAIN_B, GEMMA2_TRAIN_S = 2, 8192


def gemma2_train_config():
    """gemma2-27b at ``GEMMA2_TRAIN_LAYERS`` of its 46 layers, its own
    pattern (local window 4096, global) repeated, soft-caps 50 and 30,
    tied embeddings, post-norms and full widths."""
    from repro_torch.configs import get_config
    return get_config("gemma2-27b").replace(num_layers=GEMMA2_TRAIN_LAYERS)


# granite-20b's cut: 8 of its 52 layers (MQA 48:1, dh 128) at full
# width.  52 layers' float32 masters, gradients and AdamW moments are
# 20.3 B x 16 B = 325 GB; the dry-run prices 8 layers at 64.23 GB and 10
# at 76.36, at B 4 x S 512
GRANITE_TRAIN_LAYERS = 8


def granite_train_config():
    """granite-20b at ``GRANITE_TRAIN_LAYERS`` of its 52 layers: N1's
    dK/dV pass at 48:1 on a train path, its q heads split over
    ``bwd_head_splits`` CTAs."""
    from repro_torch.configs import get_config
    return get_config("granite-20b").replace(
        num_layers=GRANITE_TRAIN_LAYERS)


# mixtral-8x7b's train cut: 2 of its 32 layers (each 8 experts of 176 M
# parameters).  32 layers' state is 46.7 B x 16 B = 747 GB; the dry-run
# prices 2 layers at 61.91 GB and 3 at 85.13, at B 4 x S 512.  Not
# MIXTRAL_LAYERS, the serving cut (bf16 weights alone)
MIXTRAL_TRAIN_LAYERS = 2


def mixtral_train_config():
    """mixtral-8x7b at ``MIXTRAL_TRAIN_LAYERS`` of its 32 layers, at its
    own capacity factor 1.25 (top-2 of 8 experts, no shared expert;
    picks drop as in its training); window 4096, which S 512 never
    reaches."""
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").replace(
        num_layers=MIXTRAL_TRAIN_LAYERS)


# llava-next-mistral-7b's cut: 16 of its 32 layers at B 1 x S 4096, the
# 2880 stub patch embeddings and 1216 tokens a row (the loss over the
# tokens alone).  32 layers' state is 7.24 B x 16 B = 116 GB; the
# dry-run prices 16 layers at 62.68 GB and 18 at 69.66
LLAVA_TRAIN_LAYERS = 16
LLAVA_TRAIN_B, LLAVA_TRAIN_S = 1, 4096


def llava_train_config():
    """llava-next-mistral-7b at ``LLAVA_TRAIN_LAYERS`` of its 32 layers,
    full width (32:8 heads of 128)."""
    from repro_torch.configs import get_config
    return get_config("llava-next-mistral-7b").replace(
        num_layers=LLAVA_TRAIN_LAYERS)


# The peak learning rate of the granite and llava cuts.  At lm_train's
# 3e-4 their first batch's loss rose over the 8 steps while the step
# losses fell (granite 12.077 -> 12.475, llava 11.185 -> 11.505 on an
# NVIDIA H100 80GB HBM3 at 700 W): AdamW's sign-like early updates at
# 2048 (granite) and 1216 (llava) loss tokens a step overshoot.  At
# 1e-4 it falls (to 10.864 and 10.789), as it does at 3e-5
WIDE_CUT_LR = 1e-4


def stub_embeds(cfg, B, seed=0):
    """llava's frontend stub on the card: (B, cfg.frontend_embeds,
    d_model) pre-projected patch embeddings, seeded normals at the
    embedding's scale 0.02 (as phase_llava's), in the compute dtype."""
    from repro_torch.models.layers import dtype_of
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"embeds": (torch.randn((B, cfg.frontend_embeds, cfg.d_model),
                                   generator=g, device="cuda") * 0.02).to(
                                       dtype_of(cfg.dtype))}


def train_step_repeat(model, params, batch, remat=True):
    """One train step's loss and gradients (``distill``'s: the float32
    masters cast inside autograd, the blocks recomputed in the backward
    under ``remat``) taken twice from the tree ``params`` on ``batch``.
    Returns {"identical", "loss", "loss_again", "leaves", "differing",
    "max_diff", "finite"}: the losses and every gradient leaf compared
    bit for bit."""
    from repro_torch.core.distill import _leaf_grads, _requiring_grad
    from repro_torch.tree_util import flatten_tree
    runs = []
    for _ in range(2):
        leaves = _requiring_grad(params)
        loss = model.loss(leaves, batch, remat=remat)
        runs.append((loss.detach(), flatten_tree(_leaf_grads(loss, leaves))))
        del leaves, loss
    (l1, g1), (l2, g2) = runs
    differing = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    return {"identical": torch.equal(l1, l2) and not differing,
            "loss": float(l1), "loss_again": float(l2), "leaves": len(g1),
            "differing": differing,
            "max_diff": max((float((g1[n] - g2[n]).abs().max())
                             for n in differing), default=0.0),
            "finite": bool(torch.isfinite(l1)) and all(
                bool(torch.isfinite(g).all()) for g in g1.values())}


def cut_train(smi, cfg, tag, B=4, S=512, extra=None, lr=3e-4):
    """``cfg`` (a depth cut, or a whole arch in float32) trained at full
    width through ``lm_full_train`` (8 steps of B x S, AdamW, remat,
    ``cfg.dtype`` compute on float32 masters, peak learning rate
    ``lr``; ``extra`` in every batch), then one step's loss and
    gradients taken twice from the trained masters on the first batch
    (``train_step_repeat``): equal bit for bit.  ``lm_full_train``
    holds the launches a step to ``train_launches``, the repeat to twice
    that.  Prints one ``[tag]`` summary line, with the dry-run's
    predicted peak (``train_price``) beside the measured one and the
    time the whole took.  Returns (the train row, the launches of both
    runs, each counted from 0)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    t0 = time.time()
    params, counts, row = lm_full_train(cfg, smi, B=B, S=S, extra=extra,
                                        lr=lr)
    batch = first_lm_batch(lm_train_data(cfg, text_len(cfg, S)), B, extra)
    torch.cuda.synchronize()
    _zero_lm_counts()
    rep = train_step_repeat(Model(cfg), params, batch)
    torch.cuda.synchronize()
    rep_counts = _lm_counts()
    del params, batch
    torch.cuda.empty_cache()
    want = {k: 2 * n for k, n in step_launches(cfg).items()}
    per_step = row["launches_per_step"]
    summary = {
        "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "of_layers": get_config(cfg.name).num_layers,
        "params": row["params"], "B": B, "S": S, "steps": row["steps"],
        "tokens_per_step": B * S,
        "k3_per_step": per_step["flash_attention"],
        "n1_per_step": per_step["flash_attention_backward"],
        "losses_finite": bool(np.isfinite(row["losses"]).all()),
        "first_loss": row["losses"][0],
        "first_batch_loss_after": row["first_batch_loss_after"],
        "step_ms_median_last6": row["step_ms_median_last6"],
        "tokens_per_s": row["tokens_per_s"],
        "peak_mem_bytes": row["peak_mem_bytes"],
        "dryrun_peak_bytes": train_price(cfg, B, S)["peak_memory_bytes"],
        "repeat_identical": rep["identical"], "repeat_loss": rep["loss"],
        "repeat_grad_leaves": rep["leaves"],
        "repeat_differing_leaves": rep["differing"],
        "repeat_max_diff": rep["max_diff"], "repeat_launches": rep_counts,
        "layer_kinds": list(cfg.layer_kinds), "window": cfg.window,
        "attn_softcap": cfg.attn_softcap, "final_softcap": cfg.final_softcap,
        "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
        "lr": lr, "text_tokens": text_len(cfg, S),
        "frontend_embeds": cfg.frontend_embeds if extra else 0,
        "head_splits": fa.bwd_head_splits(
            B, S, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim_,
            torch.cuda.get_device_properties(0).multi_processor_count),
        "seconds": time.time() - t0,
        "card": smi}
    log(f"[{tag}] " + json.dumps(summary))
    if rep_counts != want:
        raise AssertionError(f"repeated step launches {rep_counts} != "
                             f"{want}")
    if not rep["finite"]:
        raise AssertionError("non-finite loss or gradient in the repeat")
    if not rep["identical"]:
        raise AssertionError(f"the {cfg.name} train step differs run to "
                             f"run: {rep['differing']} (max |diff| "
                             f"{rep['max_diff']}), losses {rep['loss']} "
                             f"and {rep['loss_again']}")
    return row, [counts, rep_counts]


def deepseek_train(smi):
    """deepseek-moe-16b cut to ``DEEPSEEK_TRAIN_LAYERS`` through
    ``cut_train`` (B 4 x S 512, capacity factor 1.25: its dispatch and
    combine gathers, their backwards, the stacked experts' bmm backward
    and the aux loss's gradient into the router on the card; 12 K3 and
    18 N1 launches a step at 6 layers).  Returns ``cut_train``'s."""
    return cut_train(smi, deepseek_train_config(), "deepseek_train")


def gemma2_train(smi):
    """gemma2-27b cut to ``GEMMA2_TRAIN_LAYERS`` through ``cut_train`` at
    B 2 x S 8192, gemma2's own context: on the local layers the 4096-key
    window binds in K3 (forward and recompute, with the row LSE) and in
    N1, both under soft-cap 50; the head runs 16 chunks soft-capped at
    30, and the tied embedding's gradient sums the lookup's backward and
    the chunks' products.  8 K3 and 12 N1 launches a step at 4 layers;
    the first loss within [12.45, 14.24] (ln 256,000 rounded, + 1.79).
    Returns ``cut_train``'s."""
    return cut_train(smi, gemma2_train_config(), "gemma2_train",
                     B=GEMMA2_TRAIN_B, S=GEMMA2_TRAIN_S)


def granite_train(smi):
    """granite-20b cut to ``GRANITE_TRAIN_LAYERS`` through ``cut_train``
    at B 4 x S 512 and peak learning rate ``WIDE_CUT_LR``: N1 at MQA
    48:1 (dh 128), its dK/dV walk split over ``bwd_head_splits`` CTAs
    (5 on 132 SMs); 16 K3 and 24 N1 launches a step at 8 layers; the
    first loss within [10.80, 12.59] (ln 49,152 rounded, + 1.79).
    Returns ``cut_train``'s."""
    return cut_train(smi, granite_train_config(), "granite_train",
                     lr=WIDE_CUT_LR)


def mixtral_train(smi):
    """mixtral-8x7b cut to ``MIXTRAL_TRAIN_LAYERS`` through ``cut_train``
    at B 4 x S 512 and capacity factor 1.25: top-2 of 8 experts with no
    shared expert, its dispatch, combine and the experts' backward on
    the card; 4 K3 and 6 N1 launches a step at 2 layers.  Returns
    ``cut_train``'s."""
    return cut_train(smi, mixtral_train_config(), "mixtral_train")


def llava_train(smi):
    """llava-next-mistral-7b cut to ``LLAVA_TRAIN_LAYERS`` through
    ``cut_train`` at B 1 x S 4096: each row the 2880 seeded stub patch
    embeddings (``stub_embeds``, bf16, on the card) and 1216 tokens,
    the loss over the tokens alone; K3 and N1 at (1, 4096, 32:8, dh
    128), 32 K3 and 48 N1 launches a step at 16 layers; peak learning
    rate ``WIDE_CUT_LR``.  Returns ``cut_train``'s."""
    cfg = llava_train_config()
    return cut_train(smi, cfg, "llava_train", B=LLAVA_TRAIN_B,
                     S=LLAVA_TRAIN_S, extra=stub_embeds(cfg, LLAVA_TRAIN_B),
                     lr=WIDE_CUT_LR)


def recurrentgemma_f32_config():
    """recurrentgemma-2b whole (26 layers, full width) computing in
    float32, as every LM FedKT round and card-vs-CPU smoke does: its 8
    local-attention layers run K3 and N1 in float32 at dh 256 (10:1,
    window 2048), its 18 RG-LRU layers K4 and N2a in float32.  The
    dry-run prices the B 4 x S 512 step at 51.27 GB."""
    from repro_torch.configs import get_config
    return get_config("recurrentgemma-2b").replace(dtype="float32")


def recurrentgemma_f32_train(smi):
    """``recurrentgemma_f32_config`` through ``cut_train`` at B 4 x S 512:
    8 steps, then one step repeated bit for bit; 16 K3 and 24 N1
    launches a step, all of them the float32 kernels'.  Returns
    ``cut_train``'s."""
    return cut_train(smi, recurrentgemma_f32_config(),
                     "recurrentgemma_f32_train")


def recurrent_train_configs():
    """The recurrent archs lm_train trains at full width:
    recurrentgemma-2b whole (26 layers) and rwkv6-7b cut to
    ``RWKV_TRAIN_LAYERS`` of its 32."""
    from repro_torch.configs import get_config
    return (get_config("recurrentgemma-2b"),
            get_config("rwkv6-7b").replace(num_layers=RWKV_TRAIN_LAYERS))


# phi4-mini-3.8b's FedKT cut: the CLI's ``--fedkt`` round at full width
# and 8 of its 32 layers, 1.420 B parameters a member (5.68 GB in
# float32).  A party holds 3 finished teachers on the card while its
# last teacher fits (``fedkt_party_price``): at 32 layers (15.4 GB a
# member) that and the fit do not fit one card.  The round over party
# threads (``lm_fedkt_threads``) runs at the deepest cut at which two
# parties fit at once (``fedkt_threads_layers``)
FEDKT_CUT_LAYERS = 8
FEDKT_CUT_B, FEDKT_CUT_S = 8, 128      # the CLI's batch and sequence
FEDKT_CUT_STEPS = 8                    # a fit's steps (the CLI's 100)
FEDKT_CUT_LR = 3e-4                    # peak learning rate (the CLI's 1e-3)
FEDKT_CUT_PEAK_LIMIT = 72e9            # every depth cut's peak stays under it
# what the thread round's depth leaves free under FEDKT_CUT_PEAK_LIMIT
# beside its price and what is alive on the card before it: on the H100
# a round's peak has run 0.10-0.14 GB over the two
FEDKT_THREADS_MARGIN = 2e9


def fedkt_cut_config(layers=FEDKT_CUT_LAYERS):
    """phi4-mini-3.8b at ``layers`` of its 32 layers, full width (d 3072,
    24:8 heads of 128, vocabulary 200,064), bf16 compute."""
    from repro_torch.configs import get_config
    return get_config("phi4-mini-3.8b").replace(num_layers=layers)


def fedkt_party_price(cfg, fcfg, tcfg=None):
    """What a party of the ``fedkt_round_inputs`` round over ``cfg``
    holds on the card at its peak, priced on meta tensors: a fit
    (``train_price`` at ``tcfg``'s B x S, by default the cut's) beside
    the most members it holds during a fit: its other s t - 1 teachers
    while the last one fits, or its other s - 1 students while the last
    one fits (``Party.local_round`` releases the teachers once they have
    voted).  Returns {"price", "fit", "held", "member_bytes",
    "params"}."""
    from repro_torch.models import Model
    from repro_torch.tree_util import tree_leaves
    n_params = sum(leaf.numel()
                   for leaf in tree_leaves(Model(cfg).init_shapes()))
    s, t = fcfg.num_partitions, fcfg.num_subsets
    held = max(s * t, s) - 1
    B, S = ((tcfg.batch_size, tcfg.seq_len) if tcfg is not None
            else (FEDKT_CUT_B, FEDKT_CUT_S))
    fit = train_price(cfg, B, S)["peak_memory_bytes"]
    return {"price": fit + held * 4 * n_params, "fit": fit, "held": held,
            "member_bytes": 4 * n_params, "params": n_params}


def fedkt_threads_layers():
    """The deepest cut of phi4-mini-3.8b at which every party of the L0
    round, each at its peak at once, prices within the room
    ``FEDKT_CUT_PEAK_LIMIT`` leaves less ``FEDKT_THREADS_MARGIN`` and
    what is alive on the card now.  Returns (layers, that room)."""
    from repro_torch.configs import get_config
    fcfg = fedkt_round_inputs(fedkt_cut_config(1), "L0", 0.0)[0]
    room = FEDKT_CUT_PEAK_LIMIT - FEDKT_THREADS_MARGIN - _alive()
    layers = 0
    for depth in range(1, get_config("phi4-mini-3.8b").num_layers + 1):
        cut = fedkt_cut_config(depth)
        if fcfg.num_parties * fedkt_party_price(cut, fcfg)["price"] > room:
            break
        layers = depth
    if layers == 0:
        raise AssertionError(f"{fcfg.num_parties} parties of one layer "
                             f"price over {room} B")
    return layers, room


class HostPeak:
    """The largest resident set of this process while the block runs,
    sampled from /proc/self/statm every ``every_s`` seconds
    (``peak_bytes``)."""

    def __init__(self, every_s=0.05):
        self.every_s, self.peak_bytes = every_s, 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * self._page
        self.peak_bytes = max(self.peak_bytes, rss)

    def _run(self):
        while not self._stop.wait(self.every_s):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()
        return False


def fedkt_round_inputs(cfg, level, gamma, B=FEDKT_CUT_B, S=FEDKT_CUT_S,
                       steps=FEDKT_CUT_STEPS, lr=FEDKT_CUT_LR, n_seqs=256):
    """(FedKTConfig, TrainConfig, token splits) of the CLI's ``--fedkt``
    round (``launch/train.main``) over ``cfg``: 2 parties, s 2, t 2,
    ``num_classes`` the vocabulary, at ``level`` with ``gamma``;
    ``steps`` steps of B x S a fit at peak learning rate ``lr``;
    ``synthetic.tokens(n_seqs, S + 1, vocabulary)``."""
    from repro_torch.configs import FedKTConfig, TrainConfig
    from repro_torch.data import synthetic
    fcfg = FedKTConfig(num_parties=2, num_partitions=2, num_subsets=2,
                       num_classes=cfg.vocab_size, privacy_level=level,
                       gamma=gamma)
    tcfg = TrainConfig(batch_size=B, seq_len=S, steps=steps,
                       learning_rate=lr)
    data = synthetic.tokens(n_seqs=n_seqs, seq_len=S + 1,
                            vocab=cfg.vocab_size)
    return fcfg, tcfg, data


class _PredictTap:
    """``model`` with every ``predict`` result also appended to
    ``out``."""

    def __init__(self, model, out):
        self._model, self._out = model, out

    def __getattr__(self, name):
        return getattr(self._model, name)

    def predict(self, params, batch):
        preds = self._model.predict(params, batch)
        self._out.append(preds)
        return preds


class RecordingLMEngine(LMEngine):
    """``LMEngine`` that keeps, on the CPU, what a round's checks need:
    each partition vote's member predictions (M, T), labels, clean gaps,
    key and gamma (``votes``, in call order: party by party, partition by
    partition), and each party's student predictions (s, T) at the
    server (``student_preds``, in fold order).  The vote still runs
    ``LMLearner.vote_members``' label step, on a copy of the learner
    whose model's ``predict`` is tapped, so the round computes what an
    ``LMEngine`` round computes.  ``seconds`` sums the host time of its
    calls by kind (teacher fits, votes, student fits, the students'
    predictions at the server), each ended by a synchronise."""

    def __init__(self):
        self.votes, self.student_preds = [], []
        self.seconds = {"teacher_fits": 0.0, "votes": 0.0,
                        "student_fits": 0.0, "server_predicts": 0.0}

    @contextlib.contextmanager
    def _timed(self, kind):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds[kind] += time.perf_counter() - t0

    def fit_teachers(self, keys, learner, datasets):
        with self._timed("teacher_fits"):
            return super().fit_teachers(keys, learner, datasets)

    def label_queries(self, learner, bank, X, num_classes, *, gamma=0.0,
                      key=None):
        taps = []
        tapped = dataclasses.replace(
            learner, model=_PredictTap(learner.model, taps))
        with self._timed("votes"):
            labels, gap = super().label_queries(tapped, bank, X, num_classes,
                                                gamma=gamma, key=key)
        self.votes.append({
            "preds": torch.stack(taps).reshape(len(bank), -1).cpu(),
            "labels": labels.cpu(), "gaps": gap.cpu(), "key": key,
            "gamma": gamma})
        return labels, gap

    def fit_students(self, keys, learner, X, labelsets):
        with self._timed("student_fits"):
            return super().fit_students(keys, learner, X, labelsets)

    def predict_students(self, learner, states, X):
        with self._timed("server_predicts"):
            preds = super().predict_students(learner, states, X)
        self.student_preds.append(preds.cpu())
        return preds


class ThreadSpanLMEngine(LMEngine):
    """``LMEngine`` that notes, by host thread, when the thread's teacher
    fits began and its student fits returned (``spans``: thread name ->
    [start, end] on the ``time.perf_counter`` clock, no synchronise)."""

    def __init__(self):
        self.spans = {}

    def fit_teachers(self, keys, learner, datasets):
        self.spans[threading.current_thread().name] = [time.perf_counter(),
                                                       None]
        return super().fit_teachers(keys, learner, datasets)

    def fit_students(self, keys, learner, X, labelsets):
        students = super().fit_students(keys, learner, X, labelsets)
        self.spans[threading.current_thread().name][1] = time.perf_counter()
        return students


def fedkt_round_launches(cfg, fcfg, tcfg):
    """The kernel launches of one ``fedkt_lm`` round over ``cfg`` (engine
    "lm", a vocabulary over 2048), by counter, from the protocol: n (s t
    + s) + 1 fits of ``tcfg.steps`` train steps (``step_launches``); a
    no-grad forward (half a step's forward kernels: no recompute) for
    each teacher of each partition vote, each student at the server and
    the final model's accuracy; K1 once a (party, partition) under L2
    with noise, none else (a noise-free vote over the vocabulary is
    ``ops.votes_sort``)."""
    n, s, t = fcfg.num_parties, fcfg.num_partitions, fcfg.num_subsets
    step = step_launches(cfg)
    fits = n * (s * t + s) + 1
    forwards = n * s * t + n * s + 1
    want = {k: fits * tcfg.steps * v for k, v in step.items()}
    for k in ("flash_attention", "flash_attention_f32", "rglru_scan",
              "wkv6"):
        want[k] += forwards * step[k] // 2
    noisy = fcfg.privacy_level == "L2" and fcfg.gamma > 0
    want["vote_aggregate"] = n * s if noisy else 0
    return want


def fedkt_round_checks(rec, res, model, fcfg, tcfg, data, device):
    """A recorded ``fedkt_lm`` round (``RecordingLMEngine`` ``rec``,
    result ``res``) held to what its recorded inputs give, at a
    vocabulary over 2048 and level L0 or L2 (where the server adds no
    noise):

    - each party vote under L2: on ``device``, K1 on a CUDA device and
      ``ref.vote_aggregate_plain`` on the recorded predictions and the
      noise drawn again from the vote's key (``voting.laplace``), all
      five outputs bit for bit, the session's labels and clean gaps
      equal to them; under L0 the session's labels and gaps equal
      ``ops.votes_sort`` of the predictions on the CPU;
    - the server vote on the CPU: ``party_vote_counts`` of the recorded
      student predictions summed over the parties equal to the session's
      counts, ``finalize_vote`` of them to its labels and gaps;
    - epsilon: ``fedkt_l2_epsilon`` of each party's recorded gaps (L2),
      else None;
    - the update wire bytes: the payload n s times
      ``codec.lm_protocol_bytes``' member payload (the member's state
      and a party's query tokens' gaps), the labels n times its label
      payload, and the framed bytes the codec's price of each party's
      frame from shapes (the member's ``init_shapes``).

    Returns a row of the checked values; raises at the first
    mismatch."""
    from repro_torch.core import privacy, voting
    from repro_torch.core.learners import LMLearner
    from repro_torch.core.partition import dirichlet_partition
    from repro_torch.data.pipeline import lm_session_data
    from repro_torch.federation import codec
    from repro_torch.federation.bindings import learner_kind
    from repro_torch.federation.domain import (fingerprint_queries,
                                               token_domain)
    from repro_torch.federation.messages import PartyUpdate, ShapeDtype
    from repro_torch.federation.party import query_budget
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vote_aggregate as va
    n, s, t = fcfg.num_parties, fcfg.num_partitions, fcfg.num_subsets
    U = model.cfg.vocab_size
    if U <= 2048 or fcfg.privacy_level not in ("L0", "L2"):
        raise ValueError(f"fedkt_round_checks: vocabulary {U} at "
                         f"{fcfg.privacy_level}")
    if len(rec.votes) != n * s or len(rec.student_preds) != n:
        raise AssertionError(f"recorded {len(rec.votes)} votes and "
                             f"{len(rec.student_preds)} parties' students")
    k1_identical = 0
    for i, v in enumerate(rec.votes):
        if v["gamma"] > 0:
            preds = v["preds"].to(device)
            noise = voting.laplace(v["key"], (preds.shape[1], U),
                                   1.0 / v["gamma"], device)
            want = ref.vote_aggregate_plain(preds, U, noise)
            if preds.is_cuda:
                got = va.vote_aggregate(preds, noise, num_classes=U)
                if not all(same_bits(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"K1 != plain at vote {i}")
                k1_identical += 1
                del got
            labels, gaps = want[0].cpu(), (want[3] - want[4]).cpu()
            del preds, noise, want
        else:
            labels, top1, top2 = ops.votes_sort(v["preds"])
            gaps = top1 - top2
        if not torch.equal(labels, v["labels"]) or \
                not same_bits(gaps, v["gaps"]):
            raise AssertionError(f"party vote {i} differs from its "
                                 f"recomputation")
    (row,) = res.by_domain.values()
    vote, dom = row["vote"], row["domain"]
    counts = sum(voting.party_vote_counts(
        p, dom, consistent=fcfg.consistent_voting) for p in rec.student_preds)
    if not torch.equal(counts, vote.counts.cpu()):
        raise AssertionError("server counts differ from the CPU's sum")
    again = voting.finalize_vote(counts, dom)
    if not torch.equal(again.labels, vote.labels.cpu()) or \
            not same_bits(again.top_gap, vote.top_gap.cpu()):
        raise AssertionError("server labels differ from the CPU's vote")
    del counts, again
    eps = None
    if fcfg.privacy_level == "L2":
        eps = privacy.fedkt_l2_epsilon(
            [np.concatenate([v["gaps"].numpy()
                             for v in rec.votes[p * s:(p + 1) * s]])
             for p in range(n)], fcfg.gamma, U)
    if eps != res.epsilon:
        raise AssertionError(f"epsilon {res.epsilon} != {eps}")
    # the wire: each party's frame priced from shapes
    public = np.asarray(data["public"], np.int32)
    tq_party, tq_server = query_budget(fcfg, len(public))
    S = public.shape[1] - 1
    member = model.init_shapes()
    per_member = codec.lm_protocol_bytes(member, s * t, tq_party, S)
    dom_wire = token_domain(tq_server * S, U, fingerprint=fingerprint_queries(
        public[:tq_server]))
    kind = learner_kind(LMLearner(model, tcfg, device=device))
    sizes = [len(ix) for ix in dirichlet_partition(lm_session_data(
        data["train"], public, data["test"])["y_train"], n, fcfg.beta,
        fcfg.seed)]
    framed = sum(codec.update_encoded_nbytes(PartyUpdate(
        party_id=pid, student_states=[member] * s,
        vote_gaps=ShapeDtype((s * tq_party * S,), np.float32),
        num_examples=size, learner_kind=kind, domain=dom_wire,
        meta={"num_teachers": s * t, "num_query_labels": tq_party * S,
              "label_payload_bytes": tq_party * S * 4}))
        for pid, size in enumerate(sizes))
    wire = res.meta["wire_bytes"]
    priced = {"updates": framed,
              "updates_payload": n * s * per_member[
                  "update_payload_bytes_per_member"],
              "labels": n * per_member["label_payload_bytes"]}
    got = {k: wire[k] for k in priced}
    if got != priced:
        raise AssertionError(f"wire bytes {got} != priced {priced}")
    return {"party_votes": len(rec.votes), "k1_identical": k1_identical,
            "server_tokens": int(vote.labels.numel()), "epsilon": eps,
            "wire_bytes": got, "protocol_per_member": per_member}


def k1_round_row(rec, U):
    """K1 at the round's shape (the first recorded noisy vote's
    predictions and its noise): CUDA-event time of 20 wrapper calls, the
    device time of 20 in a CUDA graph, the plain version's, and the
    bound (``phase_votes``' formula: the noise read once dominates)."""
    from repro_torch.core import voting
    from repro_torch.kernels import ref
    from repro_torch.kernels import vote_aggregate as va
    v = next(v for v in rec.votes if v["gamma"] > 0)
    preds = v["preds"].cuda()
    M, T = preds.shape
    noise = voting.laplace(v["key"], (T, U), 1.0 / v["gamma"], "cuda")
    ms = cuda_ms(lambda: va.vote_aggregate(preds, noise, num_classes=U))
    dev = graph_ms(lambda: va.vote_aggregate(preds, noise, num_classes=U))
    plain = cuda_ms(lambda: ref.vote_aggregate_plain(preds, U, noise),
                    reps=2, warmup=1)
    nbytes = 4 * (M * T + T * U + 5 * T)
    b_ms, b_by = bound(nbytes, M * T + T * U)
    del preds, noise
    torch.cuda.empty_cache()
    return {"shape": f"fedkt_cut ({M}, {T}, {U}) noise", "M": M, "T": T,
            "U": U, "kernel_ms": ms, "graph_ms": dev, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": 0.0}


def _peak_reset(device):
    """Empties the allocator's cache and restarts its peak (on a card)."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _alive():
    """The bytes live on the card once unreachable objects are collected
    (0 before anything touched it)."""
    gc.collect()
    return (torch.cuda.memory_allocated() if torch.cuda.is_initialized()
            else 0)


def _peak(device):
    """The device peak since ``_peak_reset``, once the queued work has
    ended (0 on the CPU)."""
    _sync(device)
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def lm_fedkt_cut(smi, level, gamma, cfg=None, keep=False, device="cuda",
                 **inputs):
    """``launch.train.fedkt_lm`` at full width: the CLI's ``--fedkt``
    round (``fedkt_round_inputs``, ``inputs`` passed on) over ``cfg``,
    by default phi4-mini-3.8b cut to ``FEDKT_CUT_LAYERS`` of 32 layers
    (``fedkt_cut_config``), bf16 compute on float32 masters,
    ``FEDKT_CUT_STEPS`` steps a fit at peak learning rate
    ``FEDKT_CUT_LR``, engine "lm" (``RecordingLMEngine``), in-process
    transport, at ``level`` with ``gamma``.  Holds the round's launches
    to ``fedkt_round_launches`` exactly, the round to
    ``fedkt_round_checks`` (every K1 launch of an L2 round bit for bit
    the plain version on the card, every vote recomputed, epsilon, wire
    bytes), its device peak to ``FEDKT_CUT_PEAK_LIMIT``, printed beside
    its price (``fedkt_party_price``) and the host peak, the accuracy to
    [0, 1] and the final model's ``eval_lm`` loss to a finite value.
    Prints one ``[lm-fedkt-cut]`` line.  Returns (the round's and the
    evaluation's launches, K1's row at the round's shape or None under
    L0, and with ``keep`` the round's result, its final model and its
    server vote on the host, else None).  ``device="cpu"`` rehearses it
    on the CPU (no peak, no K1 row)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import TokenDataset
    from repro_torch.launch.train import eval_lm, fedkt_lm
    from repro_torch.models import Model
    from repro_torch.tree_util import tree_map
    cfg = cfg or fedkt_cut_config()
    model = Model(cfg)
    fcfg, tcfg, data = fedkt_round_inputs(cfg, level, gamma, **inputs)
    priced = fedkt_party_price(cfg, fcfg, tcfg)
    rec = RecordingLMEngine()
    _peak_reset(device)
    _zero_lm_counts()
    t0 = time.perf_counter()
    with HostPeak() as host:
        res = fedkt_lm(model, data["train"], data["public"], fcfg, tcfg,
                       test=data["test"], engine=rec, verbose=False,
                       device=device)["result"]
        peak = _peak(device)
    wall = time.perf_counter() - t0
    counts = _lm_counts()
    _zero_lm_counts()
    eval_batches = 8
    test_loss = eval_lm(model, res.final_state, TokenDataset(data["test"]),
                        batch_size=tcfg.batch_size, max_batches=eval_batches,
                        device=device)
    _sync(device)
    eval_counts = _lm_counts()
    res.final_state = (tree_map(lambda t: t.cpu(), res.final_state)
                       if keep else None)
    _peak_reset(device)
    log(f"[lm_train] fedkt cut {level} at {cfg.num_layers} layers: round "
        f"{wall:.1f} s {res.meta['seconds']}, peak {peak}, launches "
        f"{counts}")
    t1 = time.perf_counter()
    checked = fedkt_round_checks(rec, res, model, fcfg, tcfg, data, device)
    check_s = time.perf_counter() - t1
    k1 = (k1_round_row(rec, cfg.vocab_size)
          if gamma > 0 and device == "cuda" else None)
    want = fedkt_round_launches(cfg, fcfg, tcfg)
    # each evaluated batch a no-grad forward: K3 once an attention layer
    step = step_launches(cfg)
    fwd = {k: eval_batches * step[k] // 2 if k in (
        "flash_attention", "flash_attention_f32") else 0 for k in want}
    of_layers = (get_config(cfg.name).num_layers if cfg.name in ARCH_IDS
                 else cfg.num_layers)
    row = {"level": level, "gamma": gamma, "arch": cfg.name,
           "layers": cfg.num_layers, "of_layers": of_layers,
           "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "cuts": {"layers": f"{cfg.num_layers} of {of_layers}",
                    "steps_a_fit": f"{tcfg.steps} (the CLI's 100)",
                    "lr": f"{tcfg.learning_rate} (the CLI's 1e-3)"},
           "parties": fcfg.num_parties, "s": fcfg.num_partitions,
           "t": fcfg.num_subsets, "B": tcfg.batch_size,
           "S": tcfg.seq_len, "params_a_member": priced["params"],
           "state_bytes_a_member": priced["member_bytes"],
           "round_wall_s": wall, "seconds": res.meta["seconds"],
           "engine_seconds": rec.seconds, "check_s": check_s,
           "peak_mem_bytes": peak, "price_bytes": priced["price"],
           "price_fit_bytes": priced["fit"],
           "price_held_members": priced["held"],
           "peak_limit_bytes": FEDKT_CUT_PEAK_LIMIT,
           "host_peak_bytes": host.peak_bytes,
           "launches": counts, "launches_derived": want,
           "eval_launches": eval_counts, "k1": k1, **checked,
           "accuracy": res.accuracy, "test_loss": test_loss, "card": smi}
    log("[lm-fedkt-cut] " + json.dumps(row))
    if device != "cuda":        # the plain versions count no launch
        want = fwd = {k: 0 for k in want}
    if counts != want:
        raise AssertionError(f"fedkt cut {level}: launches {counts} != "
                             f"{want}")
    if eval_counts != fwd:
        raise AssertionError(f"fedkt cut {level}: eval launches "
                             f"{eval_counts} != {fwd}")
    if peak > FEDKT_CUT_PEAK_LIMIT:
        raise AssertionError(f"fedkt cut {level}: peak {peak} B over "
                             f"{FEDKT_CUT_PEAK_LIMIT}")
    if not 0.0 <= res.accuracy <= 1.0 or not math.isfinite(test_loss):
        raise AssertionError(f"fedkt cut {level}: accuracy {res.accuracy}, "
                             f"test loss {test_loss}")
    if not keep:
        return [counts, eval_counts], k1, None
    # on the host, out of the next round's device peak: the server's
    # (4096, 200,064) counts alone are 3.3 GB
    for dom_row in res.by_domain.values():
        dom_row["vote"] = dom_row["vote"]._replace(**{
            f: getattr(dom_row["vote"], f).cpu()
            for f in dom_row["vote"]._fields
            if torch.is_tensor(getattr(dom_row["vote"], f))})
    res.meta["round_wall_s"] = wall
    _peak_reset(device)
    return [counts, eval_counts], k1, res


def same_lm_round(name, got, want):
    """Raises unless two LM rounds agree bit for bit: ``same_round``'s
    checks, the server's clean top-2 gaps, and every leaf of every
    student and of the final model (``want``'s on the host)."""
    from repro_torch.tree_util import flatten_tree
    same_round(name, got, want)
    (g,), (w,) = ([row["vote"] for row in res.by_domain.values()]
                  for res in (got, want))
    if not same_bits(g.top_gap.cpu(), w.top_gap.cpu()):
        raise AssertionError(f"{name}: the server's gaps differ")
    for what, a, b in (("students", got.student_states,
                        want.student_states),
                       ("final model", got.final_state, want.final_state)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        if list(fa) != list(fb):
            raise AssertionError(f"{name}: {what}' leaves differ in name")
        for leaf in fa:
            if not same_bits(torch.as_tensor(fa[leaf]).cpu(),
                             torch.as_tensor(fb[leaf])):
                raise AssertionError(f"{name}: {what}' leaf {leaf} "
                                     f"differs")


def lm_fedkt_threads(smi, want, cfg, device="cuda", **inputs):
    """The L0 round of ``lm_fedkt_cut`` over ``cfg`` over party threads:
    ``launch.train.fedkt_lm`` with ``ThreadTransport(parallelism=2)``
    and engine "lm" (``ThreadSpanLMEngine``), both parties fitting,
    voting and encoding at once on the card's default stream.  Held bit
    for bit to ``want``, the recorded in-process round at the same depth
    (``same_lm_round``), its launches to ``fedkt_round_launches``
    exactly (counted under ``build.COUNT_LOCK``), its device peak to
    ``FEDKT_CUT_PEAK_LIMIT``, printed beside two parties' price and what
    was alive before it.
    Prints one ``[lm-fedkt-threads]`` line: the round's wall beside the
    in-process round's, each party thread's start of its teacher fits
    and end of its student fits (seconds from the round's start), the
    peaks.  Returns the round's launches.
    ``device="cpu"`` rehearses it on the CPU (no device peak)."""
    from repro_torch.federation.transport import ThreadTransport
    from repro_torch.kernels import build
    from repro_torch.launch.train import fedkt_lm
    from repro_torch.models import Model
    model = Model(cfg)
    fcfg, tcfg, data = fedkt_round_inputs(cfg, "L0", 0.0, **inputs)
    priced = fedkt_party_price(cfg, fcfg, tcfg)
    engine = ThreadSpanLMEngine()
    _peak_reset(device)
    alive = _alive()
    _zero_lm_counts()
    t0 = time.perf_counter()
    with HostPeak() as host:
        res = fedkt_lm(model, data["train"], data["public"], fcfg, tcfg,
                       test=data["test"], engine=engine,
                       transport=ThreadTransport(
                           parallelism=fcfg.num_parties),
                       verbose=False, device=device)["result"]
        peak = _peak(device)
    wall = time.perf_counter() - t0
    with build.COUNT_LOCK:
        counts = _lm_counts()
    spans = {name: {"start_s": a - t0, "end_s": b - t0}
             for name, (a, b) in sorted(engine.spans.items())}
    want_counts = fedkt_round_launches(cfg, fcfg, tcfg)
    row = {"level": "L0", "arch": cfg.name, "layers": cfg.num_layers,
           "transport": res.meta["transport"],
           "parallelism": res.meta["parallelism"],
           "round_wall_s": wall,
           "inprocess_round_wall_s": want.meta["round_wall_s"],
           "seconds": res.meta["seconds"],
           "inprocess_seconds": want.meta["seconds"],
           "party_threads": spans, "alive_bytes": alive,
           "peak_mem_bytes": peak, "price_two_parties_bytes":
           fcfg.num_parties * priced["price"],
           "price_a_party_bytes": priced["price"],
           "peak_limit_bytes": FEDKT_CUT_PEAK_LIMIT,
           "host_peak_bytes": host.peak_bytes,
           "launches": counts, "launches_derived": want_counts,
           "accuracy": res.accuracy,
           "wire_bytes": res.meta["wire_bytes"]["updates"], "card": smi}
    log("[lm-fedkt-threads] " + json.dumps(row))
    same_lm_round("fedkt threads", res, want)
    if device != "cuda":        # the plain versions count no launch
        want_counts = {k: 0 for k in want_counts}
    if counts != want_counts:
        raise AssertionError(f"fedkt threads: launches {counts} != "
                             f"{want_counts}")
    if peak > FEDKT_CUT_PEAK_LIMIT:
        raise AssertionError(f"fedkt threads: peak {peak} B over "
                             f"{FEDKT_CUT_PEAK_LIMIT}")
    if len(spans) != fcfg.num_parties:
        raise AssertionError(f"fedkt threads: party threads {spans}")
    return counts


def phase_lm_train(smi, profile=False):
    """The LM training path (phase lm_train), in order: N1 against its
    plain version (dh 256 included); full-width phi4-mini training; card
    vs CPU training at smoke width (phi4, gemma2, recurrentgemma, rwkv6);
    the LM FedKT flow at L0 and L2; the full-width label step and its
    token vote through K1; checkpoint to serve; then N2a and N2b against
    their plain versions, recurrentgemma-2b and rwkv6-7b (its cut)
    trained at full width, and, once their parameters are freed,
    stablelm-3b at full width (N1 at its head dim 80), then
    recurrentgemma-2b in float32 (``recurrentgemma_f32_train``: K3 and N1
    in float32 at dh 256, one step repeated bit for bit), then
    deepseek-moe-16b cut to ``DEEPSEEK_TRAIN_LAYERS`` (``deepseek_train``:
    its MoE backward on the card, one step repeated bit for bit), then,
    once its masters are freed, gemma2-27b cut to
    ``GEMMA2_TRAIN_LAYERS`` at B 2 x S 8192 (``gemma2_train``: the
    window and soft-caps on a train path, one step repeated bit for
    bit), then, each once the last one's masters are freed, granite-20b,
    mixtral-8x7b and llava-next-mistral-7b at their cuts
    (``granite_train``: N1 at 48:1 with its q heads split;
    ``mixtral_train``: top-2 routing at capacity 1.25; ``llava_train``:
    2880 stub embeddings + 1216 tokens a row), then, once llava's
    masters are freed, the LM FedKT round at phi4-mini's full width
    (``lm_fedkt_cut``: exact launches, every vote recomputed, K1 bit for
    bit the plain version on the card): at L0 in process at the depth
    where two parties fit the card at once (``fedkt_threads_layers``),
    then the same round over two party threads (``lm_fedkt_threads``),
    bit for bit the in-process one, then at L2 (gamma 0.1) cut to
    ``FEDKT_CUT_LAYERS``.  Returns (the
    backward rows {"n1", "n2a", "n2b"}, their worst errors, the main
    path's launches, the measured rows of the full-width train and label
    steps)."""
    from repro_torch.configs import get_config
    t0 = time.time()
    rows, err, rel = lm_backward_rows()
    log(f"[lm_train] N1 rows at {time.time() - t0:.1f} s")
    phi4 = get_config("phi4-mini-3.8b")
    params, counts, train_row = lm_full_train(phi4, smi)
    runs = [counts]
    log(f"[lm_train] full-width training at {time.time() - t0:.1f} s")
    for arch in ("phi4-mini-3.8b", "gemma2-27b", "recurrentgemma-2b",
                 "rwkv6-7b"):
        runs.append(lm_card_vs_cpu(arch))
    log(f"[lm_train] card vs CPU at {time.time() - t0:.1f} s")
    runs.append(lm_fedkt("L0")[1])
    runs.append(lm_fedkt("L2", gamma=0.1)[1])
    log(f"[lm_train] fedkt flow at {time.time() - t0:.1f} s")
    label_counts, label_row = lm_label_step(phi4, smi)
    runs.append(label_counts)
    torch.cuda.empty_cache()
    log(f"[lm_train] label step at {time.time() - t0:.1f} s")
    runs.append(lm_checkpoint_serve(phi4, params, smi))
    log(f"[lm_train] checkpoint serve at {time.time() - t0:.1f} s")
    if profile:     # last: a profiler session slows later host timing
        lm_profile_steps(phi4, params)
        log(f"[lm_train] profile at {time.time() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    n2a, n2a_err = rglru_backward_rows()
    n2b, n2b_err, n2b_rel = wkv_backward_rows()
    log(f"[lm_train] N2 rows at {time.time() - t0:.1f} s")
    measured = {"train": train_row, "label": label_row}
    for cfg in (*recurrent_train_configs(), get_config("stablelm-3b")):
        rec_params, rec_counts, measured[cfg.name] = lm_full_train(cfg, smi)
        runs.append(rec_counts)
        del rec_params
        torch.cuda.empty_cache()
        log(f"[lm_train] {cfg.name} training at {time.time() - t0:.1f} s")
    measured["recurrentgemma-2b-f32"], rf_runs = recurrentgemma_f32_train(smi)
    runs += rf_runs
    log(f"[lm_train] recurrentgemma-2b float32 training at "
        f"{time.time() - t0:.1f} s")
    measured["deepseek-moe-16b"], ds_runs = deepseek_train(smi)
    runs += ds_runs
    log(f"[lm_train] deepseek-moe-16b training at {time.time() - t0:.1f} s")
    measured["gemma2-27b"], g2_runs = gemma2_train(smi)
    runs += g2_runs
    log(f"[lm_train] gemma2-27b training at {time.time() - t0:.1f} s")
    for name, run in (("granite-20b", granite_train),
                      ("mixtral-8x7b", mixtral_train),
                      ("llava-next-mistral-7b", llava_train)):
        measured[name], cut_runs = run(smi)
        runs += cut_runs
        log(f"[lm_train] {name} training at {time.time() - t0:.1f} s")
    # L0 at the depth where two parties fit at once: the in-process
    # round, recorded and checked, is the one the thread round is held
    # to; L2 at FEDKT_CUT_LAYERS, where K1 runs at (2, 4096, 200,064)
    layers, room = fedkt_threads_layers()
    log(f"[lm_train] fedkt threads at {layers} layers: two parties' "
        f"price within {room:.0f} B")
    cut = fedkt_cut_config(layers)
    fedkt_runs, _, inprocess = lm_fedkt_cut(smi, "L0", 0.0, cfg=cut,
                                            keep=True)
    runs += fedkt_runs
    log(f"[lm_train] fedkt cut L0 at {cut.num_layers} layers at "
        f"{time.time() - t0:.1f} s")
    runs.append(lm_fedkt_threads(smi, inprocess, cut))
    del inprocess
    log(f"[lm_train] fedkt threads at {time.time() - t0:.1f} s")
    fedkt_runs, measured["fedkt_cut_k1"], _ = lm_fedkt_cut(smi, "L2", 0.1)
    runs += fedkt_runs
    log(f"[lm_train] fedkt cut L2 at {time.time() - t0:.1f} s")
    # the main path's launches: the sum of the runs above, each counted
    # from 0 just before it and read just after, so that no launch made
    # to compare a kernel with its plain version is in it
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    log("[lm_train] launches " + json.dumps(launches))
    backward = {"n1": rows, "n2a": n2a, "n2b": n2b}
    errors = {"n1": (err, rel), "n2a": (n2a_err, 0.0),
              "n2b": (n2b_err, n2b_rel)}
    return backward, errors, launches, measured


# one arch per family: the whole 10 x 4 x 2 matrix takes ~150 s of host
# time (``python -m repro_torch.launch.dryrun --all`` prices it anywhere)
DRYRUN_ARCHS = ("phi4-mini-3.8b", "mixtral-8x7b", "recurrentgemma-2b",
                "whisper-tiny")


def dryrun_pairs(smi, archs=DRYRUN_ARCHS):
    """``launch.dryrun.run_one`` over ``archs`` x every input shape x
    both production meshes: one line a pair; raises on an error or on
    skips other than ``SKIPS``'s."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import analysis, dryrun
    out_dir = os.path.join(ROOT, "build", "dryrun")
    skipped, traces = set(), {}
    for arch in archs:
        for name in INPUT_SHAPES:
            for multi_pod in (False, True):
                t = time.perf_counter()
                rec = dryrun.run_one(arch, name, multi_pod, out_dir,
                                     force=True, quiet=True, traces=traces)
                secs = time.perf_counter() - t
                if rec.get("error"):
                    raise AssertionError(f"dry-run {arch} {name}: "
                                         f"{rec['error']}")
                if rec.get("skipped"):
                    skipped.add((arch, name))
                    log(f"[dryrun] {arch} {name} {rec['mesh']} skipped: "
                        f"{rec['skipped']}")
                    continue
                peak = rec["peak_memory_bytes"]
                log(f"[dryrun] {arch} {name} {rec['mesh']} dominant "
                    f"{rec['dominant']} (t_compute {rec['t_compute']:.4g} "
                    f"s, t_memory {rec['t_memory']:.4g} s, t_collective "
                    f"{rec['t_collective']:.4g} s), peak/device "
                    f"{peak / 1e9:.2f} GB of {analysis.HBM_BYTES / 1e9:.0f}"
                    f" GB ({'fits' if peak <= analysis.HBM_BYTES else 'over'}"
                    f"), priced in {secs:.2f} s | {smi}")
            traces.clear()
    want = {k for k in dryrun.SKIPS if k[0] in archs}
    if skipped != want:
        raise AssertionError(f"dry-run skips {skipped} != SKIPS {want}")


@functools.lru_cache(maxsize=None)
def train_price(cfg, B=4, S=512):
    """The dry-run's record of lm_full_train's exact step of ``cfg`` (B x
    S positions, remat, AdamW, float32 masters) on a one-device mesh,
    priced on meta tensors once a (cfg, B, S): ``cut_train`` prints its
    peak beside the measured one, ``dryrun_train`` the whole record."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    tcfg = TrainConfig(batch_size=B, seq_len=S, steps=8, warmup_steps=2,
                       learning_rate=3e-4)
    return dryrun.price(cfg.name, InputShape("lm_train", S, B, "train"),
                        Mesh(("data",), (1,)), "local_1", cfg=cfg,
                        tcfg=tcfg)


def dryrun_train(smi, measured, cfg, B=4, S=512):
    """lm_train's exact step of ``cfg`` (B x S tokens) on a one-device
    mesh, predicted beside the phase's measured row.  Raises if the
    params, gradients
    and AdamW state it predicts exceed the measured peak, or if the
    calls it predicts of any kernel (K3, N1, K4, N2a, K5, N2b: each
    call's launches as the wrappers count them) differ from the
    launches the card counted a step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.launch import analysis
    from repro_torch.models import Model
    rec = train_price(cfg, B, S)
    n = analysis.count_params(Model(cfg).init_shapes(), exclude_embed=False)
    state = 4 * 4 * n          # float32 params, gradients, mu and nu
    calls = rec["kernels"]
    per_call = {"flash_attention_backward": fa.BWD_KERNELS,
                "rglru_scan_backward": rgs.BWD_KERNELS,
                "wkv6_backward": wk.BWD_KERNELS}
    predicted = {k: per_call.get(k, 1) * v["calls"]
                 for k, v in calls.items()}
    row = {"arch": cfg.name, "layers": cfg.num_layers, "B": B, "S": S,
           "predicted": {k: rec[k] for k in (
               "t_compute", "t_memory", "flops_per_device",
               "bytes_per_device", "resident_bytes",
               "activation_peak_bytes", "peak_memory_bytes")},
           "predicted_params_grads_adamw_bytes": state,
           "predicted_kernel_calls": {k: v["calls"]
                                      for k, v in calls.items()},
           "predicted_launches_per_step": predicted,
           "measured_step_ms_median_last6":
               measured["step_ms_median_last6"],
           "measured_peak_mem_bytes": measured["peak_mem_bytes"],
           "predicted_peak_over_measured":
               rec["peak_memory_bytes"] / measured["peak_mem_bytes"],
           "measured_launches_per_step": measured["launches_per_step"],
           "card": smi}
    log("[dryrun-train] " + json.dumps(row))
    if state > measured["peak_mem_bytes"]:
        raise AssertionError(f"predicted resident state {state} B exceeds "
                             f"the measured peak "
                             f"{measured['peak_mem_bytes']} B")
    # the wrappers' counts (their float32 share is priced with them)
    got = {k: v for k, v in measured["launches_per_step"].items()
           if v and not k.endswith("_f32")}
    if predicted != got:
        raise AssertionError(f"dry-run kernel launches {predicted} != the "
                             f"card's launches a step {got} at {cfg.name}")
    return row


def dryrun_label(smi, measured):
    """FedKT's label step priced at 16 members on the pod mesh (its
    protocol bytes), then at lm_label's 3 members and (2, 1024) block on
    one device beside that phase's measured wall (which adds the noisy
    vote's Laplace draw and K1: the dry-run prices the reference's
    noise-free label step)."""
    from repro_torch.launch import fedkt_dryrun
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    arch = "phi4-mini-3.8b"
    pod = fedkt_dryrun.price_label_step(arch, 16, 32, 4096,
                                        make_production_mesh(), "pod1_16x16")
    log("[dryrun-fedkt] " + json.dumps({
        "arch": arch, "members": 16, "B": 32, "S": 4096,
        "dominant": pod["dominant"], "t_compute": pod["t_compute"],
        "t_memory": pod["t_memory"], "t_collective": pod["t_collective"],
        "collective": pod["collective"], "protocol": pod["protocol"],
        "card": smi}))
    B, S = measured["queries"][0], measured["queries"][1] - 1
    one = fedkt_dryrun.price_label_step(arch, measured["members"], B, S,
                                        Mesh(("data",), (1,)), "local_1")
    row = {"arch": arch, "members": measured["members"], "B": B, "S": S,
           "predicted": {k: one[k] for k in (
               "t_compute", "t_memory", "flops_per_device",
               "bytes_per_device", "peak_memory_bytes")},
           "predicted_kernel_calls": {k: v["calls"]
                                      for k, v in one["kernels"].items()},
           "protocol": one["protocol"],
           "measured_label_step_wall_s": measured["label_step_wall_s"],
           "measured_peak_mem_bytes": measured["peak_mem_bytes"],
           "measured_launches": measured["launches"], "card": smi}
    log("[dryrun-label] " + json.dumps(row))
    if one["kernels"]["flash_attention"]["calls"] != \
            measured["launches"]["flash_attention"]:
        raise AssertionError("dry-run K3 calls != the label step's "
                             "launches")
    return {"pod": pod, "one": row}


def phase_dryrun(smi, measured):
    """Phase 10 (after lm_train, whose measured rows it reads; ``main``
    prices ``dryrun_pairs`` while the kernels build): the train step of
    phi4-mini, recurrentgemma,
    rwkv6's cut, stablelm-3b, deepseek-moe-16b's cut, recurrentgemma in
    float32, gemma2-27b's cut (at its B 2 x S 8192), the cuts of
    granite-20b, mixtral-8x7b and llava-next-mistral-7b (at its B 1 x S
    4096) and the label step beside their measured rows (peak memory
    and launches a step)."""
    from repro_torch.configs import get_config
    t0 = time.time()
    train = [dryrun_train(smi, measured["train"],
                          get_config("phi4-mini-3.8b"))]
    for cfg in (*recurrent_train_configs(), get_config("stablelm-3b"),
                deepseek_train_config()):
        train.append(dryrun_train(smi, measured[cfg.name], cfg))
    train.append(dryrun_train(smi, measured["recurrentgemma-2b-f32"],
                              recurrentgemma_f32_config()))
    train.append(dryrun_train(smi, measured["gemma2-27b"],
                              gemma2_train_config(), B=GEMMA2_TRAIN_B,
                              S=GEMMA2_TRAIN_S))
    for cfg in (granite_train_config(), mixtral_train_config()):
        train.append(dryrun_train(smi, measured[cfg.name], cfg))
    train.append(dryrun_train(smi, measured["llava-next-mistral-7b"],
                              llava_train_config(), B=LLAVA_TRAIN_B,
                              S=LLAVA_TRAIN_S))
    label = dryrun_label(smi, measured["label"])
    log(f"[dryrun] train and label at {time.time() - t0:.1f} s")
    return train, label


def shape_rows(rows):
    """Every shape a kernel was held and timed at, for its entry in the
    kernels line (the entry's own numbers are its first row's)."""
    keys = ("shape", "kernel_ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")
    return [{("ms" if k == "kernel_ms" else k): r.get(k) for k in keys}
            for r in rows]


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
    # the dry-run's pairs (host work on meta tensors) while nvcc runs
    device_name, smi = phase_device(during_build=dryrun_pairs)
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
    hist_rows, hist_err = phase_hist(n_teacher, n_student,
                                     vertical_hist_shapes())
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
    for kname, n in phase_fleet_processes(smi).items():
        launches[kname] += n
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
    launches["flash_attention"] += phase_gemma2_serving(smi)[1]
    torch.cuda.synchronize()
    log(f"[phase] gemma2_serve ok at {time.time() - t_start:.1f} s")

    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        _, rec = phase_batch_serving(get_config(arch),
                                     profile=profile_rounds)
        for kname, n in rec.items():
            launches[kname] = launches.get(kname, 0) + n
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[phase] {arch} serving ok at {time.time() - t_start:.1f} s")
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        phase_smoke_parity(arch)
    torch.cuda.synchronize()
    log(f"[phase] recurrent parity ok at {time.time() - t_start:.1f} s")

    launches["flash_attention"] += phase_moe_serving()
    torch.cuda.synchronize()
    log(f"[phase] moe_serving ok at {time.time() - t_start:.1f} s")
    launches["flash_attention"] += phase_dense_archs()
    torch.cuda.synchronize()
    log(f"[phase] dense_archs ok at {time.time() - t_start:.1f} s")
    arch_train = phase_arch_parity()
    launches["flash_attention"] += arch_train["flash_attention"]
    torch.cuda.synchronize()
    log(f"[phase] arch_parity ok at {time.time() - t_start:.1f} s")
    _, whisper, whisper_profiles = phase_whisper(smi)
    launches["flash_attention"] += whisper["flash_attention"]
    torch.cuda.synchronize()
    log(f"[phase] whisper ok at {time.time() - t_start:.1f} s")

    bwd_rows, bwd_err, lm, lm_measured = phase_lm_train(
        smi, profile=profile_rounds)
    for kname in ("flash_attention", "vote_aggregate", "rglru_scan",
                  "wkv6"):
        launches[kname] += lm[kname]
    torch.cuda.synchronize()
    log(f"[phase] lm_train ok at {time.time() - t_start:.1f} s")
    phase_dryrun(smi, lm_measured)
    log(f"[phase] dryrun ok at {time.time() - t_start:.1f} s")
    if profile_rounds:   # last: a profiler session slows later host timing
        for name, fn in whisper_profiles:
            _profiled(name, fn)
        log(f"[phase] whisper profile ok at {time.time() - t_start:.1f} s")
    del whisper_profiles

    v = next(r for r in vote_rows if r["U"] == 2 and r["noise"])
    h = hist_rows[0]
    a = att_rows[0]
    rg, wk = rg_rows[0], wk_rows[0]
    n1_rows = bwd_rows["n1"]
    n1 = n1_rows[0]
    (n1_err, n1_rel), (n2a_err, _), (n2b_err, n2b_rel) = (
        bwd_err[k] for k in ("n1", "n2a", "n2b"))
    n2a, n2b = bwd_rows["n2a"][0], bwd_rows["n2b"][0]
    # K3's and N1's float32 kernels (split TF32) at the shape the float32
    # recurrentgemma train step gives them; their launches are the
    # float32 share of the LM path's, the arch smokes' and whisper's
    a32 = next(r for r in att_rows
               if r["shape"] == "r_recurrentgemma_train_f32_lse")
    n32 = next(r for r in n1_rows if r["shape"] == "recurrentgemma_train_f32")
    f32 = {k: lm[k] + arch_train[k] + whisper[k]
           for k in ("flash_attention_f32", "flash_attention_backward_f32")}
    kernels = [
        {"name": "vote_aggregate", "route": "cuda",
         "source": "src/repro_torch/csrc/vote_aggregate.cu",
         "replaces": "src/repro/kernels/vote_aggregate.py:104",
         "launches": launches["vote_aggregate"], "max_abs_err": vote_err,
         "ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
         "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
         "library_ms": None,
         "shapes": shape_rows([lm_measured["fedkt_cut_k1"]])},
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
         "library_ms": a["library_ms"], "shapes": shape_rows(att_rows)},
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
        # N1 has no TPU kernel: the reference trains through autodiff of
        # its xla attention (ops.py:97)
        {"name": "flash_attention_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:97",
         "tpu_kernel": None,
         "launches": lm["flash_attention_backward"]
         + arch_train["flash_attention_backward"]
         + whisper["flash_attention_backward"],
         "max_abs_err": n1_err, "max_rel_err": n1_rel,
         "ms": n1["kernel_ms"],
         "plain_ms": n1["plain_ms"], "bound_ms": n1["bound_ms"],
         "bound_by": n1["bound_by"], "library_ms": n1["library_ms"],
         "shapes": shape_rows(n1_rows)},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": f32["flash_attention_f32"],
         "max_abs_err": a32["max_abs_err"], "ms": a32["kernel_ms"],
         "plain_ms": a32["plain_ms"], "bound_ms": a32["bound_ms"],
         "bound_by": a32["bound_by"], "library_ms": a32["library_ms"],
         "shapes": shape_rows([r for r in att_rows
                               if r["dtype"] == str(torch.float32)])},
        {"name": "flash_attention_backward_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:97",
         "tpu_kernel": None,
         "launches": f32["flash_attention_backward_f32"],
         "max_abs_err": n32["max_abs_err"],
         "max_rel_err": n32["max_rel_err"], "ms": n32["kernel_ms"],
         "plain_ms": n32["plain_ms"], "bound_ms": n32["bound_ms"],
         "bound_by": n32["bound_by"], "library_ms": n32["library_ms"],
         "shapes": shape_rows([r for r in n1_rows
                               if r["dtype"] == str(torch.float32)])},
        # N2a and N2b have no TPU kernel either: the reference trains the
        # recurrences through autodiff of its xla scan (ops.py:154) and
        # of its chunked step loop (ops.py:215)
        {"name": "rglru_scan_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:154",
         "tpu_kernel": None,
         "launches": lm["rglru_scan_backward"], "max_abs_err": n2a_err,
         "ms": n2a["kernel_ms"], "plain_ms": n2a["plain_ms"],
         "bound_ms": n2a["bound_ms"], "bound_by": n2a["bound_by"],
         "library_ms": None, "shapes": shape_rows(bwd_rows["n2a"])},
        {"name": "wkv6_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:215",
         "tpu_kernel": None,
         "launches": lm["wkv6_backward"], "max_abs_err": n2b_err,
         "max_rel_err": n2b_rel,
         "ms": n2b["kernel_ms"], "plain_ms": n2b["plain_ms"],
         "bound_ms": n2b["bound_ms"], "bound_by": n2b["bound_by"],
         "library_ms": None, "shapes": shape_rows(bwd_rows["n2b"])},
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
