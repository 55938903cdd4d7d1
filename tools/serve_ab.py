"""Two trees' engine serving (or ``serve_batch`` prefill, or train step)
of one full-width arch, timed in turns on one card.

    python3 tools/serve_ab.py --parent DIR [--arch phi4-mini-3.8b]
        [--batch | --train]

DIR is another checkout of this repository (a ``git archive`` of an
earlier commit, unpacked).  Each turn is a process of its own that
imports one tree's ``chip_smoke.py``, builds that tree's kernels and
runs its ``phase_serving`` at the arch's full width (bf16, random
weights from seed 0): 16 requests of 1-512 prompt tokens, 32 tokens
each, closed loop behind ``Engine(num_slots=8, cache_len=1024)``, with
its own checks (budgets, exact K3 launches, a replay that must give the
same streams).  With ``--batch`` a turn runs the tree's
``phase_batch_serving`` instead: ``serve_batch`` over 4 prompts of 1024
tokens with its launch-count checks, then 7 more prefills whose host
walls (after a synchronise) give the median.  With ``--train`` a turn
runs the tree's ``lm_full_train``: 8 steps of B 4 x S 512 at full width
(AdamW, remat, random weights from seed 0) with its checks (exact
launches a step, first loss, falling loss).  The turns go parent,
change, change, parent.  Prints one JSON line a turn (tok/s, wall, TTFT
and per-token latency; or the prefill walls, their median and the
kernel launches of one prefill; or the step times, the median of the
last 6 and the peak), then the card's name and power limit.  Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_device()
from repro_torch.configs import get_config
cfg = get_config(sys.argv[2])
lens = np.random.default_rng(0).integers(1, 513, 16)
m, _ = c.phase_serving(cfg, lens, max_tokens=32, num_slots=8,
                       cache_len=1024, compare=0)
print("[ab] " + json.dumps({k: m[k] for k in (
    "tok_per_s", "wall_s", "ttft_s", "token_latency_ms", "dispatches")}))
"""

BATCH_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_device()
from repro_torch.configs import get_config
m, launches = c.phase_batch_serving(get_config(sys.argv[2]), gen=2, reps=7,
                                    tag="batch")
print("[ab] " + json.dumps({"launches": launches, **{k: m[k] for k in (
    "prefill_ms_median", "prefill_ms_runs", "peak_mem_bytes")}}))
"""

TRAIN_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_, smi = c.phase_device()
from repro_torch.configs import get_config
_, _, row = c.lm_full_train(get_config(sys.argv[2]), smi)
print("[ab] " + json.dumps({k: row[k] for k in (
    "step_ms", "step_ms_median_last6", "peak_mem_bytes", "losses",
    "launches_per_step")}))
"""


def turn(tree, arch, child):
    out = subprocess.run([sys.executable, "-c", child, str(tree), arch],
                         capture_output=True, text=True, check=True).stdout
    line = next(x for x in out.splitlines() if x.startswith("[ab] "))
    return json.loads(line[5:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batch", action="store_true",
                      help="time serve_batch's 4 x 1024 prefill instead")
    mode.add_argument("--train", action="store_true",
                      help="time 8 full-width train steps instead")
    args = ap.parse_args()
    child = BATCH_CHILD if args.batch else TRAIN_CHILD if args.train \
        else CHILD
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    for i, name in enumerate(("parent", "change", "change", "parent")):
        row = {"turn": i, "tree": name, "arch": args.arch,
               **turn(trees[name], args.arch, child)}
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
