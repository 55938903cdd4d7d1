"""The fleet's transports timed in turns on one card.

    python3 tools/fleet_bench.py [--turns 3] [--profile]

Runs ``chip_smoke.py``'s rf_L0 and gbdt_L0 rounds (Adult's size, 10
parties, s 2, t 5, engine ``vmap``) through the in-process transport,
the thread transport at 1, 2, 5 and 10 workers, the socket transport
at 10 party threads and the subprocess transport at 5 and 10 spawned
workers, ``--turns`` times in rotating order, and holds every round to
the turn's in-process round bit for bit (server labels, vote counts,
accuracy, frame digests).  Prints one JSON line a round: host wall
after a synchronise, the session's parties / server split, the
process's CPU seconds over the round (every thread of this process;
a spawned worker's are not counted) and the K1/K2 launches this process
made.  ``--profile`` then profiles one in-process and one 10-thread
rf_L0 round (torch.profiler: device busy share, top kernels).  Ends
with the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ADULT_FEATURES, ADULT_ROWS, _profiled,  # noqa: E402
                        run_round, same_round, tree_rounds)

TRANSPORTS = [("thread", 1), ("thread", 2), ("thread", 5), ("thread", 10),
              ("socket", 10), ("subprocess", 5), ("subprocess", 10)]


def timed(learner, data, cfg, transport, par):
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    th.launches = va.launches = 0
    cpu0 = time.process_time()
    res, wall = run_round(learner, data, cfg, "cuda",
                          transport=transport, parallelism=par)
    return res, {"wall_s": wall, "seconds": res.meta["seconds"],
                 "cpu_s": time.process_time() - cpu0,
                 "launches": [th.launches, va.launches]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fleet_bench: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.kernels import build
    build.build(["vote_aggregate", "tree_hist"])
    data = tabular_binary(n=ADULT_ROWS, num_features=ADULT_FEATURES,
                          seed=0)
    rounds = [r for r in tree_rounds() if r[0] in ("rf_L0", "gbdt_L0")]
    for name, learner, cfg, *_ in rounds:
        timed(learner, data, cfg, "inprocess", None)          # warm
    for turn in range(args.turns):
        k = turn % len(TRANSPORTS)
        order = TRANSPORTS[k:] + TRANSPORTS[:k]
        for name, learner, cfg, *_ in rounds:
            base, row = timed(learner, data, cfg, "inprocess", None)
            print(json.dumps({"turn": turn, "round": name,
                              "transport": "inprocess", **row}),
                  flush=True)
            for transport, par in order:
                res, row = timed(learner, data, cfg, transport, par)
                same_round(f"{name} {transport} {par}", res, base)
                print(json.dumps({"turn": turn, "round": name,
                                  "transport": transport,
                                  "parallelism": par, **row}), flush=True)
    if args.profile:
        name, learner, cfg, *_ = rounds[0]
        for transport, par in (("inprocess", None), ("thread", 10)):
            _profiled(f"{name}_{transport}",
                      lambda: run_round(learner, data, cfg, "cuda",
                                        transport=transport,
                                        parallelism=par))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
