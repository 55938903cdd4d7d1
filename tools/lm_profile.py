"""Where a full-width LM train step's time goes, on one card.

    python3 tools/lm_profile.py [--steps 2] [--arch ARCH]

ARCH: phi4-mini-3.8b (the default), recurrentgemma-2b, rwkv6-7b (cut to
``chip_smoke.RWKV_TRAIN_LAYERS`` of its 32 layers, as lm_train trains
it), stablelm-3b (all 32 layers; N1 at its head dim 80) or
whisper-tiny.

Builds the kernels and draws the arch's parameters at full width (random
weights from a seeded generator, bf16 compute on float32 masters).
A decoder (phi4-mini, recurrentgemma, rwkv6, stablelm): one warm train
step, then ``--steps`` steps under torch.profiler
(``chip_smoke.lm_profile_steps``: B 4 x S 512, AdamW, remat), with the
rank of each LM kernel (K3, N1, K4, N2a, K5, N2b) among the steps'
device costs.  whisper-tiny: ``chip_smoke.whisper_train`` (8 steps of B
8 x 128 tokens + 1500 frames, its launch counts and falling loss
checked), then one more step under the profiler.  Prints the
device's busy share and the ten largest kernels by device time, and
ends with the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (RWKV_TRAIN_LAYERS, _profiled,  # noqa: E402
                        lm_profile_steps, log, phase_device, whisper_train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=("phi4-mini-3.8b", "recurrentgemma-2b",
                             "rwkv6-7b", "stablelm-3b", "whisper-tiny"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model, transformer
    _, smi = phase_device()
    if args.arch == "whisper-tiny":
        _, _, train_step = whisper_train(smi)
        _profiled("train_step_whisper-tiny_8x128", train_step)
        log(smi)
        return 0
    cfg = get_config(args.arch)
    if args.arch == "rwkv6-7b":
        cfg = cfg.replace(num_layers=RWKV_TRAIN_LAYERS)
    module = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    params = transformer.tree_of(module)
    del module
    lm_profile_steps(cfg, params, steps=args.steps)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
