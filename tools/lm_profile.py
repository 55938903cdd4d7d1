"""Where a full-width LM train step's time goes, on one card.

    python3 tools/lm_profile.py [--steps 2] [--arch whisper-tiny]

Builds the kernels and draws the arch's parameters at full width (random
weights from a seeded generator, bf16 compute on float32 masters).
phi4-mini-3.8b (the default): one warm train step, then ``--steps``
steps under torch.profiler (``chip_smoke.lm_profile_steps``: B 4 x S
512, AdamW, remat).  whisper-tiny: ``chip_smoke.whisper_train`` (8
steps of B 8 x 128 tokens + 1500 frames, its launch counts and falling
loss checked), then one more step under the profiler.  Prints the
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

from chip_smoke import (_profiled, lm_profile_steps, log,  # noqa: E402
                        phase_device, whisper_train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=("phi4-mini-3.8b", "whisper-tiny"))
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
    module = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    params = transformer.tree_of(module)
    del module
    lm_profile_steps(cfg, params, steps=args.steps)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
