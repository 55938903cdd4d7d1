"""Where a full-width LM train step's time goes, on one card.

    python3 tools/lm_profile.py [--steps 2]

Builds the kernels, draws phi4-mini-3.8b's parameters at full width
(random weights from a seeded generator, bf16 compute on float32
masters), runs one warm train step and then ``--steps`` steps under
torch.profiler (``chip_smoke.lm_profile_steps``: B 4 x S 512, AdamW,
remat), and prints the device's busy share and the ten largest kernels
by device time.  Ends with the card's name and power limit.  Needs a
card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import lm_profile_steps, log, phase_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model, transformer
    _, smi = phase_device()
    cfg = get_config("phi4-mini-3.8b")
    module = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    params = transformer.tree_of(module)
    del module
    lm_profile_steps(cfg, params, steps=args.steps)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
