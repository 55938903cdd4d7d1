"""Which op of a train step sets its peak of live memory, on meta tensors.

    python3 tools/train_peak.py [--arch gemma2-27b] [--layers 4]
                                [--batch 2] [--seq 8192]

Traces one ``core.distill.make_train_step`` step of the arch cut to
``--layers`` (B x S tokens, remat, AdamW, float32 masters) on the meta
device, as ``launch.dryrun`` prices it (no card, no data, little host
memory), and prints: the parameters and their 16 bytes each of state;
the peak of the storages the step allocates alive at once (the
dry-run's ``activation_peak_bytes``); the op at which that peak is
reached; the largest storages alive there; and the port's source lines
on the stack at that op.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.distill import make_train_step  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.launch.inputs import train_batch_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402


class PeakOp(analysis._Traffic):
    """The dry-run's traffic counter, also noting what is alive (and
    where the port's code is) each time the peak rises."""

    def __init__(self):
        super().__init__()
        self.op = None
        self.sizes = {}
        self.at = None

    def _hold(self, t):
        key = id(t.untyped_storage())
        if key in self._held:
            return
        before = self.peak
        super()._hold(t)
        self.sizes[key] = t.untyped_storage().nbytes()
        if self.peak > before:
            stack = [f"{f.filename}:{f.lineno} {f.line}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename]
            self.at = (self.op, sorted(self.sizes.values(),
                                       reverse=True)[:8], stack[-3:])

    def _release(self, key, n):
        self.sizes.pop(key, None)
        super()._release(key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)


def peak_op(cfg, B, S):
    """(parameters, the step's peak of live storages in bytes, the op
    reaching it, the largest storages alive there, the port's source
    lines on the stack there) of one train step of ``cfg`` at B x S."""
    model = Model(cfg)
    params = model.init_shapes()
    step, opt = make_train_step(model, TrainConfig(
        batch_size=B, seq_len=S, steps=8, warmup_steps=2,
        learning_rate=3e-4))
    state = opt.init(params)
    batch = train_batch_specs(cfg, InputShape("lm_train", S, B, "train"))
    probe = PeakOp()
    with meta.counting(meta.Work()), probe:
        step(params, state, batch)
    n = analysis.count_params(params, exclude_embed=False)
    return (n, probe.peak, *probe.at)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).replace(num_layers=args.layers)
    n, peak, op, sizes, stack = peak_op(cfg, args.batch, args.seq)
    print(f"{cfg.name} at {cfg.num_layers} layers, B {args.batch} x S "
          f"{args.seq}: {n:,} parameters, {16 * n / 1e9:.2f} GB of state "
          f"(masters, gradients, AdamW's m and v)")
    print(f"step's peak of live storages {peak / 1e9:.2f} GB, reached at "
          f"{op}")
    print("largest storages alive there (GB): "
          + ", ".join(f"{b / 1e9:.3f}" for b in sizes))
    for line in stack:
        print("  " + line.split("src/", 1)[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
