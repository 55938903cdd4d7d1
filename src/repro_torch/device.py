"""Device resolution: the card unless the caller asks for the CPU.

There is no silent fallback: asking for CUDA on a host without a usable
card raises, so a run that was meant for the GPU never carries on (and
never reports numbers) on the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.tree_util import tree_map

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:1", "cpu", "meta"
    or a ``torch.device``).  Raises RuntimeError when CUDA is asked for
    and ``torch.cuda.is_available()`` is false.  "meta" holds shapes and
    dtypes only: the dry-run traces steps on it (``launch/dryrun.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch sees no CUDA "
            f"device (torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device=\"cpu\" to run the plain "
            f"PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta") or \
            (dev.type == "meta" and dev.index is not None):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda', "
                         f"'cpu' or 'meta'")
    return dev


def put(tree, device):
    """Every leaf of ``tree`` (an array or tensor, or dicts, lists and
    tuples of them) as a tensor on ``resolve(device)``."""
    dev = resolve(device)
    return tree_map(lambda a: torch.as_tensor(a).to(dev), tree)


# the flags are process-wide: parties fitting in several threads at once
# (the thread and socket transports) share one setting, made by the
# first block to enter and undone by the last to leave
_F32_LOCK = threading.Lock()
_f32_depth = 0
_f32_saved: list = []


def _f32_flags():
    cudnn = torch.backends.cudnn
    return ((torch.backends.cuda.matmul, "allow_tf32", False),
            (cudnn, "allow_tf32", False), (cudnn, "deterministic", True),
            (cudnn, "benchmark", False))


@contextlib.contextmanager
def full_float32(dev: torch.device):
    """Within the block, products and convolutions on the card run in
    full float32 (no TF32, whatever the caller set) and cuDNN picks only
    deterministic algorithms (some backward-weight convolutions
    accumulate with atomics otherwise), so a float32 fit gives the same
    bits every run.  The caller's flags come back when the last block
    open in the process exits, so blocks may overlap across threads.
    Nothing changes on the CPU."""
    global _f32_depth
    if dev.type != "cuda":
        yield
        return
    flags = _f32_flags()
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_saved[:] = [getattr(obj, name) for obj, name, _ in flags]
            for obj, name, value in flags:
                setattr(obj, name, value)
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                for (obj, name, _), value in zip(flags, _f32_saved):
                    setattr(obj, name, value)
