"""Device resolution: the card unless the caller asks for the CPU.

There is no silent fallback: asking for CUDA on a host without a usable
card raises, so a run that was meant for the GPU never carries on (and
never reports numbers) on the CPU.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:1", "cpu" or a
    ``torch.device``).  Raises RuntimeError when CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch sees no CUDA "
            f"device (torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device=\"cpu\" to run the plain "
            f"PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         f"'cpu'")
    return dev
