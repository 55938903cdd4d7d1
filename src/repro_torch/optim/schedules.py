"""Learning-rate schedules (pure functions of the step;
``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr, warmup_steps, total_steps, min_frac=0.1):
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return lr * torch.where(s < warmup_steps, warm, cos)
    return f
