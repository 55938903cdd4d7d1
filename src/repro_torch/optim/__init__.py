from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, OptState, adamw, clip_by_global_norm, clip_scale, get,
    prox_grads, sgd,
)
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: F401
