"""Name-based sharding rules over a mesh description (``specs.py``)."""
from repro_torch.sharding.specs import (  # noqa: F401
    DP, batch_sharding, cache_sharding, constrain, opt_state_sharding,
    param_shardings, pregather_params, replicated, set_activation_mesh,
    spec_for_param,
)
