"""Entry points: ``serve``, ``train``, ``federate`` and the dry-runs
(``dryrun``, ``fedkt_dryrun``); mesh descriptions for the latter."""
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: F401
                                     make_production_mesh)
