"""Mesh descriptions (``repro.launch.mesh``): axis names and sizes, and
nothing that touches a device.

``make_production_mesh`` names the reference's two production layouts,
now of H100s: (data 16, model 16), 256 cards, and (pod 2, data 16,
model 16), 512.  Either axis of 16 spans two 8-GPU NVLink nodes, so the
dry-run prices their collectives at one bandwidth a device
(``launch/analysis.py``).  ``make_local_mesh`` describes the cards of
this host over one "data" axis.  The port runs no sharded program on a
mesh (``sharding/specs.py``: the torch.distributed scope); the dry-run
reads the sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import device as D


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes.  ``shape`` maps each name to its size, as a
    ``jax.sharding.Mesh`` does; ``devices`` is an array of device
    indices of that shape (``devices.size`` is the device count)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        return np.arange(int(np.prod(self.sizes))).reshape(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 cards.
    Multi-pod: (pod=2, data=16, model=16) = 512 cards."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh() -> Mesh:
    """This host's cards over one "data" axis; raises where torch sees
    no CUDA device (``device.resolve``)."""
    D.resolve("cuda")
    return Mesh(("data",), (torch.cuda.device_count(),))
