"""Whole nn rounds on the CPU against the live JAX round, seed for seed.

Tolerances: >= 99 % equal server labels (nn fits agree by their labels,
not bit for bit) and accuracy within 0.01; epsilon within rtol=1e-6
(equal clean gaps give equal epsilons up to ``log1p``); party sizes,
query counts and wire bytes exact.
"""
import numpy as np
import pytest

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import NNLearner as JNN
from repro.data.synthetic import tabular_binary as j_tabular
from repro.federation import FedKTSession as JSession
from repro.models.smallnets import MLP as JMLP
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import NNLearner
from repro_torch.federation import FedKTSession
from repro_torch.models.smallnets import MLP
from torch_threads import one_torch_thread  # noqa: F401

ROUND = dict(num_parties=3, num_partitions=2, num_subsets=2, num_classes=2)
LEVELS = {"L0": {}, "L1": dict(gamma=0.1, query_fraction=0.2),
          "L2": dict(gamma=0.1, query_fraction=0.2)}


@pytest.fixture(scope="module")
def data():
    return j_tabular(n=1200, seed=0)


def _nn():
    return (NNLearner(MLP(14, 2, hidden=16), num_classes=2, steps=60),
            JNN(JMLP(14, 2, hidden=16), num_classes=2, steps=60))


def _labels(res):
    (row,) = res.by_domain.values()
    return np.asarray(row["labels"])


@pytest.mark.parametrize("level", ["L0", "L1", "L2"])
def test_nn_round_matches_reference(data, level):
    port, ref = _nn()
    kw = dict(ROUND, privacy_level=level, **LEVELS[level])
    got = FedKTSession(port, data, FedKTConfig(**kw), engine="vmap",
                       device="cpu").run()
    want = JSession(ref, data, JConfig(**kw), engine="vmap").run()
    assert (_labels(got) == _labels(want)).mean() >= 0.99
    assert abs(got.accuracy - want.accuracy) <= 0.01
    if level == "L0":
        assert got.epsilon is None and want.epsilon is None
    else:
        assert got.epsilon == pytest.approx(want.epsilon, rel=1e-6)
    assert got.meta["party_sizes"] == want.meta["party_sizes"]
    assert got.meta["queries"] == want.meta["queries"]
    for k in ("updates", "updates_payload", "labels", "per_party"):
        assert got.meta["wire_bytes"][k] == want.meta["wire_bytes"][k], k
    assert got.meta["party_bindings"] == want.meta["party_bindings"]
