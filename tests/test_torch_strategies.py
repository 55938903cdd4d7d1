"""The paper's baselines on the CPU against the live reference's, seed
for seed.

Tolerances: SOLO and central PATE accuracies within 0.01 (nn fits agree
by labels); an ``IterativeStrategy`` of one round and a few local steps
gives global params within 1e-6 of the reference's (the batches are
bit-exact; the init within ``prng.normal``'s 2.5e-7); a few rounds'
``acc_per_round`` within 0.02.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import FedKTConfig as JConfig
from repro.core.baselines import IterConfig as JIterConfig
from repro.core.learners import NNLearner as JNN
from repro.data.synthetic import tabular_binary as j_tabular
from repro.federation import CentralPATEStrategy as JPATE
from repro.federation import IterativeStrategy as JIterative
from repro.federation import SoloStrategy as JSolo
from repro.models.smallnets import MLP as JMLP
from repro_torch.configs.base import FedKTConfig
from repro_torch.convert import to_reference
from repro_torch.core.baselines import IterConfig, run_iterative
from repro_torch.core.learners import NNLearner
from repro_torch.federation import (CentralPATEStrategy, FedKTStrategy,
                                    IterativeStrategy, SoloStrategy)
from repro_torch.models.smallnets import MLP
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(num_parties=3, num_classes=2)


@pytest.fixture(scope="module")
def data():
    return j_tabular(n=2000, seed=0)


def _learners():
    return (NNLearner(MLP(14, 2, hidden=16), num_classes=2, steps=60,
                      device="cpu"),
            JNN(JMLP(14, 2, hidden=16), num_classes=2, steps=60))


@pytest.mark.parametrize("which", ["solo", "pate"])
def test_solo_and_pate_match_reference(data, which):
    port, ref = _learners()
    P, J = {"solo": (SoloStrategy, JSolo),
            "pate": (CentralPATEStrategy, JPATE)}[which]
    got = P(port).run(data, FedKTConfig(**CFG))
    want = J(ref).run(data, JConfig(**CFG))
    assert got.name == want.name
    assert abs(got.accuracy - want.accuracy) <= 0.01
    if which == "solo":
        assert len(got.meta["per_party"]) == CFG["num_parties"]


@pytest.mark.parametrize("algo", ["fedavg", "fedprox", "scaffold"])
def test_one_round_iterative_matches_reference(data, algo):
    icfg = dict(algo=algo, rounds=1, local_steps=3)
    got = IterativeStrategy(MLP(14, 2, hidden=16), IterConfig(**icfg),
                            device="cpu").run(data, FedKTConfig(**CFG))
    want = JIterative(JMLP(14, 2, hidden=16), JIterConfig(**icfg)).run(
        data, JConfig(**CFG))
    assert got.name == want.name == algo
    for a, b in zip(jax.tree.leaves(to_reference(got.state)),
                    jax.tree.leaves(want.state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert got.meta["acc_per_round"] == want.meta["acc_per_round"]


@pytest.mark.parametrize("algo", ["fedavg", "fedprox", "scaffold"])
def test_iterative_accuracy_per_round_matches_reference(data, algo):
    icfg = dict(algo=algo, rounds=3, local_steps=20)
    got = IterativeStrategy(MLP(14, 2, hidden=16), IterConfig(**icfg),
                            device="cpu").run(data, FedKTConfig(**CFG))
    want = JIterative(JMLP(14, 2, hidden=16), JIterConfig(**icfg)).run(
        data, JConfig(**CFG))
    assert len(got.meta["acc_per_round"]) == 3
    np.testing.assert_allclose(got.meta["acc_per_round"],
                               want.meta["acc_per_round"], atol=0.02)


def test_run_iterative_is_a_deprecated_wrapper(data):
    icfg = IterConfig(rounds=2, local_steps=5)
    with pytest.warns(DeprecationWarning, match="IterativeStrategy"):
        out = run_iterative(MLP(14, 2, hidden=16), data, icfg,
                            num_parties=3, device="cpu")
    res = IterativeStrategy(MLP(14, 2, hidden=16), icfg, device="cpu").run(
        data, FedKTConfig(num_parties=3))
    assert out["acc_per_round"] == res.meta["acc_per_round"]


def test_fedkt_strategy_is_the_session(data):
    port = NNLearner(MLP(14, 2, hidden=8), num_classes=2, steps=5,
                     device="cpu")
    res = FedKTStrategy(port, engine="vmap", device="cpu").run(
        data, FedKTConfig(**CFG, num_subsets=2))
    assert res.name == "fedkt" and 0.0 <= res.accuracy <= 1.0
    assert res.meta["device"] == "cpu" and res.epsilon is None
