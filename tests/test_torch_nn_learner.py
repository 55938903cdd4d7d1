"""``NNLearner`` on the CPU against the live reference's, seed for seed.

The batches are the reference's row for row (``prng.choice`` is
bit-exact), but Adam amplifies ulp-level differences over hundreds of
steps (a 2e-6 change of the init moves an MLP's logits by 0.09 after
300 steps in the reference itself), so:
  - a few steps from the reference's init carried across: every
    parameter within 1e-6;
  - whole fits (60 steps, the port's own init): >= 99 % equal
    predictions on the public set;
  - within the port, ``fit_stacked`` equals serial ``fit`` within 1e-6
    (and equal predictions), and the loop and vmap engines agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.learners import NNLearner as JNN
from repro.data.synthetic import digits as j_digits
from repro.data.synthetic import tabular_binary as j_tabular
from repro.models import smallnets as JS
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.learners import NNLearner
from repro_torch.federation import LoopEngine, Party, VmapEngine
from repro_torch.models import smallnets as S
from torch_threads import one_torch_thread  # noqa: F401


class RefInit:
    """A port net whose init is the reference net's, carried across."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref

    def init(self, key, device="cpu"):
        return from_reference(jax.jit(self.ref.init)(jnp.asarray(key)),
                              device)

    def apply(self, p, x):
        return self.port.apply(p, x)


@pytest.fixture(scope="module")
def tab():
    return j_tabular(n=2000, seed=0)


@pytest.fixture(scope="module")
def img():
    return j_digits(n=800, image_size=16, seed=0)


def _leaves_close(got, want, atol):
    got, want = jax.tree.leaves(to_reference(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("kind,steps", [("mlp", 1), ("mlp", 5),
                                        ("cnn", 3)])
def test_few_step_fit_matches_reference(tab, img, kind, steps):
    if kind == "mlp":
        port, ref, d = S.MLP(14, 2, hidden=16), JS.MLP(14, 2, hidden=16), tab
        nc = 2
    else:
        port, ref, d = S.PaperCNN(16, 1, 10), JS.PaperCNN(16, 1, 10), img
        nc = 10
    key = jax.random.PRNGKey(3)
    want = JNN(ref, num_classes=nc, steps=steps).fit(key, d["X_train"],
                                                     d["y_train"])
    got = NNLearner(RefInit(port, ref), num_classes=nc, steps=steps,
                    device="cpu").fit(np.asarray(key), d["X_train"],
                                      d["y_train"])
    _leaves_close(got, want, 1e-6)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_whole_fit_predictions_agree(tab, img, kind):
    if kind == "mlp":
        port, ref, d, nc = (S.MLP(14, 2, hidden=16),
                            JS.MLP(14, 2, hidden=16), tab, 2)
    else:
        port, ref, d, nc = S.PaperCNN(16, 1, 10), JS.PaperCNN(16, 1, 10), \
            img, 10
    key = jax.random.PRNGKey(5)
    jl = JNN(ref, num_classes=nc, steps=60)
    pl = NNLearner(port, num_classes=nc, steps=60, device="cpu")
    want = np.asarray(jl.predict(jl.fit(key, d["X_train"], d["y_train"]),
                                 d["X_public"]))
    got = pl.predict(pl.fit(np.asarray(key), d["X_train"], d["y_train"]),
                     d["X_public"])
    assert got.dtype == torch.int32
    assert (got.numpy() == want).mean() >= 0.99


def test_fit_stacked_equals_serial_fits(tab):
    """Three datasets of one pow2 bucket (and a fourth in a smaller one,
    which the stacked fit pads up): the shared-bucket members equal
    their serial fits."""
    pl = NNLearner(S.MLP(14, 2, hidden=16), num_classes=2, steps=40,
                   device="cpu")
    X, y = tab["X_train"], tab["y_train"]
    sets = [(X[:300], y[:300]), (X[300:600], y[300:600]),
            (X[600:857], y[600:857]), (X[900:1000], y[900:1000])]
    keys = prng.split(prng.PRNGKey(9), 4)
    stacked = pl.fit_stacked(keys, [a for a, _ in sets],
                             [b for _, b in sets])
    preds = pl.predict_stacked(stacked, tab["X_public"])
    assert tuple(preds.shape) == (4, len(tab["X_public"]))
    for i in range(3):
        serial = pl.fit(keys[i], *sets[i])
        member = {k: {n: t[i] for n, t in v.items()}
                  for k, v in stacked.items()}
        _leaves_close(member, to_reference(serial), 1e-6)
        np.testing.assert_array_equal(
            preds[i].numpy(), pl.predict(serial, tab["X_public"]).numpy())


def test_feature_mask_matches_reference(tab):
    cols = (0, 3, 5, 11)
    key = jax.random.PRNGKey(2)
    jl = JNN(JS.MLP(4, 2, hidden=16), num_classes=2, steps=5,
             feature_mask=cols)
    pl = NNLearner(RefInit(S.MLP(4, 2, hidden=16), JS.MLP(4, 2, hidden=16)),
                   num_classes=2, steps=5, feature_mask=cols, device="cpu")
    want = jl.fit(key, tab["X_train"], tab["y_train"])
    got = pl.fit(np.asarray(key), tab["X_train"], tab["y_train"])
    _leaves_close(got, want, 1e-6)
    np.testing.assert_array_equal(
        pl.predict(got, tab["X_public"]).numpy(),
        np.asarray(jl.predict(want, tab["X_public"])))


def test_loop_and_vmap_engines_agree():
    """One party's local round under both engines: pow2-aligned subsets
    share their buckets, so the vote gaps are equal and the students
    within 1e-6 (as in the reference's engine test)."""
    d = j_tabular(n=2048, seed=0)
    cfg = FedKTConfig(num_parties=2, num_partitions=2, num_subsets=2,
                      num_classes=2)
    learner = NNLearner(S.MLP(14, 2, hidden=16), num_classes=2, steps=30,
                        device="cpu")
    party = Party(party_id=0, X=d["X_train"], y=d["y_train"],
                  indices=np.arange(512), cfg=cfg, learner=learner,
                  student_learner=learner)
    key = prng.PRNGKey(1)
    upd_l, k_l = party.local_round(key, d["X_public"], 128, LoopEngine())
    upd_v, k_v = party.local_round(key, d["X_public"], 128, VmapEngine())
    np.testing.assert_array_equal(k_l, k_v)
    np.testing.assert_array_equal(upd_l.vote_gaps, upd_v.vote_gaps)
    for a, b in zip(upd_l.student_states, upd_v.student_states):
        _leaves_close(a, to_reference(b), 1e-6)
    assert upd_l.wire_bytes() == upd_v.wire_bytes() > 0
