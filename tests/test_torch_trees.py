"""The port's tree learners against the JAX reference, on the CPU.

RF fits, predictions and stacked fits are exact (integer bootstrap
weights: every histogram is an integer count).  GBDT fits have the
reference's split arrays at this size and leaves within atol=1e-5
(float g/h summed in another order).  The port's stacked fits equal its
serial fits exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trees as JT
from repro.core.learners import GBDTLearner as JGBDT
from repro.core.learners import RFLearner as JRF
from repro_torch import prng
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import trees as T
from repro_torch.core.learners import GBDTLearner, RFLearner, accuracy
from repro_torch.tree_util import tree_leaves, tree_map


def _separable(n=600, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    y = ((X[:, 0] > 0.2) ^ (X[:, 1] < -0.1)).astype(np.int32)
    return X, y


def _assert_states_equal(port_state, ref_state, atol=0.0):
    a = tree_leaves(to_reference(port_state))
    b = [np.asarray(x) for x in jax.tree.leaves(ref_state)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        if atol:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(x, y)


def test_bins_and_binize_match_reference():
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (257, 9)).astype(np.float32)
    X[:, -1] = 1.0                          # constant => duplicate edges
    edges = T.make_bins(X)
    np.testing.assert_array_equal(edges, JT.make_bins(X))
    X[::5, 0] = edges[0, 3]                 # values ON edges
    X[1::7, 2] = edges[2, 30]
    got = T.binize(torch.from_numpy(X), torch.from_numpy(edges))
    want = JT.binize(jnp.asarray(X), jnp.asarray(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_bootstrap_draws_match_reference(seed):
    rf = T.RandomForest(num_trees=6, depth=3, num_classes=2)
    w, fm = rf.bootstrap(prng.PRNGKey(seed), 333, 9)
    jw, jfm = JT.RandomForest(num_trees=6, depth=3).bootstrap(
        jax.random.PRNGKey(seed), 333, 9)
    np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(fm, np.asarray(jfm))


@pytest.mark.parametrize("seed,depth,mask", [(0, 4, None), (5, 3, None),
                                             (2, 5, (0, 2, 3, 5))])
def test_rf_fit_and_predict_match_reference(seed, depth, mask):
    X, y = _separable(seed=seed)
    port = RFLearner(num_classes=2, num_trees=5, depth=depth,
                     feature_mask=mask, device="cpu")
    ref = JRF(num_classes=2, num_trees=5, depth=depth, feature_mask=mask)
    ps = port.fit(prng.PRNGKey(seed), X[:400], y[:400])
    rs = ref.fit(jax.random.PRNGKey(seed), X[:400], y[:400])
    _assert_states_equal(ps, rs)
    want = np.asarray(ref.predict(rs, X[400:]))
    np.testing.assert_array_equal(port.predict(ps, X[400:]).numpy(), want)
    # states carried across: each package predicts the other's fit
    np.testing.assert_array_equal(
        port.predict(from_reference(rs, "cpu"), X[400:]).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(ref.predict(to_reference(ps), X[400:])), want)
    if mask is None:        # the masked case hides feature 1 of the label
        assert accuracy(port, ps, X[400:], y[400:]) > 0.9


def test_gbdt_fit_matches_reference():
    X, y = _separable(seed=2)
    port = GBDTLearner(num_rounds=8, depth=3, device="cpu")
    ref = JGBDT(num_rounds=8, depth=3)
    ps = port.fit(prng.PRNGKey(0), X[:400], y[:400])
    rs = ref.fit(jax.random.PRNGKey(0), X[:400], y[:400])
    (sf, sb, leaf), edges = to_reference(ps)
    (rsf, rsb, rleaf), redges = rs
    np.testing.assert_array_equal(sf, np.asarray(rsf))
    np.testing.assert_array_equal(sb, np.asarray(rsb))
    np.testing.assert_array_equal(edges, np.asarray(redges))
    np.testing.assert_allclose(leaf, np.asarray(rleaf), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.predict(ps, X[400:]).numpy(),
                                  np.asarray(ref.predict(rs, X[400:])))
    assert accuracy(port, ps, X[400:], y[400:]) > 0.9


def _stacked_sets():
    rng = np.random.default_rng(3)
    sizes = (40, 70, 130)                # pow2 buckets 64, 128, 256
    Xs = [rng.normal(0, 1, (n, 6)).astype(np.float32) for n in sizes]
    ys = [((X[:, 0] > 0).astype(np.int32) ^ (X[:, 1] < 0)).astype(np.int32)
          for X in Xs]
    Xq = rng.normal(0, 1, (33, 6)).astype(np.float32)
    return Xs, ys, Xq


@pytest.mark.parametrize("kind", ["rf", "gbdt"])
def test_stacked_fit_equals_serial_fit(kind):
    """Zero-weight padding into a shared pow2 bucket: every stacked
    state equals the port's own serial fit exactly."""
    Xs, ys, Xq = _stacked_sets()
    learner = (RFLearner(num_classes=2, num_trees=6, depth=4, device="cpu")
               if kind == "rf"
               else GBDTLearner(num_rounds=8, depth=3, device="cpu"))
    keys = prng.split(prng.PRNGKey(5), len(Xs))
    stacked = learner.fit_stacked(keys, Xs, ys)
    preds = learner.predict_stacked(stacked, Xq)
    for i in range(len(Xs)):
        serial = learner.fit(keys[i], Xs[i], ys[i])
        sliced = tree_map(lambda leaf: leaf[i], stacked)
        for a, b in zip(tree_leaves(serial), tree_leaves(sliced)):
            assert torch.equal(a, b)
        assert torch.equal(preds[i], learner.predict(sliced, Xq))


def test_rf_stacked_fit_matches_reference():
    Xs, ys, Xq = _stacked_sets()
    port = RFLearner(num_classes=2, num_trees=6, depth=4, device="cpu")
    ref = JRF(num_classes=2, num_trees=6, depth=4)
    ps = port.fit_stacked(prng.split(prng.PRNGKey(5), 3), Xs, ys)
    rs = ref.fit_stacked(jax.random.split(jax.random.PRNGKey(5), 3),
                         Xs, ys)
    _assert_states_equal(ps, rs)
    np.testing.assert_array_equal(port.predict_stacked(ps, Xq).numpy(),
                                  np.asarray(ref.predict_stacked(rs, Xq)))


def test_gbdt_stacked_fit_matches_reference():
    """Each stacked GBDT against the reference's serial fit of its set:
    every round routes every training row to a leaf of the same value
    (within atol=1e-5), and the predictions agree.  Split arrays are not
    compared here: the reference's float32 cumsum can break an exact tie
    between two splits that route the rows identically either way."""
    rng = np.random.default_rng(4)
    Xs = [rng.normal(0, 1, (n, 6)).astype(np.float32)
          for n in (200, 300, 500)]
    ys = [((X[:, 0] > 0).astype(np.int32) ^ (X[:, 1] < 0)).astype(np.int32)
          for X in Xs]
    Xq = rng.normal(0, 1, (64, 6)).astype(np.float32)
    port = GBDTLearner(num_rounds=6, depth=3, device="cpu")
    ref = JGBDT(num_rounds=6, depth=3)
    keys = prng.split(prng.PRNGKey(1), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(1), 3)
    (sf, sb, leaf), edges = port.fit_stacked(keys, Xs, ys)
    preds = port.predict_stacked(((sf, sb, leaf), edges), Xq).numpy()
    for i, X in enumerate(Xs):
        rtrees, redges = ref.fit(jkeys[i], X, ys[i])
        xb = T.binize(torch.from_numpy(X), edges[i])
        got = T.tree_apply((sf[i], sb[i], leaf[i]), xb[None]).numpy()
        jxb = JT.binize(jnp.asarray(X), redges)
        want = jax.vmap(lambda t: JT.tree_apply(t, jxb))(rtrees)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            preds[i], np.asarray(ref.predict((rtrees, redges), Xq)))


def test_forest_feature_mask_respected():
    """Trees never split on masked features."""
    X, y = _separable()
    xb = T.binize(torch.from_numpy(X),
                  torch.from_numpy(T.make_bins(X)))[None]
    mask = torch.zeros((1, X.shape[1]))
    mask[0, 0] = 1.0                                  # only feature 0
    sf, _, _ = T.fit_trees_gini(xb, torch.from_numpy(y)[None],
                                torch.ones((1, len(y))), mask, depth=3,
                                num_classes=2)
    assert (sf == 0).all()


def test_convert_round_trip_keeps_structure_and_dtypes():
    X, y = _separable()
    rs = JRF(num_classes=2, num_trees=3, depth=3).fit(
        jax.random.PRNGKey(0), X, y)
    ps = from_reference(rs, "cpu")
    assert isinstance(ps, tuple) and isinstance(ps[0], tuple)
    assert ps[0][0].dtype == torch.int32 and ps[0][2].dtype == torch.float32
    back = to_reference(ps)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(rs)):
        assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
