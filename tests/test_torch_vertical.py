"""The port's vertical (feature-split) federation on the CPU, against the
JAX reference: ``core.partition.vertical_split``, the reference's
3-silo feature-masked socket round (nn, rf and gbdt silos voting in one
shared example domain), the masks' restriction property for each
learner, ``launch/federate local --vertical``, and chip_smoke's
vertical fleet round rehearsed.

Tolerances: ``vertical_split`` exact (row order and masks); a whole
round against the reference's by at least 99 % equal server labels
(ROADMAP §3, port notes: nn fits start from inits within 2.5e-7 of the
reference's and Adam amplifies ulps); port against port exact (labels,
counts, accuracy, epsilon, frame digests, wire bytes).
"""
import contextlib
import io
import json

import numpy as np
import pytest

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import GBDTLearner as JGBDT
from repro.core.learners import NNLearner as JNN
from repro.core.learners import RFLearner as JRF
from repro.core.partition import vertical_split as jvertical_split
from repro.data.synthetic import tabular_binary as jtabular_binary
from repro.federation import FedKTSession as JSession
from repro.federation import PartyBinding as JBinding
from repro.federation import SocketTransport as JSocketTransport
from repro.models.smallnets import MLP as JMLP
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import GBDTLearner, NNLearner, RFLearner
from repro_torch.core.partition import vertical_split
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import (FedKTSession, PartyBinding,
                                    SocketTransport)
from repro_torch.kernels import ref
from repro_torch.launch import federate
from repro_torch.models.smallnets import MLP
from torch_fleet import assert_same_round
from torch_threads import one_torch_thread  # noqa: F401

SPLITS = [(seed, cols, parties) for seed in (0, 7, 11)
          for cols, parties in ((14, 3), (14, 1), (5, 5), (20, 4))]


@pytest.mark.parametrize("seed,cols,parties", SPLITS,
                         ids=[f"s{a}-c{b}-p{c}" for a, b, c in SPLITS])
def test_vertical_split_matches_reference(seed, cols, parties):
    ids = np.random.default_rng(seed).permutation(40) * 3 + 5
    order, masks = vertical_split(ids, cols, parties, seed=seed)
    jorder, jmasks = jvertical_split(ids, cols, parties, seed=seed)
    np.testing.assert_array_equal(order, jorder)
    assert masks == jmasks
    assert all(type(c) is int for m in masks for c in m)
    assert sorted(c for m in masks for c in m) == list(range(cols))


@pytest.mark.parametrize("ids,cols,parties,match", [
    (np.array([1, 1, 2]), 4, 2, "unique sample ids"),
    (np.arange(5), 2, 3, "cannot slice")], ids=["duplicate-ids", "narrow"])
def test_vertical_split_refuses_what_the_reference_refuses(ids, cols,
                                                          parties, match):
    for split in (vertical_split, jvertical_split):
        with pytest.raises(ValueError, match=match):
            split(ids, cols, parties)


def _three_silos(data, nn, rf, gbdt, binding, mlp, **nn_kw):
    """The reference test's roster (test_domain.py): nn, rf and gbdt
    silos on the masks of ``vertical_split(arange(n), 14, 3, seed=0)``."""
    row_order, masks = vertical_split(np.arange(len(data["X_train"])), 14,
                                      3, seed=0)
    bindings = [
        binding(nn(mlp(len(masks[0]), 2, hidden=8), num_classes=2,
                   steps=10, feature_mask=masks[0], **nn_kw)),
        binding(rf(num_classes=2, num_trees=4, depth=3,
                   feature_mask=masks[1]), engine="vmap"),
        binding(gbdt(num_classes=2, num_rounds=4, depth=3,
                     feature_mask=masks[2]), engine="vmap")]
    final = nn(mlp(14, 2, hidden=8), num_classes=2, steps=10, **nn_kw)
    return bindings, final, [row_order.copy() for _ in range(3)]


def test_vertical_3silo_socket_round_matches_reference():
    """The reference's 3-silo round (test_domain.py::
    test_vertical_3silo_socket_round) through the port over
    ``SocketTransport(parallelism=3)``: one shared example domain with
    parties [0, 1, 2], its wire bytes those of all updates, three framed
    frames, the server labels at least 99 % the reference's, and the
    port's in-process round bit for bit."""
    jdata = jtabular_binary(n=300, seed=0)
    data = tabular_binary(n=300, seed=0)
    np.testing.assert_array_equal(data["X_train"], jdata["X_train"])
    cfg = dict(num_parties=3, num_partitions=1, num_subsets=2,
               num_classes=2, seed=0)
    jb, jfinal, idx = _three_silos(jdata, JNN, JRF, JGBDT, JBinding, JMLP)
    want = JSession(jb, jdata, JConfig(**cfg), final_learner=jfinal,
                    party_indices=idx,
                    transport=JSocketTransport(parallelism=3)).run()
    runs = {}
    for name, transport in (("socket", SocketTransport(parallelism=3)),
                            ("inprocess", "inprocess")):
        pb, final, idx = _three_silos(data, NNLearner, RFLearner,
                                      GBDTLearner, PartyBinding, MLP,
                                      device="cpu")
        runs[name] = FedKTSession(pb, data, FedKTConfig(**cfg),
                                  final_learner=final, party_indices=idx,
                                  transport=transport, device="cpu").run()
    got = runs["socket"]
    (ident, row), = got.by_domain.items()
    assert row["vote"].domain.unit == "example"
    assert row["parties"] == [0, 1, 2]
    assert len(row["labels"]) == len(data["X_public"])
    assert got.meta["wire_bytes"]["by_domain"][ident] == \
        got.meta["wire_bytes"]["updates"]
    assert len(got.meta["socket"]["framed_bytes"]) == 3
    (jrow,) = want.by_domain.values()
    assert (row["labels"] == np.asarray(jrow["labels"])).mean() >= 0.99
    assert got.epsilon == want.epsilon
    assert 0.0 <= got.accuracy <= 1.0
    assert_same_round(got, runs["inprocess"])


def _masked(kind, mask):
    if kind == "nn":
        return NNLearner(MLP(len(mask), 2, hidden=8), num_classes=2,
                         steps=30, feature_mask=mask, device="cpu")
    if kind == "rf":
        return RFLearner(num_classes=2, num_trees=4, depth=3,
                         feature_mask=mask, device="cpu")
    return GBDTLearner(num_classes=2, num_rounds=4, depth=3,
                       feature_mask=mask, device="cpu")


@pytest.mark.parametrize("kind", ["nn", "rf", "gbdt"])
def test_vertical_masks_restrict_features(kind):
    """A feature-masked learner's predictions depend only on its columns
    (the reference's test_vertical_masks_actually_restrict_features, for
    each of the port's learners): off-mask columns set to 999 never
    change a prediction, on-mask ones do."""
    data = tabular_binary(n=256, seed=0)
    mask = (0, 3, 5)
    lrn = _masked(kind, mask)
    st = lrn.fit(prng.PRNGKey(0), data["X_train"][:128],
                 data["y_train"][:128])
    X = data["X_test"][:32].copy()
    base = np.asarray(lrn.predict(st, X))
    X_off = X.copy()
    X_off[:, [c for c in range(14) if c not in mask]] = 999.0
    np.testing.assert_array_equal(base, np.asarray(lrn.predict(st, X_off)))
    X_on = X.copy()
    X_on[:, list(mask)] = 999.0
    assert not np.array_equal(base, np.asarray(lrn.predict(st, X_on)))


FLAGS = ["--parties", "3", "--learners", "nn,rf,gbdt", "--vertical",
         "--trees", "3", "--depth", "3", "--subsets", "2", "--steps", "20",
         "--n-train", "800", "--engine", "vmap", "--seed", "2",
         "--device", "cpu"]


def test_federate_local_vertical_equals_the_inprocess_session():
    """``federate local --vertical`` (the parties deliver over TCP)
    reports, and returns, what the in-process session built from the
    same flags gives: every party's masked learner, one shared example
    domain, the labels, counts, accuracy, epsilon, frame digests and
    wire bytes bit for bit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = federate.main(["local", "--port", "0", *FLAGS])
    report = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
    args = federate.parse_args(["local", *FLAGS])
    sess = federate.build_session(args, "inprocess")
    masks = [b.learner.feature_mask for b in sess.bindings]
    assert sorted(c for m in masks for c in m) == list(range(14))
    assert [type(b.learner).__name__ for b in sess.bindings] == \
        ["NNLearner", "RFLearner", "GBDTLearner"]
    want = sess.run()
    assert_same_round(got, want)
    assert report["arrived"] == 3 and report["dropped_parties"] == []
    assert report["accuracy"] == round(float(want.accuracy), 4)
    assert report["epsilon"] == want.epsilon
    assert report["wire_bytes"] == json.loads(json.dumps(
        want.meta["wire_bytes"]))
    (row,) = got.by_domain.values()
    assert row["domain"].unit == "example" and row["parties"] == [0, 1, 2]


def test_chip_smoke_vertical_round_on_cpu(monkeypatch, capsys):
    """chip_smoke's vertical fleet round rehearsed on the CPU at small
    flags (``fleet_vertical``: the socket round bit for bit the
    in-process one, one shared domain, the CPU round's labels), and
    ``vertical_hist_shapes``' K2 rows among the histograms that round
    builds."""
    import chip_smoke
    built = set()
    plain = ref.tree_hist_ref

    def tap(xb, node, w, num_nodes, num_bins):
        built.add((node.shape[0], xb.shape[0], xb.shape[1], xb.shape[2],
                   num_nodes, num_bins))
        return plain(xb, node, w, num_nodes, num_bins)

    monkeypatch.setattr(ref, "tree_hist_ref", tap)
    flags = FLAGS[:-2]
    counts = chip_smoke.fleet_vertical(None, device="cpu", flags=flags)
    assert counts == {"tree_hist": 0, "vote_aggregate": 0}
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[fleet-vertical] "))
    row = json.loads(line.split(" ", 1)[1])
    assert row["parties"] == [0, 1, 2] and row["domain_unit"] == "example"
    assert row["label_agreement_vs_cpu"] == 1.0
    shapes = chip_smoke.vertical_hist_shapes([*flags, "--device", "cpu"])
    assert [s[0] for s in shapes] == [
        "vertical_rf_teachers_level2", "vertical_rf_students_level2",
        "vertical_gbdt_teachers_level2", "vertical_gbdt_students_level2"]
    for _, G, Gf, N, F, n, B in shapes:
        assert F < 14
        assert (G, Gf, N, F, n, B) in built
