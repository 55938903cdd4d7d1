"""A mixed rf+gbdt+nn round on the CPU against the live JAX round, seed
for seed, and an nn update's wire frame against the reference codec.

Tolerances: >= 99 % equal server labels and accuracy within 0.01 (the
nn and gbdt parties agree by labels, not bit for bit); the rf party's
students predict exactly the reference's labels, the nn party's >= 99 %
of them; wire bytes per learner kind exact; an nn update's frame
byte-identical to the reference's encoding of the same states.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import GBDTLearner as JGBDT
from repro.core.learners import NNLearner as JNN
from repro.core.learners import RFLearner as JRF
from repro.data.synthetic import tabular_binary as j_tabular
from repro.federation import FedKTSession as JSession
from repro.federation import PartyBinding as JBinding
from repro.federation import codec as jcodec
from repro.federation.domain import VoteDomain as JDomain
from repro.federation.messages import PartyUpdate as JUpdate
from repro.federation.party import Party as JParty
from repro.models.smallnets import MLP as JMLP
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.convert import to_reference
from repro_torch.core.learners import GBDTLearner, NNLearner, RFLearner
from repro_torch.federation import FedKTSession, Party, PartyBinding, codec
from repro_torch.models.smallnets import MLP
from torch_threads import one_torch_thread  # noqa: F401

ROUND = dict(num_parties=3, num_partitions=2, num_subsets=2, num_classes=2)


@pytest.fixture(scope="module")
def data():
    return j_tabular(n=1200, seed=0)


def _pair(kind):
    """(port learner on the CPU, reference learner) of one kind."""
    if kind == "nn":
        return (NNLearner(MLP(14, 2, hidden=16), num_classes=2, steps=60,
                          device="cpu"),
                JNN(JMLP(14, 2, hidden=16), num_classes=2, steps=60))
    if kind == "rf":
        return (RFLearner(num_classes=2, num_trees=4, depth=3,
                          device="cpu"),
                JRF(num_classes=2, num_trees=4, depth=3))
    return (GBDTLearner(num_rounds=5, depth=3, device="cpu"),
            JGBDT(num_rounds=5, depth=3))


def test_mixed_round_matches_reference(data):
    """nn, rf and gbdt parties in one round, the final model an nn: the
    server labels, and each nn and rf party's students' predictions on
    the queries."""
    kinds = ("nn", "rf", "gbdt")
    pairs = [_pair(k) for k in kinds]
    got = FedKTSession([PartyBinding(p) for p, _ in pairs], data,
                       FedKTConfig(**ROUND), engine="vmap",
                       device="cpu").run()
    want = JSession([JBinding(j) for _, j in pairs], data,
                    JConfig(**ROUND), engine="vmap").run()
    assert [b["learner"] for b in got.meta["party_bindings"]] == \
        list(kinds)
    (row,) = got.by_domain.values()
    (jrow,) = want.by_domain.values()
    assert (row["labels"] == np.asarray(jrow["labels"])).mean() >= 0.99
    assert abs(got.accuracy - want.accuracy) <= 0.01
    assert got.meta["wire_bytes"]["by_learner_kind"] == \
        want.meta["wire_bytes"]["by_learner_kind"]
    Xq = data["X_public"]
    for pid, (port, ref) in enumerate(pairs[:2]):
        for ps, js in zip(got.student_states[pid],
                          want.student_states[pid]):
            a = port.predict(ps, Xq).numpy()
            b = np.asarray(ref.predict(js, jnp.asarray(Xq)))
            assert (a == b).mean() >= (0.99 if kinds[pid] == "nn" else 1.0)


def test_nn_update_frame_matches_reference(data):
    """An nn party's update: the port's frame is byte-identical to the
    reference's encoding of the same states, and its header (paths,
    shapes, dtypes, key order) equals that of the reference's own nn
    update at the same key."""
    port, ref = _pair("nn")
    cfg = dict(ROUND, privacy_level="L2", gamma=0.1, query_fraction=0.5)
    rows = dict(X=data["X_train"], y=data["y_train"],
                indices=np.arange(300))
    party = Party(party_id=1, cfg=FedKTConfig(**cfg), learner=port,
                  student_learner=port, engine="vmap", **rows)
    upd, _ = party.local_round(prng.PRNGKey(4), data["X_public"], 75)
    frame = codec.encode_update(upd)
    mirror = JUpdate(party_id=upd.party_id,
                     student_states=to_reference(upd.student_states),
                     vote_gaps=np.asarray(upd.vote_gaps),
                     num_examples=upd.num_examples,
                     learner_kind=upd.learner_kind,
                     domain=JDomain.from_wire(upd.domain.to_wire()),
                     meta=dict(upd.meta))
    assert frame == jcodec.encode_update(mirror)
    jparty = JParty(party_id=1, cfg=JConfig(**cfg), learner=ref,
                    student_learner=ref, engine="vmap", **rows)
    jupd, _ = jparty.local_round(jnp.asarray(prng.PRNGKey(4)),
                                 data["X_public"], 75)
    _, got_head = codec.decode(frame)
    _, want_head = jcodec.decode(jcodec.encode_update(jupd))
    assert got_head["tree"] == want_head["tree"]
    assert got_head["leaves"] == want_head["leaves"]
    assert upd.learner_kind == jupd.learner_kind == "nn"


def test_chip_smoke_launch_counts_match_a_mixed_roster(data, monkeypatch):
    """chip_smoke's ``expected_launches`` for a mixed roster, against
    the histogram and vote dispatches a CPU round makes (the counts the
    card's kernels keep, one a dispatch)."""
    import chip_smoke
    from repro_torch.kernels import ops
    calls = {"tree_hist": 0, "votes": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(ops, "tree_hist",
                        counted("tree_hist", ops.tree_hist))
    monkeypatch.setattr(ops, "votes_with_clean",
                        counted("votes", ops.votes_with_clean))
    kinds = ["gbdt", "nn", "rf"]
    learners = {"nn": _pair("nn")[0],
                "rf": RFLearner(num_classes=2, num_trees=2, depth=3),
                "gbdt": GBDTLearner(num_rounds=3, depth=3)}
    cfg = FedKTConfig(**ROUND)
    FedKTSession([PartyBinding(learners[k]) for k in kinds], data, cfg,
                 final_learner=learners["nn"], engine="vmap",
                 device="cpu").run()
    assert (calls["tree_hist"], calls["votes"]) == \
        chip_smoke.expected_launches(cfg, kinds, "nn", depth=3, rounds=3)


@pytest.mark.parametrize("level", ["L0", "L2"])
def test_chip_smoke_vote_shapes_match_a_round(data, monkeypatch, level):
    """chip_smoke's ``round_vote_shapes``, against the (M, T, U, noise)
    of every vote dispatch a CPU round makes: under L2 each party votes
    over a ``query_fraction`` of the public set, with noise."""
    import chip_smoke
    from repro_torch.kernels import ops
    seen = []

    def recorded(preds, num_classes, noise=None):
        seen.append((*preds.shape, num_classes, noise is not None))
        return votes(preds, num_classes, noise)

    votes = ops.votes_with_clean
    monkeypatch.setattr(ops, "votes_with_clean", recorded)
    extra = (dict(privacy_level="L2", gamma=0.1, query_fraction=0.2)
             if level == "L2" else {})
    cfg = FedKTConfig(**ROUND, **extra)
    rf = RFLearner(num_classes=2, num_trees=2, depth=3)
    roster = [rf, _pair("nn")[0], rf]
    FedKTSession([PartyBinding(lrn) for lrn in roster], data, cfg,
                 final_learner=rf, engine="vmap", device="cpu").run()
    assert len(seen) == cfg.num_parties * cfg.num_partitions
    assert sorted(set(seen)) == chip_smoke.round_vote_shapes(
        [(cfg, len(data["X_public"]))])
