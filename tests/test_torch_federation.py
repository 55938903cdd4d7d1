"""The port's whole FedKT round on the CPU against the live JAX session,
seed for seed, and its wire frames against the reference codec.

Tolerances: RF rounds are exact (labels, accuracy, party sizes, wire
bytes), epsilon within rtol=1e-6; GBDT rounds agree on >= 99% of the
server's vote labels and within 0.01 accuracy (float g/h sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import GBDTLearner as JGBDT
from repro.core import voting as jvoting
from repro.core.learners import RFLearner as JRF
from repro.data.synthetic import tabular_binary as j_tabular
from repro.federation import FedKTSession as JSession
from repro.federation import codec as jcodec
from repro.federation.domain import VoteDomain as JDomain
from repro.federation.messages import PartyUpdate as JUpdate
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.convert import to_reference
from repro_torch.core import voting
from repro_torch.core.learners import GBDTLearner, RFLearner
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import FedKTSession, Party, codec
from repro_torch.tree_util import tree_leaves

ROUND = dict(num_parties=3, num_partitions=2, num_subsets=2, num_classes=2)
LEVELS = {"L0": {}, "L1": dict(gamma=0.1, query_fraction=0.2),
          "L2": dict(gamma=0.1, query_fraction=0.2)}


@pytest.fixture(scope="module")
def data():
    d = tabular_binary(n=1200, seed=0)
    ref = j_tabular(n=1200, seed=0)
    for k in ref:
        np.testing.assert_array_equal(d[k], ref[k])
    return d


def _labels(res):
    (row,) = res.by_domain.values()
    return np.asarray(row["labels"])


def _rounds(data, kind, level):
    if kind == "rf":
        port, ref = (RFLearner(num_classes=2, num_trees=4, depth=3),
                     JRF(num_classes=2, num_trees=4, depth=3))
    else:
        port, ref = (GBDTLearner(num_rounds=5, depth=3),
                     JGBDT(num_rounds=5, depth=3))
    kw = dict(ROUND, privacy_level=level, **LEVELS[level])
    got = FedKTSession(port, data, FedKTConfig(**kw), engine="vmap",
                       device="cpu").run()
    want = JSession(ref, data, JConfig(**kw), engine="vmap").run()
    return got, want


@pytest.mark.parametrize("level", ["L0", "L1", "L2"])
def test_rf_round_matches_reference(data, level):
    got, want = _rounds(data, "rf", level)
    np.testing.assert_array_equal(_labels(got), _labels(want))
    assert got.accuracy == want.accuracy
    if level == "L0":
        assert got.epsilon is None and want.epsilon is None
    else:
        assert got.epsilon == pytest.approx(want.epsilon, rel=1e-6)
    assert got.meta["party_sizes"] == want.meta["party_sizes"]
    assert got.meta["queries"] == want.meta["queries"]
    for k in ("updates", "updates_payload", "labels", "labels_framed",
              "per_party"):
        assert got.meta["wire_bytes"][k] == want.meta["wire_bytes"][k], k
    # the students each party shipped are the reference's, leaf for leaf
    for ps, rs in zip(got.student_states, want.student_states):
        for a, b in zip(tree_leaves(ps), tree_leaves(rs)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_gbdt_round_matches_reference(data):
    got, want = _rounds(data, "gbdt", "L0")
    assert (_labels(got) == _labels(want)).mean() >= 0.99
    assert abs(got.accuracy - want.accuracy) <= 0.01
    assert got.meta["party_sizes"] == want.meta["party_sizes"]
    assert got.meta["wire_bytes"]["updates"] == \
        want.meta["wire_bytes"]["updates"]


def test_loop_and_vmap_engines_agree(data):
    cfg = FedKTConfig(**ROUND)
    learner = RFLearner(num_classes=2, num_trees=4, depth=3)
    a = FedKTSession(learner, data, cfg, engine="loop", device="cpu").run()
    b = FedKTSession(learner, data, cfg, engine="vmap", device="cpu").run()
    np.testing.assert_array_equal(_labels(a), _labels(b))
    assert a.accuracy == b.accuracy


@pytest.fixture(scope="module")
def rf_update(data):
    cfg = FedKTConfig(**ROUND, privacy_level="L2", gamma=0.1,
                      query_fraction=0.5)
    learner = RFLearner(num_classes=2, num_trees=3, depth=3, device="cpu")
    party = Party(party_id=1, X=data["X_train"], y=data["y_train"],
                  indices=np.arange(300), cfg=cfg, learner=learner,
                  student_learner=learner, engine="vmap")
    upd, _ = party.local_round(prng.PRNGKey(4), data["X_public"],
                               len(data["X_public"]) // 2)
    return upd


def _reference_update(upd):
    return JUpdate(party_id=upd.party_id,
                   student_states=to_reference(upd.student_states),
                   vote_gaps=np.asarray(upd.vote_gaps),
                   num_examples=upd.num_examples,
                   learner_kind=upd.learner_kind,
                   domain=JDomain.from_wire(upd.domain.to_wire()),
                   meta=dict(upd.meta))


def test_update_frame_byte_identical_to_reference(rf_update):
    frame = codec.encode_update(rf_update)
    ref_frame = jcodec.encode_update(_reference_update(rf_update))
    assert frame == ref_frame
    assert codec.update_encoded_nbytes(rf_update) == len(frame)
    # the reference decodes the port's frame, leaf for leaf
    dec = jcodec.decode_update(frame)
    assert dec.party_id == rf_update.party_id
    assert dec.learner_kind == "rf"
    assert dec.domain.key == rf_update.domain.key
    for a, b in zip(tree_leaves(to_reference(rf_update.student_states)),
                    tree_leaves(dec.student_states)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_reference_frame_decodes_in_port(rf_update):
    ref_frame = jcodec.encode_update(_reference_update(rf_update))
    dec = codec.decode_update(ref_frame)
    assert codec.encode_update(dec) == ref_frame
    np.testing.assert_array_equal(dec.vote_gaps, rf_update.vote_gaps)


@pytest.mark.parametrize("chunk", [64, 1000])
def test_frame_crc_in_pieces_byte_identical(rf_update, monkeypatch, chunk):
    """The codec's crc32 over pieces of ``chunk`` bytes on worker
    threads (a full-width student's frame takes ~170 pieces of 64 MiB)
    gives the reference's frame byte for byte, decodes, and still
    refuses a damaged byte."""
    monkeypatch.setattr(codec, "_CRC_CHUNK", chunk)
    frame = codec.encode_update(rf_update)
    assert len(frame) > 4 * chunk
    assert frame == jcodec.encode_update(_reference_update(rf_update))
    assert codec.encode_update(codec.decode_update(frame)) == frame
    flipped = bytearray(frame)
    flipped[len(frame) // 3] ^= 0x01
    with pytest.raises(codec.CorruptFrameError):
        codec.decode(bytes(flipped))


def test_codec_refuses_damaged_frames(rf_update):
    frame = codec.encode_update(rf_update)
    with pytest.raises(codec.TruncatedFrameError):
        codec.decode(frame[:-9])
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0xFF
    with pytest.raises(codec.CorruptFrameError):
        codec.decode(bytes(flipped))
    with pytest.raises(codec.CorruptFrameError):
        codec.decode(frame + b"\0")
    with pytest.raises(codec.VersionMismatchError):
        codec.decode(frame[:3] + bytes([9]) + frame[4:])


@pytest.mark.parametrize("consistent", [True, False])
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_consistent_vote_matches_reference(consistent, gamma):
    """The server-side vote: per-party counts, noise, argmax and clean
    gap, against the reference at the same key."""
    rng = np.random.default_rng(int(consistent) + 10 * int(gamma * 2))
    preds = rng.integers(0, 3, (4, 2, 80)).astype(np.int32)
    got = voting.consistent_vote(torch.from_numpy(preds), 4,
                                 consistent=consistent, gamma=gamma,
                                 key=prng.PRNGKey(3))
    want = jvoting.consistent_vote(jnp.asarray(preds), 4,
                                   consistent=consistent, gamma=gamma,
                                   key=jax.random.PRNGKey(3))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.top_gap.numpy(),
                                  np.asarray(want.top_gap))
    assert got.domain.key == want.domain.key
