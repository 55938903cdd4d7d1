"""The port's socket federation on the CPU: socket rounds against the
serial loop (RF, GBDT, a mixed nn/rf/gbdt roster) and RF against the
live JAX socket round, arrival-order independence of the fold, the
straggler and quorum rules, NAK reason bytes on the wire, and the
client's retry with backoff.

Tolerance: exact everywhere — labels, vote counts, accuracy, epsilon,
frame digests, wire bytes, student leaves.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import RFLearner as JRF
from repro.federation import FedKTSession as JSession
from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import GBDTLearner, NNLearner, RFLearner
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import (Coordinator, FedKTSession, PartyBinding,
                                    QuorumError, SocketTransport,
                                    UpdateRefused, VoteDomain,
                                    party_starting_keys)
from repro_torch.federation.net import (ACK, NAK, NAK_CORRUPT,
                                        NAK_DOMAIN_MISMATCH, NAK_DUPLICATE,
                                        NAK_PROTOCOL, NAK_REASON_NAMES,
                                        NAK_UNKNOWN_PARTY, RETRYABLE_NAKS,
                                        send_update_frame)
from repro_torch.federation.party import Party
from repro_torch.tree_util import tree_leaves
from torch_fleet import (ROUND, assert_same_as_reference, assert_same_round,
                         make, party_frame, raw_frame, run, vote_of)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return tabular_binary(n=600, seed=0)


@pytest.fixture(scope="module")
def serial(data):
    return {kind: run(data, kind) for kind in ("rf", "gbdt")}


def _failing_indices(n_parties, n_rows):
    shard = n_rows // n_parties
    ix = [np.arange(i * shard, (i + 1) * shard)
          for i in range(n_parties - 1)]
    return ix + [np.array([10 ** 9])]        # the last party raises


class SlowParty(Party):
    """A party whose local round outlives the deadline."""
    delay_s = 6.0

    def local_round(self, key, X_public, num_queries, engine=None):
        time.sleep(self.delay_s)
        return super().local_round(key, X_public, num_queries, engine)


# ---------------------------------------------------------------------------
# Bit-identity with the serial loop
# ---------------------------------------------------------------------------
def test_socket_smoke_two_parties(data):
    cfg = FedKTConfig(**dict(ROUND, num_parties=2))
    ref = FedKTSession(make("rf"), data, cfg, engine="vmap",
                       device="cpu").run()
    res = FedKTSession(make("rf"), data, cfg, engine="vmap",
                       transport="socket", device="cpu").run()
    assert_same_round(res, ref)
    assert res.meta["transport"] == "socket"
    assert res.meta["dropped_parties"] == []
    sock = res.meta["socket"]
    assert sorted(sock["arrived"]) == [0, 1]
    assert sum(sock["framed_bytes"].values()) == \
        res.meta["wire_bytes"]["updates"]
    assert sock["rejected"] == [] and not sock["coordinator_killed"]


@pytest.mark.parametrize("kind", ["rf", "gbdt"])
def test_socket_matches_serial_loop(data, serial, kind):
    res = run(data, kind, "socket", parallelism=3)
    assert_same_round(res, serial[kind])
    assert sorted(res.meta["socket"]["arrived"]) == [0, 1, 2]


def test_socket_rf_round_matches_reference_socket_round(data):
    kw = dict(ROUND, num_parties=2)
    got = FedKTSession(RFLearner(num_classes=2, num_trees=3, depth=3),
                       data, FedKTConfig(**kw), engine="vmap",
                       transport="socket", device="cpu").run()
    want = JSession(JRF(num_classes=2, num_trees=3, depth=3), data,
                    JConfig(**kw), engine="vmap", transport="socket").run()
    assert_same_as_reference(got, want)
    assert got.meta["dropped_parties"] == want.meta["dropped_parties"] == []
    assert got.meta["socket"]["framed_bytes"] == \
        want.meta["socket"]["framed_bytes"]


def test_socket_constant_memory_mode(data, serial):
    res = run(data, "rf", "socket", retain_students=False)
    assert res.student_states == []
    np.testing.assert_array_equal(vote_of(res).labels.numpy(),
                                  vote_of(serial["rf"]).labels.numpy())
    assert res.accuracy == serial["rf"].accuracy
    assert res.epsilon == serial["rf"].epsilon
    assert res.meta["wire_bytes"] == serial["rf"].meta["wire_bytes"]


# ---------------------------------------------------------------------------
# Heterogeneous roster: nn + rf + gbdt in one round
# ---------------------------------------------------------------------------
def _nn():
    from repro_torch.models.smallnets import MLP
    return NNLearner(MLP(14, 2, hidden=8), num_classes=2, steps=20)


def _het_session(data, transport):
    bindings = [PartyBinding(_nn()),
                PartyBinding(RFLearner(num_classes=2, num_trees=3,
                                       depth=2), engine="vmap"),
                PartyBinding(GBDTLearner(num_rounds=3, depth=2),
                             engine="vmap")]
    return FedKTSession(bindings, data, FedKTConfig(**ROUND),
                        final_learner=_nn(), transport=transport,
                        device="cpu")


@pytest.fixture(scope="module")
def het_ref(data):
    return _het_session(data, "inprocess").run()


def test_heterogeneous_socket_round_matches_inprocess(data, het_ref):
    res = _het_session(data, SocketTransport(parallelism=3)).run()
    assert_same_round(res, het_ref)
    for a, b in zip(tree_leaves(res.final_state),
                    tree_leaves(het_ref.final_state)):
        assert torch.equal(a, b)
    by_kind = res.meta["wire_bytes"]["by_learner_kind"]
    assert sorted(by_kind) == ["gbdt", "nn", "rf"]
    assert [b["learner"] for b in res.meta["party_bindings"]] == \
        ["nn", "rf", "gbdt"]
    assert res.meta["engine"] == "mixed"


@pytest.mark.parametrize("order", [[2, 0, 1], [1, 2, 0]])
def test_heterogeneous_fold_is_arrival_order_independent(data, het_ref,
                                                         order):
    session = _het_session(data, "inprocess")
    Xpub = session.data["X_public"]
    keys, key = party_starting_keys(session.parties, session.cfg.seed)
    updates = session.transport.run_round(session.parties, keys, Xpub,
                                          session.tq_party, None)
    agg = session.server.make_aggregate(Xpub, session.tq_server,
                                        session.engine)
    for i in order:
        agg.add(updates[i])
    vote = agg.finalize(key)
    assert agg.counts.dtype == torch.int32
    np.testing.assert_array_equal(agg.counts.numpy(),
                                  vote_of(het_ref).counts.numpy())
    np.testing.assert_array_equal(vote.labels.numpy(),
                                  vote_of(het_ref).labels.numpy())
    (dom,) = agg.domains()
    assert torch.equal(agg.counts_for(dom), agg.counts)
    assert agg.epsilon(vote) == het_ref.epsilon
    assert agg.epsilon(vote._replace(domain=None)) == het_ref.epsilon
    meta = agg.party_meta()
    assert sorted(meta) == [0, 1, 2]
    assert [meta[p]["learner_kind"] for p in (0, 1, 2)] == \
        ["nn", "rf", "gbdt"]
    assert {p: meta[p]["frame_sha256"] for p in meta} == \
        het_ref.meta["frame_sha256"]


def test_aggregate_sole_fold_accessors_refuse_an_empty_round(data):
    session = _het_session(data, "inprocess")
    agg = session.server.make_aggregate(session.data["X_public"],
                                        session.tq_server, session.engine)
    with pytest.raises(ValueError, match="no party updates"):
        agg.counts
    with pytest.raises(ValueError, match="no party updates"):
        agg.finalize(prng.PRNGKey(0))
    assert agg.party_meta() == {}


# ---------------------------------------------------------------------------
# Straggler / quorum semantics
# ---------------------------------------------------------------------------
def test_failed_party_dropped_at_quorum(data, serial):
    res = FedKTSession(
        make("rf"), data, FedKTConfig(**ROUND), engine="vmap",
        party_indices=_failing_indices(3, len(data["X_train"])),
        transport=SocketTransport(min_parties=2), device="cpu").run()
    assert res.meta["dropped_parties"] == [2]
    assert 2 in res.meta["socket"]["failed"]
    assert sorted(res.meta["socket"]["arrived"]) == [0, 1]
    assert len(res.student_states) == 2
    assert sorted(res.meta["frame_sha256"]) == [0, 1]
    two_thirds = 2 * serial["rf"].meta["wire_bytes"]["labels"] // 3
    assert res.meta["wire_bytes"]["labels"] == two_thirds
    assert res.epsilon is not None and res.epsilon > 0


def test_slow_party_dropped_at_deadline(data):
    session = FedKTSession(
        make("rf"), data, FedKTConfig(**ROUND), engine="vmap",
        transport=SocketTransport(min_parties=2, deadline_s=3.0),
        device="cpu")
    slow = session.parties[2]
    session.parties[2] = SlowParty(
        party_id=slow.party_id, X=slow.X, y=slow.y, indices=slow.indices,
        cfg=slow.cfg, learner=slow.learner,
        student_learner=slow.student_learner, engine=slow.engine)
    t0 = time.monotonic()
    res = session.run()
    assert time.monotonic() - t0 < SlowParty.delay_s
    assert res.meta["dropped_parties"] == [2]
    assert sorted(res.meta["socket"]["arrived"]) == [0, 1]
    assert res.meta["socket"]["deadline_s"] == 3.0


def test_below_quorum_raises(data):
    with pytest.raises(QuorumError, match=r"missing parties \[2\]"):
        FedKTSession(
            make("rf"), data, FedKTConfig(**ROUND), engine="vmap",
            party_indices=_failing_indices(3, len(data["X_train"])),
            transport="socket", device="cpu").run()


# ---------------------------------------------------------------------------
# NAK reasons on the wire
# ---------------------------------------------------------------------------
def test_nak_reason_table():
    assert NAK_REASON_NAMES == {0: "protocol", 1: "duplicate",
                                2: "domain-mismatch", 3: "unknown-party",
                                4: "corrupt"}
    assert RETRYABLE_NAKS == {NAK_CORRUPT}
    assert (ACK, NAK) == (b"\x06", b"\x15")
    assert UpdateRefused(NAK_CORRUPT).retryable
    assert not UpdateRefused(NAK_DUPLICATE).retryable
    assert "unspecified" in str(UpdateRefused(None))


def test_coordinator_nak_reason_bytes(data):
    frame, upd = party_frame(data, pid=0)
    other, _ = party_frame(data, pid=0, seed=1)
    unknown, _ = party_frame(data, pid=9)
    wrong_dom = VoteDomain("example", upd.domain.num_units + 1, 2)
    coord = Coordinator([0], port=0).start()
    strict = Coordinator([0], port=0,
                         expected_domains={0: wrong_dom}).start()
    try:
        port = coord.port
        assert raw_frame(port, b"garbage") == NAK + bytes([NAK_PROTOCOL])
        assert raw_frame(port, b"FKT1" + struct.pack("<I", 2) + b"{}") \
            == NAK + bytes([NAK_PROTOCOL])
        assert raw_frame(port, frame[:3] + bytes([9]) + frame[4:]) \
            == NAK + bytes([NAK_PROTOCOL])
        assert raw_frame(port, frame[:40] + bytes([frame[40] ^ 0xFF])
                          + frame[41:]) == NAK + bytes([NAK_CORRUPT])
        assert raw_frame(port, frame[:-5]) == NAK + bytes([NAK_CORRUPT])
        assert raw_frame(port, unknown) == \
            NAK + bytes([NAK_UNKNOWN_PARTY])
        assert raw_frame(port, frame) == ACK
        assert raw_frame(port, other) == NAK + bytes([NAK_DUPLICATE])
        assert raw_frame(port, frame) == ACK          # re-ACK, no fold
        assert coord.re_acked == {0: 1}
        assert coord.updates.qsize() == 1
        assert coord.updates.get_nowait().meta["encoded_bytes"] == \
            len(frame)
        assert any("version" in e for e in coord.errors)
        assert raw_frame(strict.port, frame) == \
            NAK + bytes([NAK_DOMAIN_MISMATCH])
        assert strict.updates.empty()
        assert any("mismatch" in e for e in strict.errors)
    finally:
        coord.stop()
        strict.stop()


def test_fatal_nak_raises_at_once_with_its_reason(data):
    coord = Coordinator([0, 1], port=0).start()
    try:
        unknown, _ = party_frame(data, pid=9)
        t0 = time.monotonic()
        with pytest.raises(UpdateRefused, match="unknown-party") as exc:
            send_update_frame("127.0.0.1", coord.port, unknown,
                              retries=8, backoff_s=0.5)
        assert time.monotonic() - t0 < 2.0     # no backoff was slept
        assert exc.value.reason == NAK_UNKNOWN_PARTY
        assert not exc.value.retryable
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# Client retry with backoff
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_client_gives_up_after_its_attempts():
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        send_update_frame("127.0.0.1", _free_port(), b"x", retries=3,
                          backoff_s=0.05)
    # slept 0.05 + 0.1 between attempts, none after the last
    assert 0.15 <= time.monotonic() - t0 < 2.0


def test_client_backs_off_until_a_late_coordinator_binds(data):
    frame, _ = party_frame(data, pid=0)
    port = _free_port()
    coord = Coordinator([0], port=port)
    starter = threading.Timer(0.4, coord.start)
    starter.start()
    try:
        send_update_frame("127.0.0.1", port, frame, retries=8,
                          backoff_s=0.05)
        assert coord.updates.get(timeout=5).party_id == 0
    finally:
        starter.join()
        coord.stop()


def test_oversized_frame_is_refused_before_sending():
    from repro_torch.federation import net

    class Huge(bytes):
        def __len__(self):
            return net.MAX_FRAME_BYTES
    with pytest.raises(ValueError, match="frame bound"):
        send_update_frame("127.0.0.1", 1, Huge(b"x"))


def test_socket_transport_context_manager():
    with SocketTransport(min_parties=1) as t:
        assert t.name == "socket" and t.streams
    t.close()
