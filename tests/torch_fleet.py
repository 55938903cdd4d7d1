"""Shared pieces of the port's fleet tests (test_torch_transport,
test_torch_net, test_torch_faults, test_torch_federate), which import
them:

    from torch_fleet import ROUND, assert_same_round, make, run, vote_of

Every comparison here is exact: server labels, vote counts, accuracy,
epsilon, every party's frame digest and wire bytes, student leaves.
"""
import socket
import struct

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import FedKTConfig
from repro_torch.core.learners import GBDTLearner, RFLearner
from repro_torch.federation import FedKTSession
from repro_torch.federation.codec import encode_update
from repro_torch.federation.engines import VmapEngine
from repro_torch.federation.net import NAK
from repro_torch.federation.party import Party
from repro_torch.tree_util import tree_leaves

ROUND = dict(num_parties=3, num_partitions=2, num_subsets=2, num_classes=2,
             privacy_level="L2", gamma=0.1, query_fraction=0.5, seed=7)


def make(kind):
    if kind == "rf":
        return RFLearner(num_classes=2, num_trees=3, depth=3)
    return GBDTLearner(num_rounds=3, depth=2)


def vote_of(res):
    (row,) = res.by_domain.values()
    return row["vote"]


def assert_same_round(got, want):
    """Port against port: every observable of the round, bit for bit."""
    np.testing.assert_array_equal(vote_of(got).labels.numpy(),
                                  vote_of(want).labels.numpy())
    np.testing.assert_array_equal(vote_of(got).counts.numpy(),
                                  vote_of(want).counts.numpy())
    assert got.accuracy == want.accuracy
    assert got.epsilon == want.epsilon
    assert got.meta["frame_sha256"] == want.meta["frame_sha256"]
    assert got.meta["wire_bytes"] == want.meta["wire_bytes"]
    assert len(got.student_states) == len(want.student_states)
    for a, b in zip(tree_leaves(got.student_states),
                    tree_leaves(want.student_states)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def assert_same_as_reference(got, want):
    """Port against the live JAX round (RF: exact)."""
    (jrow,) = want.by_domain.values()
    np.testing.assert_array_equal(vote_of(got).labels.numpy(),
                                  np.asarray(jrow["labels"]))
    np.testing.assert_array_equal(vote_of(got).counts.numpy(),
                                  np.asarray(jrow["vote"].counts))
    assert got.accuracy == want.accuracy
    assert got.epsilon == want.epsilon
    for k in ("updates", "updates_payload", "labels", "labels_framed",
              "per_party"):
        assert got.meta["wire_bytes"][k] == want.meta["wire_bytes"][k], k
    for a, b in zip(tree_leaves(got.student_states),
                    tree_leaves(want.student_states)):
        np.testing.assert_array_equal(torch.as_tensor(a).numpy(),
                                      np.asarray(b))


def run(data, kind, transport="inprocess", parallelism=None, cfg=ROUND,
        **kw):
    return FedKTSession(make(kind), data, FedKTConfig(**cfg),
                        engine="vmap", transport=transport,
                        parallelism=parallelism, device="cpu", **kw).run()


def raw_frame(port, payload):
    """Sends one raw frame; returns the full (1-2 byte) reply."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(struct.pack("<I", len(payload)) + payload)
        reply = s.recv(1)
        if reply == NAK:
            reply += s.recv(1)
        return reply


def party_frame(data, pid, seed=0):
    cfg = FedKTConfig(**dict(ROUND, num_parties=1))
    lrn = RFLearner(num_classes=2, num_trees=2, depth=2, device="cpu")
    party = Party(party_id=pid, X=data["X_train"], y=data["y_train"],
                  indices=np.arange(96), cfg=cfg, learner=lrn,
                  student_learner=lrn)
    upd, _ = party.local_round(prng.PRNGKey(seed), data["X_public"], 16,
                               VmapEngine())
    return encode_update(upd), upd
