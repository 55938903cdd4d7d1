"""The port's crash-safety layer on the CPU: its round journal against
the reference's (the same bytes from the same appends, the same torn-tail
and corrupt-record recovery), its seeded fault plans against the
reference's, kill-and-resume, the dropped-ACK and duplicate drills, and
a seeded chaos round — each finishing bit-identical to the
uninterrupted in-process round.  A journal the port wrote is resumed by
the live JAX coordinator to the port's own result.

Tolerance: exact everywhere (file bytes, plans, labels, vote counts,
accuracy, epsilon, frame digests, wire bytes).
"""
import os
import time

import numpy as np
import pytest

from repro.configs.base import FedKTConfig as JConfig
from repro.core.learners import RFLearner as JRF
from repro.federation import FedKTSession as JSession
from repro.federation import SocketTransport as JSocketTransport
from repro.federation import faults as jfaults
from repro.federation import journal as jjournal
from repro_torch.configs.base import FedKTConfig
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import (ChaosProxy, Coordinator, Fault,
                                    FaultPlan, FedKTSession,
                                    JournalExistsError, QuorumError,
                                    RoundJournal, SocketTransport)
from repro_torch.federation import journal as pjournal
from repro_torch.federation.net import ACK
from torch_fleet import (ROUND, assert_same_round, make, party_frame,
                         raw_frame, run, vote_of)

CFG2 = dict(ROUND, num_parties=2)


@pytest.fixture(scope="module")
def data():
    return tabular_binary(n=600, seed=0)


@pytest.fixture(scope="module")
def serial(data):
    return {kind: run(data, kind, cfg=CFG2) for kind in ("rf", "gbdt")}


def socket_round(data, kind, transport, cfg=CFG2):
    return FedKTSession(make(kind), data, FedKTConfig(**cfg),
                        engine="vmap", transport=transport,
                        device="cpu").run()


# ---------------------------------------------------------------------------
# The journal file, against the reference's
# ---------------------------------------------------------------------------
APPENDS = [(0, b"frame-zero"), (2, b"frame-two" * 40), (1, b"")]


def _write(cls, path, appends=APPENDS):
    with cls(path) as j:
        for pid, frame in appends:
            j.append(pid, frame)


def _state(j):
    return (j.records, j.journaled_parties, j.corrupt_records_dropped,
            j.duplicate_records_dropped, j.truncated_tail, j.resumed)


def test_journal_bytes_identical_to_reference(tmp_path):
    _write(RoundJournal, tmp_path / "port.jrnl")
    _write(jjournal.RoundJournal, tmp_path / "ref.jrnl")
    got = (tmp_path / "port.jrnl").read_bytes()
    assert got == (tmp_path / "ref.jrnl").read_bytes()
    assert got.startswith(pjournal.MAGIC) and pjournal.MAGIC == b"FKTJRNL1"
    # each package replays the other's file
    with RoundJournal(tmp_path / "ref.jrnl", resume=True) as a, \
            jjournal.RoundJournal(tmp_path / "port.jrnl",
                                  resume=True) as b:
        assert _state(a) == _state(b)
        assert dict(a.records) == dict(APPENDS)


@pytest.mark.parametrize("damage", ["torn_header", "torn_frame",
                                    "corrupt", "duplicate"])
def test_journal_recovery_agrees_with_reference(tmp_path, damage):
    files = {}
    for name, cls in (("port", RoundJournal),
                      ("ref", jjournal.RoundJournal)):
        path = tmp_path / f"{name}.jrnl"
        _write(cls, path)
        raw = path.read_bytes()
        if damage == "torn_header":
            raw += b"\x01\x00\x00"                   # half a record head
        elif damage == "torn_frame":
            raw = raw[:-(len(b"frame-two" * 40) // 2)]
        elif damage == "corrupt":
            k = raw.index(b"frame-zero")
            raw = raw[:k] + b"X" + raw[k + 1:]
        else:                                        # party 0 twice
            rec = raw[8:8 + 12 + len(b"frame-zero")]
            raw += rec
        path.write_bytes(raw)
        files[name] = path
    with RoundJournal(files["ref"], resume=True) as a, \
            jjournal.RoundJournal(files["port"], resume=True) as b:
        assert _state(a) == _state(b)
        a.append(7, b"after")
        b.append(7, b"after")
        assert a.frame_matches(7, b"after") and b.frame_matches(7, b"after")
    assert files["port"].read_bytes() == files["ref"].read_bytes()


def test_journal_torn_tail_truncated_and_appendable(tmp_path):
    path = tmp_path / "round.jrnl"
    _write(RoundJournal, path, [(0, b"frame-zero"), (1, b"frame-one")])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    with RoundJournal(path, resume=True) as j:
        assert j.truncated_tail and j.journaled_parties == [0]
        assert os.path.getsize(path) < size - 3
        j.append(1, b"frame-one")
    with RoundJournal(path, resume=True) as j:
        assert dict(j.records) == {0: b"frame-zero", 1: b"frame-one"}


def test_journal_refusals_and_byte_exact_match(tmp_path):
    path = tmp_path / "round.jrnl"
    with RoundJournal(path) as j:
        j.append(3, b"frame-three")
        with pytest.raises(ValueError, match="already journaled"):
            j.append(3, b"frame-three")
        assert j.frame_matches(3, b"frame-three")
        assert not j.frame_matches(3, b"frame-THREE")
        assert not j.frame_matches(4, b"frame-three")
    with pytest.raises(JournalExistsError, match="resume"):
        RoundJournal(path)
    (tmp_path / "alien").write_bytes(b"NOTAJRNL" + b"\0" * 12)
    with pytest.raises(pjournal.JournalError, match="magic"):
        RoundJournal(tmp_path / "alien", resume=True)


# ---------------------------------------------------------------------------
# Fault plans, against the reference's
# ---------------------------------------------------------------------------
def _plan(p):
    return {k: (f.kind, f.at_byte, f.delay_s) for k, f in p.faults.items()}


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_random_equals_reference(seed):
    for kw in ({}, dict(fault_rate=0.6, max_delay_s=0.05)):
        got = FaultPlan.random(seed, 24, **kw)
        want = jfaults.FaultPlan.random(seed, 24, **kw)
        assert _plan(got) == _plan(want)
        assert got.kill_coordinator_on_party is None


def test_fault_plan_hook_and_kinds():
    assert FaultPlan().coordinator_hook() is None
    plan = FaultPlan(kill_coordinator_on_party=1)
    hook = plan.coordinator_hook()
    assert not hook("journaled", 0) and not hook("acked", 1)
    assert hook("journaled", 1)
    assert plan.log == ["kill_coordinator: party 1 journaled; dying "
                        "before ACK/fold"]
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor-strike")


# ---------------------------------------------------------------------------
# Kill and resume
# ---------------------------------------------------------------------------
def _crash(data, kind, journal):
    plan = FaultPlan(kill_coordinator_on_party=0)
    crashed = SocketTransport(parallelism=1, journal_path=journal,
                              chaos_plan=plan, connect_retries=2,
                              backoff_s=0.01)
    with pytest.raises(QuorumError):
        socket_round(data, kind, crashed)
    assert crashed.round_report["coordinator_killed"]
    assert any("kill_coordinator" in line for line in plan.log)
    with RoundJournal(journal, resume=True) as j:
        assert j.journaled_parties == [0]


@pytest.mark.parametrize("kind", ["rf", "gbdt"])
def test_coordinator_killed_and_resumed_is_bit_identical(tmp_path, data,
                                                         serial, kind):
    journal = str(tmp_path / "round.jrnl")
    _crash(data, kind, journal)
    res = socket_round(data, kind, SocketTransport(
        parallelism=2, journal_path=journal, resume=True))
    assert_same_round(res, serial[kind])
    sock = res.meta["socket"]
    assert sock["resumed"] is True
    assert sock["replayed_parties"] == [0]
    assert sock["corrupt_records_dropped"] == 0
    assert sorted(sock["arrived"]) == [0, 1]


def test_reference_coordinator_resumes_the_ports_journal(tmp_path, data,
                                                         serial):
    """The port's journal holds the reference's frames: the live JAX
    coordinator replays it and finishes the round to the port's own
    uninterrupted result."""
    journal = str(tmp_path / "round.jrnl")
    _crash(data, "rf", journal)
    want = serial["rf"]
    got = JSession(JRF(num_classes=2, num_trees=3, depth=3), data,
                   JConfig(**CFG2), engine="vmap",
                   transport=JSocketTransport(parallelism=1,
                                              journal_path=journal,
                                              resume=True)).run()
    assert got.meta["socket"]["replayed_parties"] == [0]
    (row,) = got.by_domain.values()
    np.testing.assert_array_equal(np.asarray(row["labels"]),
                                  vote_of(want).labels.numpy())
    assert got.accuracy == want.accuracy
    assert got.epsilon == want.epsilon
    assert got.meta["wire_bytes"]["per_party"] == \
        want.meta["wire_bytes"]["per_party"]


def test_fully_journaled_round_resumes_without_training(tmp_path, data,
                                                        serial):
    journal = str(tmp_path / "round.jrnl")
    first = socket_round(data, "rf", SocketTransport(
        parallelism=2, journal_path=journal))
    assert_same_round(first, serial["rf"])
    calls = []
    session = FedKTSession(make("rf"), data, FedKTConfig(**CFG2),
                           engine="vmap", device="cpu",
                           transport=SocketTransport(
                               parallelism=2, journal_path=journal,
                               resume=True))
    for p in session.parties:
        p.local_round = lambda *a, **k: calls.append(1)
    res = session.run()
    assert calls == []
    assert_same_round(res, serial["rf"])
    assert res.meta["socket"]["replayed_parties"] == [0, 1]


def test_journal_without_resume_refuses_stale_file(tmp_path, data):
    journal = str(tmp_path / "round.jrnl")
    with RoundJournal(journal) as j:
        j.append(0, b"stale-frame")
    with pytest.raises(JournalExistsError, match="resume"):
        socket_round(data, "rf", SocketTransport(parallelism=2,
                                                 journal_path=journal))


# ---------------------------------------------------------------------------
# Scripted connection faults through the chaos proxy
# ---------------------------------------------------------------------------
def _chaos_round(data, kind, faults, **kw):
    plan = FaultPlan(faults)
    res = socket_round(data, kind, SocketTransport(
        parallelism=1, chaos_plan=plan, **kw))
    return res, res.meta["socket"]


def test_dropped_ack_retransmit_reacked_exactly_once(data, serial):
    res, sock = _chaos_round(data, "rf", {0: Fault("drop_ack")})
    assert_same_round(res, serial["rf"])
    assert sum(sock["re_acked"].values()) == 1
    assert any("drop_ack" in line for line in sock["chaos"])
    assert len(sock["arrived"]) == 2


def test_duplicate_delivery_never_double_folds(data, serial):
    """Party 0's frame is redelivered after its real exchange, as in the
    reference's test: the coordinator re-ACKs it and folds each party
    once.  Party 1 starts its round only after the proxy has logged the
    duplicate's reply, so the round's report (written once both parties
    have arrived) always sees the re-ACK, however loaded the host."""
    plan = FaultPlan({0: Fault("duplicate")})
    session = FedKTSession(make("gbdt"), data, FedKTConfig(**CFG2),
                           engine="vmap", device="cpu",
                           transport=SocketTransport(parallelism=1,
                                                     chaos_plan=plan))
    party1 = session.parties[1]
    own_round = party1.local_round

    def after_duplicate(*args, **kwargs):
        deadline = time.monotonic() + 60.0
        while not any("duplicate delivery" in line for line in plan.log):
            assert time.monotonic() < deadline, plan.log
            time.sleep(0.01)
        return own_round(*args, **kwargs)

    party1.local_round = after_duplicate
    res = session.run()
    sock = res.meta["socket"]
    assert_same_round(res, serial["gbdt"])
    assert len(sock["arrived"]) == 2
    assert sum(sock["re_acked"].values()) == 1
    assert any("duplicate delivery" in line for line in sock["chaos"])


class _LateRecordPlan(FaultPlan):
    """A plan whose duplicate record lands a second after the re-ACK,
    by when the coordinator has had every update for a while."""

    def record(self, msg):
        if "duplicate delivery" in msg:
            time.sleep(1.0)
        super().record(msg)


def test_report_waits_for_a_relays_late_record(data, serial):
    """The round's report copies the plan's log only after the proxy
    has joined its relays, so a record made after the last update
    arrived is in it."""
    plan = _LateRecordPlan({0: Fault("duplicate")})
    res = socket_round(data, "rf", SocketTransport(parallelism=1,
                                                   chaos_plan=plan))
    sock = res.meta["socket"]
    assert_same_round(res, serial["rf"])
    assert any("duplicate delivery" in line for line in sock["chaos"])
    assert sock["chaos"] == plan.log


@pytest.mark.parametrize("fault", [Fault("corrupt", at_byte=64),
                                   Fault("kill_after", at_byte=100),
                                   Fault("delay", delay_s=0.05)],
                         ids=lambda f: f.kind)
def test_connection_fault_is_survived(data, serial, fault):
    res, sock = _chaos_round(data, "rf", {0: fault})
    assert_same_round(res, serial["rf"])
    assert any(fault.kind.split("_")[0] in line for line in sock["chaos"])
    if fault.kind == "corrupt":
        assert any("corrupt" in e for e in sock["rejected"])


@pytest.mark.parametrize("kind,parties,seed", [("rf", 2, 3),
                                               ("gbdt", 4, 4)])
def test_seeded_chaos_round(tmp_path, data, kind, parties, seed):
    cfg = dict(ROUND, num_parties=parties)
    ref = run(data, kind, cfg=cfg)
    plan = FaultPlan.random(seed=seed, n_connections=3 * parties,
                            fault_rate=0.6, max_delay_s=0.05)
    # the plan faults a first delivery, so something must fire
    assert min(plan.faults) < parties
    res = socket_round(data, kind, SocketTransport(
        parallelism=2, journal_path=str(tmp_path / "chaos.jrnl"),
        chaos_plan=plan), cfg=cfg)
    assert_same_round(res, ref)
    assert res.meta["socket"]["chaos"]
    with RoundJournal(str(tmp_path / "chaos.jrnl"), resume=True) as j:
        assert j.journaled_parties == list(range(parties))


def test_chaos_proxy_passthrough_when_unfaulted(data):
    coord = Coordinator([0], port=0).start()
    plan = FaultPlan({})
    proxy = ChaosProxy("127.0.0.1", coord.port, plan).start()
    try:
        frame, _ = party_frame(data, pid=0)
        assert raw_frame(proxy.port, frame) == ACK
        assert coord.updates.get_nowait().party_id == 0
        assert proxy.connections == 1 and plan.log == []
    finally:
        t0 = time.monotonic()
        proxy.stop()
        # the listener's shutdown wakes the blocked accept at once
        assert time.monotonic() - t0 < 1.0
        coord.stop()
