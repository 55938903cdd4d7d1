"""The port's transports on the CPU: the thread and subprocess rounds
against the port's in-process round (RF and GBDT), RF rounds through
each port transport against the live JAX round through the same
reference transport, the registry, the context managers, pool cleanup
when a party raises, and the thread-safety of the kernel plumbing.

Tolerance: exact everywhere — server labels, vote counts, accuracy,
epsilon, every party's frame digest and wire bytes, student leaves.
"""
import multiprocessing
import pickle
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
from repro_torch.core.learners import RFLearner
from repro_torch.data.synthetic import tabular_binary
from repro_torch.federation import (FedKTSession, InProcessTransport,
                                    SubprocessTransport, ThreadTransport,
                                    get_transport)
from repro_torch.federation import transport as T
from torch_fleet import (ROUND, assert_same_as_reference, assert_same_round,
                         make, run)


@pytest.fixture(scope="module")
def data():
    return tabular_binary(n=600, seed=0)


@pytest.fixture(scope="module")
def serial(data):
    return {kind: run(data, kind) for kind in ("rf", "gbdt")}


@pytest.mark.parametrize("kind", ["rf", "gbdt"])
@pytest.mark.parametrize("transport,parallelism", [("thread", 3),
                                                   ("thread", 1),
                                                   ("subprocess", 2)])
def test_transport_matches_inprocess(data, serial, kind, transport,
                                     parallelism):
    res = run(data, kind, transport, parallelism)
    assert_same_round(res, serial[kind])
    assert res.meta["transport"] == transport
    assert res.meta["parallelism"] == parallelism
    assert res.meta["wire_bytes"]["updates"] > \
        res.meta["wire_bytes"]["updates_payload"] > 0
    assert sorted(res.meta["frame_sha256"]) == [0, 1, 2]


@pytest.mark.parametrize("transport", ["thread", "subprocess"])
def test_rf_round_matches_reference_transport(data, transport):
    kw = dict(ROUND, num_parties=2)
    got = FedKTSession(RFLearner(num_classes=2, num_trees=3, depth=3),
                       data, FedKTConfig(**kw), engine="vmap",
                       transport=transport, device="cpu").run()
    want = JSession(JRF(num_classes=2, num_trees=3, depth=3), data,
                    JConfig(**kw), engine="vmap",
                    transport=transport).run()
    assert_same_as_reference(got, want)
    assert got.meta["transport"] == want.meta["transport"] == transport


@pytest.mark.parametrize("engine", ["loop", "vmap"])
def test_parties_pickle_for_spawned_workers(data, engine):
    """What a spawned worker receives: each learner kind's party with its
    engine and device, equal after a pickle round trip."""
    from repro_torch.core.learners import NNLearner
    from repro_torch.federation import PartyBinding
    from repro_torch.models.smallnets import MLP
    bindings = [PartyBinding(NNLearner(MLP(14, 2, hidden=8),
                                       num_classes=2, steps=5)),
                PartyBinding(make("rf")), PartyBinding(make("gbdt"))]
    session = FedKTSession(bindings, data, FedKTConfig(**ROUND),
                           engine=engine, device="cpu")
    for party in session.parties:
        back = pickle.loads(pickle.dumps(party))
        assert back.learner == party.learner
        assert back.learner.device == "cpu"
        assert type(back.engine) is type(party.engine)
        np.testing.assert_array_equal(back.indices, party.indices)


def test_get_transport_registry():
    assert get_transport("inprocess").name == "inprocess"
    assert get_transport("thread", 4).parallelism == 4
    assert get_transport("subprocess").name == "subprocess"
    assert get_transport("socket", 4).name == "socket"
    assert get_transport("socket", 4).parallelism == 4
    t = ThreadTransport(parallelism=2)
    assert get_transport(t) is t
    with pytest.raises(ValueError, match="carrier-pigeon"):
        get_transport("carrier-pigeon")
    with pytest.raises(ValueError, match="socket"):
        get_transport("carrier-pigeon")
    with pytest.raises(ValueError, match="by name"):
        get_transport(InProcessTransport(), parallelism=2)
    with pytest.raises(ValueError, match="serial"):
        InProcessTransport(parallelism=2)


def test_transports_are_context_managers():
    for name in ("inprocess", "thread", "subprocess", "socket"):
        with get_transport(name) as t:
            assert t.name == name
        t.close()
        t.close()


def _failing_shards(bad_first):
    shards = [np.arange(0, 100), np.arange(100, 200)]
    bad = np.array([10 ** 9])                 # out of range: IndexError
    return [bad] + shards if bad_first else shards + [bad]


def test_subprocess_cleanup_on_party_failure(data):
    """A raising party terminates the whole spawned pool: no worker
    outlives the failed round."""
    before = set(multiprocessing.active_children())
    session = FedKTSession(make("rf"), data, FedKTConfig(**ROUND),
                           engine="vmap", party_indices=_failing_shards(
                               bad_first=False),
                           transport="subprocess", parallelism=3,
                           device="cpu")
    with pytest.raises(IndexError):
        session.run()
    leaked = [p for p in multiprocessing.active_children()
              if p not in before]
    assert leaked == []


def test_thread_cleanup_on_party_failure(data):
    """The thread round raises promptly with its queued parties
    cancelled, and the transport serves the next round."""
    with ThreadTransport(parallelism=1) as transport:
        session = FedKTSession(make("rf"), data, FedKTConfig(**ROUND),
                               engine="vmap", party_indices=_failing_shards(
                                   bad_first=True),
                               transport=transport, device="cpu")
        calls = []
        real = session.parties[1].local_round

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)
        session.parties[1].local_round = spy
        with pytest.raises(IndexError):
            session.run()
        time.sleep(0.2)
        # the worker may have taken party 1 before the failure was seen;
        # party 2, queued behind it, is cancelled
        assert len(calls) <= 1
        ok = FedKTSession(make("rf"), data, FedKTConfig(**ROUND),
                          engine="vmap", transport=transport,
                          device="cpu").run()
        assert ok.meta["num_updates"] == 3


def _cuda_party(data):
    session = FedKTSession(make("rf"), data, FedKTConfig(**ROUND),
                           engine="vmap", device="cpu")
    party = session.parties[0]
    lrn = RFLearner(num_classes=2, num_trees=3, depth=3, device="cuda")
    party.learner = party.student_learner = lrn
    return party


def test_subprocess_card_request_raises_without_a_card(data):
    """A party whose learner asks for the card raises where there is
    none: in the parent before it spawns, and in a spawned worker that
    is handed such a party directly.  Nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path is "
                    "checked on CPU-only hosts")
    party = _cuda_party(data)
    Xpub = data["X_public"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubprocessTransport(parallelism=1).run_round(
            [party], [prng.PRNGKey(0)], Xpub, len(Xpub), None)
    blob = pickle.dumps((party, prng.PRNGKey(0), Xpub, len(Xpub), None))
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pool.apply(T._subprocess_worker, (blob,))


def test_party_devices_reads_both_learners(data):
    party = _cuda_party(data)
    assert T._party_devices([party]) == {torch.device("cuda")}
    party.student_learner = RFLearner(num_classes=2, device="cpu")
    assert T._party_devices([party]) == {torch.device("cuda"),
                                         torch.device("cpu")}


def test_library_loads_once_across_threads(monkeypatch, tmp_path):
    """build.load from many threads at once opens (and would build) the
    library once: the cache is filled under a lock."""
    from repro_torch.kernels import build
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    opened = []

    def slow_cdll(path):
        opened.append(path)
        time.sleep(0.05)
        return object()
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "lib_path", lambda name: lib)
    monkeypatch.setattr(build.ctypes, "CDLL", slow_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.load("fake"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert opened == [str(lib)]
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counters_are_locked():
    """Every wrapper counts its launches under the shared lock."""
    import inspect
    from repro_torch.kernels import (build, flash_attention, rglru_scan,
                                     tree_hist, vote_aggregate, wkv6)
    for mod in (flash_attention, rglru_scan, tree_hist, vote_aggregate,
                wkv6):
        src = inspect.getsource(mod)
        assert src.count("launches += 1") == 1, mod.__name__
        assert "with build.COUNT_LOCK:\n        launches += 1" in src, \
            mod.__name__
    assert isinstance(build.COUNT_LOCK, type(threading.Lock()))


def test_full_float32_blocks_overlap_across_threads():
    """The TF32/deterministic flags are set by the first block to enter
    and restored by the last to leave, whichever thread it is."""
    from repro_torch import device as D
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        a_in, b_in, a_out = (threading.Event() for _ in range(3))
        seen = {}

        def a():
            with D.full_float32(torch.device("cuda")):
                a_in.set()
                b_in.wait()
            a_out.set()

        def b():
            a_in.wait()
            with D.full_float32(torch.device("cuda")):
                b_in.set()
                a_out.wait()
                seen["inside_after_a_left"] = mm.allow_tf32
            seen["after_both"] = mm.allow_tf32
        ta, tb = threading.Thread(target=a), threading.Thread(target=b)
        ta.start()
        tb.start()
        ta.join()
        tb.join()
        assert seen == {"inside_after_a_left": False, "after_both": True}
    finally:
        mm.allow_tf32 = saved
