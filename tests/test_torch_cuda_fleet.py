"""The fleet on the card (``-m cuda``): rf_L0's rounds (Adult's size,
10 parties, s 2, t 5, 20 trees of depth 6, engine ``vmap``; L0 and L2)
through the thread, socket and subprocess transports against the
in-process card round.  Party threads launch the vote (K1) and
histogram (K2) kernels concurrently, so the launch counters must still
come out exact; spawned workers run their parties on the card in their
own processes, so the parent counts only the server's fits.  Everywhere
else every test here skips.

Tolerance: exact — server labels, vote counts, accuracy, epsilon, every
party's frame digest and wire bytes, and the launch counts.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

PARTIES, S, T, TREES, DEPTH = 10, 2, 5, 20, 6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")


def _round(transport, level="L0", parallelism=None):
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import RFLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    noise = {} if level == "L0" else dict(gamma=0.1, query_fraction=0.2)
    cfg = FedKTConfig(num_parties=PARTIES, num_partitions=S,
                      num_subsets=T, num_classes=2, privacy_level=level,
                      **noise)
    session = FedKTSession(RFLearner(num_classes=2, num_trees=TREES,
                                     depth=DEPTH),
                           tabular_binary(n=48_842, seed=0), cfg,
                           engine="vmap", transport=transport,
                           parallelism=parallelism)
    th.launches = va.launches = 0
    res = session.run()
    return res, (th.launches, va.launches)


def _labels_counts(res):
    (row,) = res.by_domain.values()
    return row["vote"].labels.cpu(), row["vote"].counts.cpu()


# one stacked fit: a K2 launch per level and one for the leaves
PER_FIT = DEPTH + 1
EXPECTED = (PARTIES * 2 * PER_FIT + PER_FIT, PARTIES * S)


@pytest.fixture(scope="module", params=["L0", "L2"])
def serial(cuda, request):
    res, launches = _round("inprocess", request.param)
    assert launches == EXPECTED
    return request.param, res


def _assert_same(got, want):
    for a, b in zip(_labels_counts(got), _labels_counts(want)):
        assert torch.equal(a, b)
    assert got.accuracy == want.accuracy
    assert got.epsilon == want.epsilon
    assert got.meta["frame_sha256"] == want.meta["frame_sha256"]
    assert got.meta["wire_bytes"] == want.meta["wire_bytes"]


@pytest.mark.parametrize("transport,parallelism", [("thread", 5),
                                                   ("thread", 10),
                                                   ("socket", 8)])
def test_threaded_transports_count_launches_exactly(serial, transport,
                                                    parallelism):
    level, want = serial
    got, launches = _round(transport, level, parallelism)
    assert launches == EXPECTED
    _assert_same(got, want)
    assert got.meta["device"].startswith("cuda")


def test_subprocess_workers_run_on_the_card(serial):
    level, want = serial
    got, launches = _round("subprocess", level, parallelism=5)
    # the parties ran in the workers: the parent launched only the
    # server's final fit
    assert launches == (PER_FIT, 0)
    _assert_same(got, want)


def test_kernel_libraries_load_once_across_threads(cuda):
    import threading
    from repro_torch.kernels import build
    build.build(["vote_aggregate", "tree_hist"])
    saved = dict(build._LIBS)
    build._LIBS.clear()
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            build.load("tree_hist"))) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len({id(lib) for lib in got}) == 1
    finally:
        build._LIBS.clear()
        build._LIBS.update(saved)
