"""The port's LM FedKT flow against the JAX reference on the CPU:
``LMLearner`` rounds through ``LMEngine`` and ``LoopEngine`` at L0 and
L2 against the reference's ``fedkt_lm``, pickling, checkpoints carried
across the two packages both ways, and the ``launch/train`` and
``launch/serve --checkpoint`` CLIs.

Tolerances: a round's server labels agree with the reference's on at
least 99 % of tokens (the fits start from inits within 2.5e-7 of each
other and Adam amplifies ulp-level differences, ROADMAP §3), epsilon
is equal (it is a function of the integer vote gaps), and the two
engines of the port give the same labels exactly.  Checkpoints hold
every array exactly.
"""
import dataclasses
import functools
import pickle

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_lm_config
from repro import checkpoint as jcheckpoint
from repro.configs.base import FedKTConfig as JFedKTConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch.train import fedkt_lm as jfedkt_lm
from repro.models import Model as JModel
from repro_torch import checkpoint, convert
from repro_torch.configs.base import FedKTConfig, ModelConfig, TrainConfig
from repro_torch.core.learners import LMLearner
from repro_torch.data import synthetic
from repro_torch.federation import get_engine
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import fedkt_lm
from repro_torch.models import Model
from repro_torch.tree_util import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401

FCFG = dict(num_parties=2, num_partitions=2, num_subsets=2,
            num_classes=64, beta=100.0, seed=0)
TCFG = dict(batch_size=4, seq_len=16, steps=4, learning_rate=3e-3)
LEVELS = {"L0": {}, "L2": dict(privacy_level="L2", gamma=0.1,
                               query_fraction=0.5)}


def port_config(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


@functools.lru_cache(maxsize=None)
def _lm(vocab):
    """(reference model, port model, token splits) at ``tiny_lm_config``'s
    widths over ``vocab`` tokens."""
    jcfg = tiny_lm_config(vocab_size=vocab)
    data = synthetic.tokens(n_seqs=64, seq_len=17, vocab=vocab, seed=0)
    return JModel(jcfg), Model(port_config(jcfg)), data


@pytest.fixture(scope="module")
def lm():
    return _lm(64)


def _labels(res):
    (row,) = res.by_domain.values()
    return np.asarray(row["labels"])


@functools.lru_cache(maxsize=None)
def _reference_round(vocab, level, transport="inprocess"):
    jm, _, d = _lm(vocab)
    par = 2 if transport == "thread" else None
    return jfedkt_lm(jm, d["train"], d["public"],
                     JFedKTConfig(**dict(FCFG, num_classes=vocab),
                                  **LEVELS[level]),
                     JTrainConfig(**TCFG), test=d["test"], engine="lm",
                     transport=transport, parallelism=par,
                     verbose=False)["result"]


@functools.lru_cache(maxsize=None)
def _port_round(vocab, level, engine="lm", transport="inprocess"):
    _, model, d = _lm(vocab)
    fcfg = FedKTConfig(**dict(FCFG, num_classes=vocab), **LEVELS[level])
    par = 2 if transport == "thread" else None
    return fedkt_lm(model, d["train"], d["public"], fcfg,
                    TrainConfig(**TCFG), test=d["test"], engine=engine,
                    transport=transport, parallelism=par, verbose=False,
                    device="cpu")["result"]


def assert_same_lm_round(got, want):
    """Port against port, bit for bit (``chip_smoke.same_lm_round``): the
    server's labels, counts and gaps, every student and final-model
    leaf, accuracy, epsilon, wire bytes and frame digests."""
    import chip_smoke
    chip_smoke.same_lm_round("port round", got, want)
    assert got.meta["engine"] == want.meta["engine"]


# at vocabulary 4096 (over 2048) an L0 round's teacher votes take the
# sort path (no vocabulary-sized histogram) and the server's consistent
# vote sums (T, 4096) one-hot counts, in both packages.  The thread
# cases fan the two parties out over ``ThreadTransport(parallelism=2)``
# in both packages: the reference requires its thread round to equal its
# in-process round bit for bit (test_federation_lm.py), and so does the
# port.  The in-process cases keep their names
ROUND_CASES = [
    pytest.param(level, vocab, transport,
                 id="-".join([level] + ([] if vocab == 64
                                        else [f"vocab{vocab}"])
                             + ([] if transport == "inprocess"
                                else [transport])))
    for transport in ("inprocess", "thread") for vocab in (64, 4096)
    for level in sorted(LEVELS)]


@pytest.mark.parametrize("level,vocab,transport", ROUND_CASES)
def test_lm_rounds_match_reference(level, vocab, transport):
    want = _reference_round(vocab, level, transport)
    if transport == "inprocess":
        got = {engine: _port_round(vocab, level, engine)
               for engine in ("lm", "loop")}
        np.testing.assert_array_equal(_labels(got["lm"]),
                                      _labels(got["loop"]))
    else:
        got = {"lm": _port_round(vocab, level, "lm", transport)}
        assert got["lm"].meta["transport"] == transport
        assert got["lm"].meta["parallelism"] == 2
        assert_same_lm_round(got["lm"], _port_round(vocab, level))
    for res in got.values():
        assert (_labels(res) == _labels(want)).mean() >= 0.99
        assert res.epsilon == want.epsilon
        assert res.meta["engine"] in ("lm", "loop")
        assert 0.0 <= res.accuracy <= 1.0
    if level == "L0":
        assert want.epsilon is None
    else:
        assert want.epsilon > 0


def test_party_releases_its_teachers_before_its_students_fit(lm):
    """A party holds its teachers only until they have voted: by its
    first student fit no teacher's state is alive, so at LM scale the
    students fit beside no teacher (``chip_smoke.fedkt_party_price``)."""
    import gc
    import weakref

    from repro_torch.federation.engines import LMEngine
    _, model, d = lm
    alive = []

    class Watching(LMEngine):
        def fit_teachers(self, keys, learner, datasets):
            bank = super().fit_teachers(keys, learner, datasets)
            self.refs = [weakref.ref(t) for m in bank
                         for t in flatten_tree(m).values()]
            return bank

        def fit_students(self, keys, learner, X, labelsets):
            gc.collect()
            alive.append(sum(r() is not None for r in self.refs))
            return super().fit_students(keys, learner, X, labelsets)

    res = fedkt_lm(model, d["train"], d["public"], FedKTConfig(**FCFG),
                   TrainConfig(**TCFG), test=d["test"], engine=Watching(),
                   verbose=False, device="cpu")["result"]
    assert alive == [0] * FCFG["num_parties"]
    assert_same_lm_round(res, _port_round(64, "L0"))


def test_engine_registry_includes_lm():
    assert get_engine("lm").name == "lm"
    with pytest.raises(TypeError, match="LM learner"):
        get_engine("lm").fit_teachers([], object(), [])


def test_lm_learner_pickles_after_use(lm):
    _, model, d = lm
    learner = LMLearner(model, TrainConfig(**TCFG), device="cpu")
    state = learner.fit(None, d["train"][:8])
    learner.vote_members([state, state], d["public"][:2])
    back = pickle.loads(pickle.dumps(learner))
    assert back.tcfg == learner.tcfg and back.device == "cpu"
    np.testing.assert_array_equal(back.predict(state, d["public"][:2]),
                                  learner.predict(state, d["public"][:2]))


def test_checkpoints_cross_packages(lm, tmp_path):
    jm, model, d = lm
    cfg = model.cfg
    jp = jm.init(jax.random.PRNGKey(4))
    # reference -> port
    jcheckpoint.save(str(tmp_path / "ref"), jp, step=3,
                     metrics={"loss": 1.5})
    tree = convert.lm_tree_from_reference(cfg, checkpoint.load(
        str(tmp_path / "ref")), "cpu")
    want = convert.lm_tree_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                          "cpu")
    for name, t in flatten_tree(tree).items():
        assert torch.equal(t, flatten_tree(want)[name]), name
    assert checkpoint.manifest(str(tmp_path / "ref")) == \
        jcheckpoint.manifest(str(tmp_path / "ref"))
    # port (trained) -> reference
    state = LMLearner(model, TrainConfig(**TCFG), device="cpu").fit(
        None, d["train"][:8])
    checkpoint.save(str(tmp_path / "port"),
                    convert.lm_params_to_reference(cfg, state), step=4)
    back = jcheckpoint.restore(str(tmp_path / "port"), jp)
    got = jcheckpoint.flatten_tree(jax.tree.map(np.asarray, back))
    for name, a in convert.lm_params_to_reference(cfg, state).items():
        np.testing.assert_array_equal(got[name], a)
    assert checkpoint.manifest(str(tmp_path / "port"))["leaves"] == \
        sorted(got)
    # any tree saves and restores into its own structure
    checkpoint.save(str(tmp_path / "tree"), state)
    again = checkpoint.restore(str(tmp_path / "tree"), state)
    for name, t in flatten_tree(again).items():
        assert torch.equal(t, flatten_tree(state)[name]), name


def test_train_and_serve_clis_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "phi")
    out = train_cli.main(["--device", "cpu", "--smoke", "--steps", "3",
                          "--batch-size", "2", "--seq-len", "16",
                          "--checkpoint", ck])
    assert np.isfinite(out["test_loss"])
    assert checkpoint.manifest(ck)["metrics"]["test_loss"] == \
        out["test_loss"]
    args = ["--device", "cpu", "--smoke", "--concurrent", "3",
            "--max-tokens", "4", "--prompt-len", "8"]
    served = serve_cli.main(args + ["--checkpoint", ck])
    assert "tok/s" in capsys.readouterr().out
    # the same parameters served from memory give the same streams (the
    # CLI's prompts: lengths, then tokens, from default_rng(--seed 0))
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import to_module
    from repro_torch.serving import Engine
    model = Model(get_smoke("phi4-mini-3.8b"))
    eng = Engine(model, to_module(model.cfg, out["params"]), num_slots=4,
                 cache_len=256, device="cpu")
    rng = np.random.default_rng(0)
    for n in rng.integers(1, 9, 3):
        eng.submit(rng.integers(0, model.cfg.vocab_size, (int(n),))
                   .astype(np.int32), 4)
    assert [r.tokens for r in eng.run()] == [r.tokens for r in served]


def test_fedkt_cli_on_cpu():
    out = train_cli.main(["--device", "cpu", "--smoke", "--fedkt",
                          "--steps", "2", "--batch-size", "2",
                          "--seq-len", "8"])
    assert np.isfinite(out["test_loss"])
    assert out["result"].meta["engine"] == "lm"


@pytest.mark.parametrize("level,gamma", [("L0", 0.0), ("L2", 0.1)])
def test_chip_smoke_fedkt_cut_checks_on_cpu(level, gamma):
    """chip_smoke's lm_fedkt_cut pieces on the CPU, at phi4-mini's smoke
    widths over 4096 tokens (float32): the CLI's round recorded by
    ``RecordingLMEngine`` gives the labels, counts, accuracy, epsilon,
    wire bytes and frame digests of an ``LMEngine`` round, and
    ``fedkt_round_checks`` finds every recorded vote, the server's
    counts and labels, epsilon and the wire bytes equal to their
    recomputation and to ``codec.lm_protocol_bytes``' price."""
    import chip_smoke
    from repro_torch.configs import get_smoke
    cfg = get_smoke("phi4-mini-3.8b").replace(vocab_size=4096,
                                              dtype="float32")
    model = Model(cfg)
    fcfg, tcfg, data = chip_smoke.fedkt_round_inputs(
        cfg, level, gamma, B=4, S=16, steps=2, lr=3e-3, n_seqs=64)
    rec = chip_smoke.RecordingLMEngine()
    got, want = (fedkt_lm(model, data["train"], data["public"], fcfg, tcfg,
                          test=data["test"], engine=engine, verbose=False,
                          device="cpu")["result"]
                 for engine in (rec, "lm"))
    np.testing.assert_array_equal(_labels(got), _labels(want))
    (g,), (w,) = got.by_domain.values(), want.by_domain.values()
    assert torch.equal(g["vote"].counts, w["vote"].counts)
    assert got.epsilon == want.epsilon and got.accuracy == want.accuracy
    for key in ("wire_bytes", "frame_sha256", "engine"):
        assert got.meta[key] == want.meta[key], key
    n, s, t = fcfg.num_parties, fcfg.num_partitions, fcfg.num_subsets
    T = len(data["public"]) * tcfg.seq_len
    assert [tuple(v["preds"].shape) for v in rec.votes] == [(t, T)] * n * s
    assert [tuple(p.shape) for p in rec.student_preds] == [(s, T)] * n
    row = chip_smoke.fedkt_round_checks(rec, got, model, fcfg, tcfg, data,
                                        "cpu")
    assert row["party_votes"] == n * s and row["k1_identical"] == 0
    assert row["server_tokens"] == T and row["epsilon"] == got.epsilon
    assert (row["epsilon"] is None) == (level == "L0")
    priced = row["protocol_per_member"]
    assert got.meta["wire_bytes"]["updates_payload"] == \
        n * s * priced["update_payload_bytes_per_member"]
    # a tampered recording is caught
    rec.votes[0]["labels"][0] += 1
    with pytest.raises(AssertionError, match="party vote 0"):
        chip_smoke.fedkt_round_checks(rec, got, model, fcfg, tcfg, data,
                                      "cpu")


def test_chip_smoke_threads_depth_prices_what_is_alive(monkeypatch):
    """chip_smoke picks the thread round's depth as the deepest phi4-mini
    cut whose two parties price within 72 GB less the margin and what
    is alive on the card; with too much alive no depth fits."""
    import chip_smoke
    fcfg = chip_smoke.fedkt_round_inputs(chip_smoke.fedkt_cut_config(1),
                                         "L0", 0.0)[0]

    def price(layers):
        return fcfg.num_parties * chip_smoke.fedkt_party_price(
            chip_smoke.fedkt_cut_config(layers), fcfg)["price"]

    monkeypatch.setattr(chip_smoke, "_alive", lambda: 0)
    layers, room = chip_smoke.fedkt_threads_layers()
    assert room == chip_smoke.FEDKT_CUT_PEAK_LIMIT - \
        chip_smoke.FEDKT_THREADS_MARGIN
    assert price(layers) <= room < price(layers + 1)
    alive = room - price(1) + 1
    monkeypatch.setattr(chip_smoke, "_alive", lambda: alive)
    with pytest.raises(AssertionError, match="price over"):
        chip_smoke.fedkt_threads_layers()


def test_chip_smoke_fedkt_threads_on_cpu(capsys):
    """chip_smoke's ``lm_fedkt_threads`` rehearsed on the CPU at
    phi4-mini's smoke widths over 4096 tokens (float32): the round over
    two party threads equals the recorded, checked in-process round of
    ``lm_fedkt_cut`` bit for bit, each party on its own thread, and a
    leaf of the in-process students changed by one bit is caught."""
    import json

    import chip_smoke
    from repro_torch.configs import get_smoke
    cfg = get_smoke("phi4-mini-3.8b").replace(vocab_size=4096,
                                              dtype="float32")
    inputs = dict(B=4, S=16, steps=2, lr=3e-3, n_seqs=64)
    _, k1, inprocess = chip_smoke.lm_fedkt_cut(
        None, "L0", 0.0, cfg=cfg, keep=True, device="cpu", **inputs)
    assert k1 is None and inprocess.meta["round_wall_s"] > 0
    counts = chip_smoke.lm_fedkt_threads(None, inprocess, cfg,
                                         device="cpu", **inputs)
    assert not any(counts.values())     # the plain versions, no launch
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[lm-fedkt-threads] "))
    row = json.loads(line.split(" ", 1)[1])
    assert row["transport"] == "thread" and row["parallelism"] == 2
    spans = row["party_threads"]
    assert sorted(spans) == ["fedkt-party_0", "fedkt-party_1"]
    assert all(0 <= sp["start_s"] < sp["end_s"] <= row["round_wall_s"]
               for sp in spans.values())
    assert row["host_peak_bytes"] > 0 and row["price_two_parties_bytes"] \
        == 2 * row["price_a_party_bytes"]
    leaf = flatten_tree(inprocess.student_states[1][0])["blocks/0/attn/wq"]
    leaf.view(np.int32).reshape(-1)[0] ^= 1
    with pytest.raises(AssertionError, match="blocks/0/attn/wq differs"):
        chip_smoke.lm_fedkt_threads(None, inprocess, cfg, device="cpu",
                                    **inputs)
