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


@pytest.fixture(scope="module")
def lm():
    jcfg = tiny_lm_config()
    data = synthetic.tokens(n_seqs=64, seq_len=17, vocab=64, seed=0)
    return JModel(jcfg), Model(port_config(jcfg)), data


def _labels(res):
    (row,) = res.by_domain.values()
    return np.asarray(row["labels"])


@pytest.fixture(scope="module")
def reference_rounds(lm):
    jm, _, d = lm
    return {level: jfedkt_lm(jm, d["train"], d["public"],
                             JFedKTConfig(**FCFG, **kw),
                             JTrainConfig(**TCFG), test=d["test"],
                             engine="lm", verbose=False)["result"]
            for level, kw in LEVELS.items()}


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_lm_rounds_match_reference(lm, reference_rounds, level):
    _, model, d = lm
    want = reference_rounds[level]
    got = {engine: fedkt_lm(model, d["train"], d["public"],
                            FedKTConfig(**FCFG, **LEVELS[level]),
                            TrainConfig(**TCFG), test=d["test"],
                            engine=engine, verbose=False,
                            device="cpu")["result"]
           for engine in ("lm", "loop")}
    np.testing.assert_array_equal(_labels(got["lm"]), _labels(got["loop"]))
    for res in got.values():
        assert (_labels(res) == _labels(want)).mean() >= 0.99
        assert res.epsilon == want.epsilon
        assert res.meta["engine"] in ("lm", "loop")
        assert 0.0 <= res.accuracy <= 1.0
    if level == "L0":
        assert want.epsilon is None
    else:
        assert want.epsilon > 0


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
