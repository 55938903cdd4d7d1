"""``NNLearner`` on the card: full float32 whatever the caller set, the
same bits run to run, and agreement with the CPU.

Run on a GPU host with
``python -m pytest -m cuda tests/test_torch_cuda_nn.py``; elsewhere
every test here skips (decided in a fixture, at run time).
Tolerances: a card fit and a CPU fit (the MLP at the reference's
defaults, hidden 64 and 300 steps; PaperCNN 60 steps) predict >= 99 %
equal labels (cuBLAS and the CPU round otherwise, and Adam amplifies
it), and the card's fit must have learned (every class among its
labels, accuracy over a floor: 0.75 for the MLP, whose CPU fit reaches
0.876; 0.5 for the CNN, 0.73), or equal labels would say little; two
card fits at one key are bit-identical, also with TF32 switched on
globally; a stacked fit's members are within 1e-5 of their serial fits
after 5 steps; an nn round launches K1 once a (party, partition) and K2
never, and its server labels agree >= 99 % with the CPU round's (the
MLP at the reference's defaults; both classes among the card's labels,
accuracy over 0.65: the CPU round reaches 0.724).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


def _learner(kind, steps=60, device="cuda"):
    from repro_torch.core.learners import NNLearner
    from repro_torch.models.smallnets import MLP, PaperCNN
    if kind == "mlp":
        return NNLearner(MLP(14, 2, hidden=16), num_classes=2, steps=steps,
                         device=device)
    return NNLearner(PaperCNN(16, 1, 10), num_classes=10, steps=steps,
                     device=device)


def _trained(kind, device="cuda"):
    """A learner that learns at ``_data``'s size: the MLP at the
    reference's defaults (hidden 64, 300 steps), PaperCNN at 60 steps."""
    from repro_torch.core.learners import NNLearner
    from repro_torch.models.smallnets import MLP
    if kind == "mlp":
        return NNLearner(MLP(14, 2), num_classes=2, device=device)
    return _learner(kind, device=device)


def _data(kind):
    from repro_torch.data.synthetic import digits, tabular_binary
    return (tabular_binary(n=2000, seed=0) if kind == "mlp"
            else digits(n=800, image_size=16, seed=0))


def _bits(tree):
    from repro_torch.tree_util import flatten_tree
    return {p: t.cpu().view(torch.int32) for p, t in
            flatten_tree(tree).items()}


def _same_bits(a, b):
    a, b = _bits(a), _bits(b)
    return list(a) == list(b) and all(torch.equal(a[p], b[p]) for p in a)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_card_fit_agrees_with_cpu_fit(cuda, kind):
    from repro_torch import prng
    d = _data(kind)
    key = prng.PRNGKey(5)
    card = _trained(kind)
    cpu = _trained(kind, device="cpu")
    a = card.predict(card.fit(key, d["X_train"], d["y_train"]),
                     d["X_public"])
    b = cpu.predict(cpu.fit(key, d["X_train"], d["y_train"]),
                    d["X_public"])
    assert a.device.type == "cuda" and a.dtype == torch.int32
    a = a.cpu().numpy()
    assert len(np.unique(a)) == card.num_classes
    assert (a == d["y_public"]).mean() > (0.75 if kind == "mlp" else 0.5)
    assert (a == b.numpy()).mean() >= 0.99


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_two_card_fits_are_bit_identical(cuda, kind):
    from repro_torch import prng
    d = _data(kind)
    learner = _learner(kind)
    key = prng.PRNGKey(7)
    a = learner.fit(key, d["X_train"], d["y_train"])
    b = learner.fit(key, d["X_train"], d["y_train"])
    assert _same_bits(a, b)


def test_cnn_fit_pins_float32_whatever_the_caller_set(cuda):
    """TF32 switched on globally gives the same bits as switched off:
    the learner pins full float32 and deterministic cuDNN for its own
    fit, and the caller's flags come back afterwards."""
    from repro_torch import prng
    d = _data("cnn")
    learner = _learner("cnn", steps=30)
    key = prng.PRNGKey(2)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = learner.fit(key, d["X_train"], d["y_train"])
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        off = learner.fit(key, d["X_train"], d["y_train"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert _same_bits(on, off)


def test_fit_stacked_equals_serial_fits_on_card(cuda):
    from repro_torch import prng
    d = _data("mlp")
    learner = _learner("mlp", steps=5)
    X, y = d["X_train"], d["y_train"]
    sets = [(X[:300], y[:300]), (X[300:600], y[300:600]),
            (X[600:857], y[600:857])]
    keys = prng.split(prng.PRNGKey(9), 3)
    stacked = learner.fit_stacked(keys, [a for a, _ in sets],
                                  [b for _, b in sets])
    for i, (Xi, yi) in enumerate(sets):
        serial = learner.fit(keys[i], Xi, yi)
        for name, layer in serial.items():
            for leaf, t in layer.items():
                torch.testing.assert_close(stacked[name][leaf][i], t,
                                           rtol=0, atol=1e-5)


def test_nn_round_on_card_agrees_with_cpu(cuda):
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    d = _data("mlp")
    cfg = FedKTConfig(num_parties=3, num_subsets=2, num_classes=2,
                      privacy_level="L2", gamma=0.1, query_fraction=0.2)
    th.launches = va.launches = 0
    card = FedKTSession(_trained("mlp"), d, cfg, engine="vmap").run()
    assert (th.launches, va.launches) == (0, 3 * 2)
    cpu = FedKTSession(_trained("mlp"), d, cfg, engine="vmap",
                       device="cpu").run()
    (lc,), (lp,) = ([r["labels"] for r in res.by_domain.values()]
                    for res in (card, cpu))
    assert len(np.unique(lc)) == 2 and card.accuracy > 0.65
    assert (lc == lp).mean() >= 0.99
    assert abs(card.accuracy - cpu.accuracy) <= 0.01
    assert np.isfinite(card.epsilon)
