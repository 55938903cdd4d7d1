"""The port's boundaries: it never imports JAX or the reference package,
its entry points ask for the card by default and raise where there is
none, and CPU work never touches the CUDA build."""
import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as D

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_every_port_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    assert "repro_torch.kernels.ops" in names
    for name in names:
        importlib.import_module(name)


def test_cuda_sources_say_what_they_replace():
    from repro_torch.kernels import build
    for name, tpu in (("vote_aggregate", "vote_aggregate.py"),
                      ("tree_hist", "tree_hist.py"),
                      ("flash_attention", "flash_attention.py"),
                      ("rglru_scan", "rglru_scan.py"),
                      ("wkv6", "wkv6.py")):
        assert name in build.KERNELS
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{tpu}" in text
        assert "bounds it on the H100" in text
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path "
                    "is checked on CPU-only hosts")
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.convert import from_reference
    from repro_torch.core.learners import GBDTLearner, RFLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    assert D.DEFAULT == "cuda"
    assert D.resolve("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve()
    X = np.zeros((8, 3), np.float32)
    y = np.zeros((8,), np.int32)
    for learner in (RFLearner(num_classes=2), GBDTLearner()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            learner.fit(np.zeros(2, np.uint32), X, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedKTSession(RFLearner(num_classes=2), tabular_binary(n=200),
                     FedKTConfig(num_parties=2, num_classes=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference((np.zeros(3),))


def test_serving_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path "
                    "is checked on CPU-only hosts")
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import Engine
    model = Model(get_smoke("phi4-mini-3.8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    params = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--concurrent", "1", "--max-tokens", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--arch", "rwkv6-7b", "--concurrent", "1",
                    "--max-tokens", "1"])


def test_cpu_serve_builds_no_kernel():
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.serving import Engine
    model = Model(get_smoke("gemma2-27b").replace(dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    before = fa.launches
    eng = Engine(model, params, num_slots=2, cache_len=128, device="cpu")
    res = eng.serve([np.arange(70) % 512, np.arange(9)], max_tokens=3)
    assert [r.num_tokens for r in res] == [3, 3]
    assert eng.dispatches["prefill"] == 2
    assert build._LIBS == {}
    assert fa.launches == before


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_cpu_recurrent_serve_builds_no_kernel(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import Model
    from repro_torch.serving import serve_batch
    model = Model(get_smoke(arch))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    before = (fa.launches, rg.launches, wk.launches)
    toks, stats = serve_batch(model, params, np.arange(140).reshape(2, 70)
                              % 512, 3, verbose=False)
    assert toks.shape == (2, 3) and stats["generated"] == 6
    assert build._LIBS == {}
    assert (fa.launches, rg.launches, wk.launches) == before


def test_cpu_round_builds_no_kernel():
    from repro_torch.kernels import build
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import RFLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    before = (th.launches, va.launches)
    res = FedKTSession(RFLearner(num_classes=2, num_trees=2, depth=2),
                       tabular_binary(n=400), FedKTConfig(
                           num_parties=2, num_subsets=2, num_classes=2),
                       engine="vmap", device="cpu").run()
    assert 0.0 <= res.accuracy <= 1.0
    assert res.meta["device"] == "cpu"
    assert build._LIBS == {}
    assert (th.launches, va.launches) == before


def test_nn_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path "
                    "is checked on CPU-only hosts")
    from repro_torch import prng
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.baselines import IterConfig
    from repro_torch.core.learners import NNLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import IterativeStrategy
    from repro_torch.models.smallnets import MLP
    X = np.zeros((8, 3), np.float32)
    y = np.zeros((8,), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NNLearner(MLP(3, 2), num_classes=2).fit(prng.PRNGKey(0), X, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLP(3, 2).init(prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IterativeStrategy(MLP(14, 2), IterConfig(rounds=1)).run(
            tabular_binary(n=200), FedKTConfig(num_parties=2))


def test_cpu_nn_round_builds_no_kernel():
    from repro_torch.configs.base import FedKTConfig
    from repro_torch.core.learners import NNLearner
    from repro_torch.data.synthetic import tabular_binary
    from repro_torch.federation import FedKTSession
    from repro_torch.kernels import build
    from repro_torch.kernels import tree_hist as th
    from repro_torch.kernels import vote_aggregate as va
    from repro_torch.models.smallnets import MLP
    before = (th.launches, va.launches)
    res = FedKTSession(NNLearner(MLP(14, 2, hidden=8), num_classes=2,
                                 steps=5),
                       tabular_binary(n=400), FedKTConfig(
                           num_parties=2, num_subsets=2, num_classes=2,
                           privacy_level="L2", gamma=0.1,
                           query_fraction=0.2),
                       engine="vmap", device="cpu").run()
    assert 0.0 <= res.accuracy <= 1.0
    assert res.meta["device"] == "cpu"
    assert build._LIBS == {}
    assert (th.launches, va.launches) == before
