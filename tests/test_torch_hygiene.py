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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for name, tpu in (("vote_aggregate", "vote_aggregate.py"),
                      ("tree_hist", "tree_hist.py")):
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
