"""An autouse fixture for the port's nn test files, which import it:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the fits are thousands of tiny ops,
    and torch's thread pool only contends with the other test workers
    for the cores (a round test ran 4x slower beside three others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
