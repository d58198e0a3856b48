"""The port's test files' shared one-thread policy; each imports it with
``from torch_threads import _one_thread``, and an imported autouse fixture
applies to the importing module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the whole module (its module fixtures too, so
    results compared bitwise are made alike): the suite runs files in
    parallel workers, and small ops on eight threads a worker oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
