import pytest


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """One intra-op thread a test process: the workers of a parallel run
    share the cores, and torch's thread pools would fight over them."""
    import torch

    torch.set_num_threads(1)
