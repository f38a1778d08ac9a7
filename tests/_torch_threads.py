"""One torch thread per test process while a port test module runs.

The suite runs under pytest-xdist with several worker processes on the
same cores; each torch process would otherwise spin up one intra-op thread
per core, and the oversubscribed thread pools stall every small op at its
barrier (the port's CPU files ran 2.5x slower so). Import the fixture into
a test module to activate it there; the previous setting is restored
after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
