"""One PyTorch thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on a few cores, and
PyTorch's default of one intra-op thread per core then oversubscribes the
machine: a 4-frame 64x64 clip synthesis took 103 s beside six busy
processes with 8 threads and 7 s with one (1.2 s and 1.3 s on an idle
machine). Each port test module takes this fixture, which sets one thread
for the module and restores the count after it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
