"""Module-scoped autouse fixture for the port's CPU tests: torch's CPU
thread pool is held to two threads while a test module runs.  Tier-1
runs six test files at once on a few cores; a torch process otherwise
starts one thread per core, and the pools oversubscribe the cores (the
port's checkpoint CLI test took 14 s alone and 1,411 s beside the other
files)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
