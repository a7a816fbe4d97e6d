"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs under pytest-xdist, several workers on one machine.  By
default PyTorch gives every worker a pool of one thread per core, so the
workers' thread pools oversubscribe the cores many times over, and the
tiny test models, whose ops are far too small to gain from threads, spend
most of their time waiting for a core.  A port test module imports
``one_torch_thread`` (an autouse fixture), which runs that module's tests
on one intra-op thread and restores the pool after them.  The arithmetic
is unchanged: fp32 sums of these sizes run in one thread either way.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
