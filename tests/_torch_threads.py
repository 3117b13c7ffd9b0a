"""The two-thread module fixture of the port's heavier parity tests.

A test file activates it by importing it (``from _torch_threads import
two_torch_threads``): pytest then finds the autouse fixture among the
module's names.  The whole suite runs in six worker processes at once
(``-n 6``), and with torch's default of one thread per core in each, a
thread team per op on every core of a shared machine waits on
descheduled threads.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for the importing module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
