"""Fixtures shared by the port's CPU tests. Imports neither JAX nor the JAX
package.

A test module takes a fixture by importing its name::

    from torch_fixtures import one_intra_op_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Runs the module's tests with PyTorch on one intra-op thread, and puts
    the count back after. The test suite runs in several worker processes
    on one machine; with each worker's PyTorch on every core the threads
    oversubscribe the cores and a test that takes a fraction of a second
    alone takes minutes (the spawned ranks of the mesh tests pin
    themselves the same way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
