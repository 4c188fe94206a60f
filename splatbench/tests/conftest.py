"""The harness's CPU tests run their PyTorch on one thread (tiny shapes)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
