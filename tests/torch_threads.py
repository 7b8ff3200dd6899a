"""One intra-op thread for the port's heavier CPU tests.

The tier-1 run puts six pytest workers on the machine's cores. A torch
process sizes its thread pool to every core, so six of them running
convolutions at once oversubscribe the CPU many times over and each runs
far slower than alone. Test modules that import :func:`one_torch_thread`
run with one torch thread, and the previous count comes back after them.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
