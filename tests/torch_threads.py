"""A module fixture for the port's CPU test files.

`from torch_threads import one_thread` in a test module holds torch to one
intra-op thread while that module's tests run: their tensors are small,
and beside the other pytest-xdist workers on the same cores more threads
only contend (six of the port's heaviest test files took 1804
worker-seconds with eight threads each and 762 with one, on six workers
over eight CPU cores).
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
