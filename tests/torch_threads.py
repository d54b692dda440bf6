"""One torch thread for the port's CPU tests.

The tier-1 run puts six pytest workers on one host. Each torch process
starts a pool of as many threads as the host has cores, and an op of the
plain versions then waits on threads that another worker holds: on an
8-core host beside five CPU-bound processes, a rebuild test of
tests/test_torch_db_update.py took 185 s with torch's default threads
and 5 s with one. Each port test module that runs on the CPU imports the
fixture below, which is autouse: the module runs with one torch thread,
and the count is restored after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
