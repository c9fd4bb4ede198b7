"""One torch thread for a module of the port's CPU tests.

Import the fixture into a test module (``from torch_threads import
one_torch_thread  # noqa: F401``): the port's CPU tests run many small ops
(strata, time loops, scan levels), and with one thread each op skips its
pool's wake-ups, which the suite's parallel workers, sharing the cores,
make costly.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
