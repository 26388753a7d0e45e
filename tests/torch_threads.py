"""The PyTorch port's test modules compute on two CPU threads, the
processes they start on one.

Every ``tests/test_torch_*.py`` imports ``port_threads``, a module-scoped
autouse fixture: it sets the cap when the module's first test starts and
puts the worker's own settings back after its last, so a test file that
runs later on the same pytest worker, and every process that file
starts, sees the worker as it was. The tier-1 suite runs six pytest
workers on an 8-CPU box, JAX tests beside the port's; at PyTorch's
default (one thread per CPU) each worker's parallel regions, and the
ranks, servers and import checks the port's tests start, oversubscribe
the box. In the port's modules the cap is two: one thread changes the
summation order enough that a zero-gradient leaf's rounding noise
crosses a parity test's absolute floor (``test_torch_ernie.py``). The
processes the tests start (``OMP_NUM_THREADS``, which PyTorch reads when
it starts) take one.
"""

import os

import pytest
import torch

THREADS, CHILD_THREADS = 2, 1


@pytest.fixture(scope="module", autouse=True)
def port_threads():
    threads = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(CHILD_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
