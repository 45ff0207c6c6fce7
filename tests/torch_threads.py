"""The worker's share of the host's cores for the port's test modules.

The Tier-1 command runs the suite in several pytest-xdist worker
processes on one host (``-n 6``).  torch sizes its intra-op thread pool
to all of the host's cores in each of them, and its threads spin while
they wait, so six pools of eight threads fight over eight cores and a
small forward on the CPU takes many times longer than it does alone.
Each port test module imports :func:`worker_threads`, an autouse fixture
that gives torch (and, through ``OMP_NUM_THREADS``, the processes the
module starts) the worker's share of the cores while the module runs,
and restores both after it.  A run without workers is left as it is.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def worker_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    share = max(1, (os.cpu_count() or 1) // workers)
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(share)
    os.environ["OMP_NUM_THREADS"] = str(share)
    try:
        yield
    finally:
        torch.set_num_threads(before)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
