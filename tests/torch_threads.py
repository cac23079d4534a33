"""The port's test files run torch on one intra-op thread.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse fixture, so it applies to that file's tests (not a test file
itself).  The port's tests run many small ops: beside the suite's other
workers, intra-op threads only contend for the cores, and one thread is
faster here even alone.  The thread count is restored after the module.
Subprocesses that run the port get ``OMP_NUM_THREADS=1`` through
:func:`one_thread_env`.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_thread_env(**kw) -> dict:
    """``os.environ`` with ``OMP_NUM_THREADS=1`` and ``kw``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **kw)
