"""One torch intra-op thread for the port's tests (tests/test_torch_*.py).

The tier-1 run has six xdist workers on the machine's cores, and each
worker's default torch pool takes a thread a core: the pools oversubscribe
the cores, and single tests ran 60-190x slower than alone (ROADMAP.md,
"Torch threads in tests"). A test file imports the fixture it needs:

    from _torch_threads import one_torch_thread          # per test
    from _torch_threads import one_torch_thread_module   # per module

and applies it with ``pytest.mark.usefixtures`` (or ``pytestmark``). Not in
tests/conftest.py, which serves the JAX package's tests too.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """torch.set_num_threads(n) inside the block, the old count after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def one_torch_thread_module():
    with torch_threads(1):
        yield
