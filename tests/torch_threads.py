"""One torch intra-op thread for the module that imports the fixture.

Every ``tests/test_torch_*.py`` imports it by name::

    from .torch_threads import one_intra_op_thread  # noqa: F401

and pytest then applies it to that module alone.  Under pytest-xdist
several test processes share the cores; with a thread a core each, the
port's many small CPU ops wait on the pool's spinning threads in the other
processes.  This module imports nothing but pytest and torch: the card's
host runs the port's tests with ``--noconftest`` and without JAX.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_intra_op_thread():
    """One torch intra-op thread while the module runs; the count it found
    is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
