"""torch's CPU threads in the test suite's pytest-xdist workers.

The suite's run spreads the test files over several worker processes on
one machine; each one's OpenMP pool then takes every core, and the pools'
spinning threads starve each other: six processes of
``test_torch_port_remat.py``'s eight remat cases, 23 s each with one
thread, did not end in 600 s with the default.  Importing this module caps
torch at one thread in a worker (``PYTEST_XDIST_WORKER`` set); every
worker imports every test module when it collects the suite, and
``test_torch_port_package.py`` imports this one, so the cap holds for the
whole run.  A run without xdist keeps torch's default.

A thread count changes how torch splits a reduction, so the last digits
of a float32 sum.  The modules whose measured tolerances were read with
the default count take :func:`default_threads` for their own tests.
"""
import os

import pytest
import torch

DEFAULT = torch.get_num_threads()
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def default_threads():
    """torch's default thread count while the module's tests run."""
    capped = torch.get_num_threads()
    torch.set_num_threads(DEFAULT)
    yield
    torch.set_num_threads(capped)
