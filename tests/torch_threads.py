"""One torch intra-op thread for each of the port's CPU tests.

The port's CPU tests run under pytest-xdist with several workers.
torch's default of one OpenMP thread per core in each of them puts
several threads on every core, and its small CPU products (the sparse
CSR ``torch.mv`` of kernel row 9's plain version above all) then spend
most of their time waiting on one another's threads. Every
``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an autouse
fixture of module scope, so its tests and its module fixtures (a
module's trained models) run with one intra-op thread, and the setting
is given back after its last test; no other test file sees it. torch's thread
setting is per thread: a thread the code under test starts (the serving
front-end's dispatch thread) keeps the default.

The files import it as ``torch_threads``: pytest puts ``tests/`` on
the path of every test file it imports, whatever else provides a
``tests`` package.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
