"""One CPU thread for PyTorch while a port test module runs.

The suite runs several pytest workers side by side, and each PyTorch
process would otherwise start one OpenMP thread per core: the spinning
pools oversubscribe the machine and slow every worker many times over (a
2-second port encode took minutes).  The port's CPU tests are small, so
they lose nothing with one thread.  (The bits of the 1024- and 4096-deep
float32 products do depend on the thread count; the parity tests hold at
one thread, which is what every port test module now runs with.)  A port
test module takes the fixture
with `from tests.test_torch_threads import single_torch_thread`; the old
count comes back when the module is done, so other modules of the same
worker are not touched.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_fixture_sets_one_thread():
    assert torch.get_num_threads() == 1
