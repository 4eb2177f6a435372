"""A fixture for the port's training tests on the CPU: one intra-op
thread for torch while a test module runs (module scope, so that the
module's own fixtures run with it too).

At the smoke sizes torch's thread pool gains nothing, and when the CPU is
shared (pytest-xdist's workers, each with JAX's threads beside torch's)
its spinning threads wait on one another at every small op: the port's
end-to-end training test took 160 s with the default pool against 17 s
with one thread beside eight busy processes on an 8-core machine (6.7 s
alone).  The numbers computed are the same functions; only the order of
a parallel reduction's partial sums can change, which every comparison's
stated tolerance already covers.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
