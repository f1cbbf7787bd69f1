"""One PyTorch CPU thread for each of the port's test modules.

The tier-1 command runs the tests in 6 pytest-xdist workers on an
8-core machine, beside the JAX package's tests and the modules' own
JAX subprocesses.  At PyTorch's default of one intra-op thread per core,
6 copies of tests/test_torch_split.py run at once took 106 s, with one
thread each 67 s: the port's CPU renders are many small operations, and
the spinning OpenMP threads of 6 processes crowd each other and the JAX
workers out.  Each module imports ``one_cpu_thread`` (an autouse fixture)
and runs on one thread; the count is restored after the module.  Serially
a module can take longer (a multi-view fit at 96^2 took 30 s on one
thread and 22.5 s on eight).
"""
import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
