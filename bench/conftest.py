"""The harness's tests run whole cells on the CPU inside windows of a few
seconds, while other test workers run theirs beside them. With torch's
default of one intra-op thread per core in every worker, the threads
outnumber the cores many times over and a step can take a second, leaving
a window almost empty. One thread per test keeps the windows full."""
import pytest


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")
