"""The benchmark's CPU tests run their tiny models on one thread: the suite
runs in several worker processes at once, and torch's default pool of a
thread per core in each of them turns these small operators into waits."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
