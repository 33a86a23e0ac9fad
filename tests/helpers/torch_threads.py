"""A module fixture for the port's CPU tests: one torch intra-op thread
while the module runs, the previous count restored after it.

The tests run small tensors, and the suite runs in several worker
processes at once: there torch's default thread pool (one thread a core,
in every worker) only contends for the cores, and a module of small
pipeline runs took up to 100x its time alone. One thread is as fast
alone, and does not slow the other workers."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
