"""``one_thread``: a module fixture that runs torch on one thread and gives
the worker its count back after. The tier-1 run puts several test
processes on the cores at once, where torch's OpenMP threads in each wait
on each other: one lrcn CLI test took 203 s with torch's default thread
count against 15 s with one thread, the video ResNets' module 235 s against
97 s, the TSM-ResNet's 228 s against 48 s in a whole run. A test module
takes it with ``from torch_threads import one_thread``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
