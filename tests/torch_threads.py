"""One torch intra-op thread for a test module's duration.

Under ``-p xdist -n 6`` on an eight-core machine, torch's default of one
intra-op thread per core gives every worker eight spinning threads: the
port's small-shape parity tests then ran about four times slower than
with one thread each (tests/test_torch_topk.py and its siblings: 198 s
against 53 s on the CPU). A module that imports ``one_torch_thread``
runs on one thread and restores the worker's count when it ends, so the
other modules of the worker keep theirs.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
