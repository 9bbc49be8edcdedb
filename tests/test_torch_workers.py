"""PyTorch's CPU threads in a test process: one share of the cores each.

The suite runs under pytest-xdist, several worker processes at once
(``PYTEST_XDIST_WORKER_COUNT``), and every worker collects every test
module. PyTorch's default is one intra-op thread a core in each process,
so six workers on eight cores run ~48 threads, whose waits for each other
cost far more than the small products of these tests gain: the port's
test files took 908 s of wall time so, 364 s with one thread a worker on
the same eight cores (``--durations``, CHANGES.md). Importing this module
lowers the count to the worker's share of the cores, once per process,
before any test runs; a run without workers keeps PyTorch's default.
"""

import os

import torch


def _share() -> int:
    """This process's share of the cores it may run on."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        cores = os.cpu_count() or 1
    return max(1, cores // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


torch.set_num_threads(min(torch.get_num_threads(), _share()))


def test_torch_threads_fit_the_workers():
    assert 1 <= torch.get_num_threads() <= _share()
