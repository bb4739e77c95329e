"""Caps torch's intra-op CPU threads in a test process.

The test suite runs in several pytest-xdist workers at once, and torch
starts one intra-op thread a core in each of them, so six workers on eight
cores run 48 threads: a trainer test that takes 6 s alone then takes
minutes.  Every ``tests/test_torch_*.py`` imports this module before its
first torch work, which gives each worker its share of the cores: the
cores this process may run on, divided by ``PYTEST_XDIST_WORKER_COUNT``
(1 outside xdist), at least one.  It changes no result a test checks, only
how many threads compute it.
"""

import os

import torch

__all__ = ["worker_threads"]


def worker_threads() -> int:
    """This worker's share of the cores, at least 1."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


torch.set_num_threads(worker_threads())
