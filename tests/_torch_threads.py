"""Each test process's share of the CPU for torch's intra-op threads.

torch starts one intra-op thread per core in every process. Under
pytest-xdist every worker does so on the same cores, and the reduced models'
small tensor ops then wait on each other's threads: a test file of the port
took 30 to 90 times its one-process time under ``-n 5`` on 8 cores
(``tests/test_torch_experiments.py::test_lm_runner_path[falcon-mamba-7b]``
2.1 s alone, 194 s beside four other workers). A test module that imports
``cpu_share`` gives torch ``cores // workers`` threads (at least one) while
its tests run and puts the count back after; one process alone keeps them
all. The numbers the tests compare are the same functions on the same
inputs; only the split of a product's rows over threads changes.
"""
import os

import pytest
import torch


def fair_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def cpu_share():
    before = torch.get_num_threads()
    torch.set_num_threads(fair_threads())
    yield
    torch.set_num_threads(before)
