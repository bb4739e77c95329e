"""Each test starts with the port's recorder empty, so a reader of it never
reads what an earlier test in the same process recorded."""

import pytest

import gnnbench_cells  # noqa: F401  (puts the repository on the path)


@pytest.fixture(autouse=True)
def _empty_recorder():
    from dgnn_tpu_torch.utils import profiling

    profiling.reset()
    yield
    profiling.reset()
