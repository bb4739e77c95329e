"""The plain references against the port's plain CPU path, at a tiny
size, for both configurations: in float32 with no hub block they agree to
float32 rounding; with the hub block (its products in bf16, as the port
runs it) every cell's run is correct under the cell's own limits; and the
control, the reference in the precision one step below the cell's, reads
apart from the program."""

import pytest

import gnnbench_cells
from gnnbench import check, graphs, harness
from gnnbench.reference.common import Edges

CELLS = [w["name"] for w in gnnbench_cells.SPEC["workloads"]]


@pytest.fixture(scope="module")
def float32_bench(tmp_path_factory):
    return gnnbench_cells.tiny_bench(tmp_path_factory.mktemp("f32"),
                                     dense=None, gather_dtype="float32")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return gnnbench_cells.tiny_bench(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", CELLS)
def test_float32_agrees(float32_bench, cell):
    r = gnnbench_cells.run(float32_bench, cell)
    for k, v in r["checks"].items():
        assert v["value"] < 2e-5, (k, v)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_under_its_limits(bench, cell):
    r = gnnbench_cells.run(bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_apart(bench, cell):
    """The control, the reference one precision step below the cell's in
    the program's place: on the same seed it reads at least three times
    what the program reads on one number or more; where the test's graph
    is the cell's own (the citation graph), it fails the cell's limits."""
    c = bench.cell(cell)
    data = graphs.load_csr(c.traffic, bench.folder / ".cache", print)
    seed = 3
    prog = gnnbench_cells.run(bench, cell, seed=seed)["checks"]
    inputs = harness.make_inputs(c, data, seed, "cpu")
    edges = Edges(data.row_ptr, data.col_ind, "cpu")
    ref = harness.reference_side(c, data, inputs, edges)
    lowp = harness.reference_side(c, data, inputs, edges,
                                  lowp=c.traffic["control"])
    nums = harness.numbers(c, inputs, lowp, ref)
    assert any(nums[k] >= 3 * v["value"] for k, v in prog.items()), (
        nums, prog)
    if not gnnbench_cells.TINY[c.traffic["generator"]]:
        assert not check.judge(nums, c.limits), nums
