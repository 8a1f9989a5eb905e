"""The control of each cell on the card: the plain reference put in the
program's place and computed one precision lower (TF32 for the float32 the
configurations state) comes out not correct under the cell's limits.  At
each cell's own size, on one seed and a short window; the readings the
limits were set from are in PERF.md."""
import pytest

from perfbench import control, harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cuda, name):
    cell = harness.cell(harness.load_manifest(), name)
    r = control.readings(cell, 2 ** 31 + 99, 1.0, "cuda", ["tf32"])
    limits = cell["mix"]["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["tf32"][k] > limits[k] for k in limits), r["tf32"]
