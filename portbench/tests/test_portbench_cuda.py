"""On the card: every cell at the tiny size through the kernels, traced,
passes with the configuration's float64 and fails with the float32
control.  Skips where there is no card."""

import pytest

from portbench.harness.cell import run_cell

CELLS = ["h2o6_vdz.ccsd_t", "h2o6_avdz_df.ccsd", "h2o6_vdz.ccsd",
         "h2o6_vdz.rt"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny, cuda_device, cell):
    import time
    result, rows, units, _ = run_cell(tiny, tiny.workload(cell), 11, 0.5,
                                      True, cuda_device, time.perf_counter())
    assert result["correct"], rows
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name in tiny.metrics(cell, True):
        assert name["name"] in result["metrics"]
    control, rows, _, _ = run_cell(tiny, tiny.workload(cell), 11, 0.0,
                                   False, cuda_device, time.perf_counter(),
                                   precision="SP")
    assert not control["correct"], rows
