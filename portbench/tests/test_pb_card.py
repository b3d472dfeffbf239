"""On the card, at each cell's own size and load: the program passes the
cell's limits, and the control (the reference in complex64 with TF32
products, in the program's place) comes out as not correct through the
same judgement (``check.judge_control``). Run with
``python -m pytest -m cuda portbench/tests``."""

import pytest

from pb_helpers import run_cell, shrunk_registry

CELLS = ["c6h6_dz.fp32", "ueg14_rs1.taylor_kernel",
         "ueg14_rs1.taylor_series"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_control_fails(cuda_device, workload):
    from portbench import check

    reg = shrunk_registry(configs={}, mix={})
    res = run_cell(reg, workload, seconds=3.0, device=cuda_device,
                   control=True)
    assert res.correct, res.checks
    assert res.control, "the control gave no numbers"
    ctl_correct, rows = check.judge_control(res.control, reg.limits(workload))
    assert not ctl_correct, rows
