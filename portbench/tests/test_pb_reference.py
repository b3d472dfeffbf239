"""The plain reference against the port's CPU path at tiny sizes, with the
same draws: in double precision the two agree to rounding; in single
precision the port's blocks pass the cells' limits."""

import pytest

from pb_helpers import run_cell

CELLS = ["c6h6_dz.fp32", "ueg14_rs1.taylor_kernel",
         "ueg14_rs1.taylor_series"]


@pytest.mark.parametrize("workload", CELLS[:2])
def test_double_agrees_to_rounding(small_registry, workload):
    res = run_cell(small_registry, workload, dtype="double")
    got = {name: v for name, v, _ in res.checks}
    assert got["start_mismatch"] == 0 and got["comb_mismatch"] == 0
    for name in ("phi_gap", "weight_gap", "ehyb_gap", "row_gap"):
        assert got[name] < 1e-10, (name, got[name])
    assert res.correct


@pytest.mark.parametrize("workload", CELLS)
def test_single_passes_the_limits(small_registry, workload):
    res = run_cell(small_registry, workload, seed=2 ** 40 + 3)
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0
    assert set(res.metrics) == {"walker_steps_per_s", "block_ms_p95",
                                "setup_s"}


def test_same_seed_same_inputs():
    import torch

    from portbench import draws

    a = draws.BlockDraws(2 ** 35, 2, 3, 4, "cpu").block("window", 5)
    b = draws.BlockDraws(2 ** 35, 2, 3, 4, "cpu").block("window", 5)
    c = draws.BlockDraws(2 ** 35, 2, 3, 4, "cpu").block("window", 6)
    assert torch.equal(a.xi, b.xi) and torch.equal(a.pop, b.pop)
    assert not torch.equal(a.xi, c.xi)
