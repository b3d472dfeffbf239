"""The bound arithmetic against PERF.md's bound column."""

import importlib.util
from pathlib import Path

import pytest

from portbench import roofline
from portbench.trace import gemm_count

HERE = Path(__file__).resolve().parents[1]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"pb_test_{name}", HERE / "layer_metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m, c, w, ms", [(128, 32, 1024, 0.38462),
                                         (257, 14, 512, 0.33918)])
def test_taylor_bound(m, c, w, ms):
    taylor = _reader("taylor_roofline")
    ops, nbytes = taylor.count((w, m, m), (w, m, c), 6)
    b = roofline.bound_s(ops, nbytes, taylor.peak("pallas", "float32"))
    assert b * 1e3 == pytest.approx(ms, abs=5e-6)


def test_split_gemm_bound():
    g = {"op": "aten::mm", "dims": [[1024, 512], [512, 16384]],
         "types": ["float", "float"]}
    ops, nbytes = gemm_count(g)
    assert ops == 2 * 1024 * 512 * 16384
    b = roofline.bound_s(ops, nbytes, roofline.TIER_PEAK["bfloat16_3x"])
    assert b * 1e3 == pytest.approx(0.05211, abs=5e-6)


def test_gemm_count_shapes():
    bmm = {"op": "aten::bmm", "dims": [[4, 3, 5], [4, 5, 2]],
           "types": ["c10::complex<float>"] * 2}
    assert gemm_count(bmm) == (8 * 4 * 3 * 2 * 5, 8 * 4 * (15 + 10 + 6))
    addmm = {"op": "aten::addmm", "dims": [[3, 2], [3, 5], [5, 2]],
             "types": ["float"] * 3}
    assert gemm_count(addmm) == (2 * 3 * 2 * 5, 4 * (15 + 10 + 6 + 6))
    assert gemm_count({"op": "aten::mm", "dims": [[2, 2], [2, 2]],
                       "types": ["double", "double"]}) is None


def test_share_is_none_without_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(0.0, 1.0) is None
