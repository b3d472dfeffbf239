"""The reduction of a block's trace, on a synthetic trace in the
profiler's Chrome format: device time by range and by product, busy and
idle seconds, launches."""

import importlib.util
from pathlib import Path

import pytest

from portbench.trace import BlockTrace, TraceSummary

HERE = Path(__file__).resolve().parents[1]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "pid": 1, "args": args}


def _trace():
    ev = [_x("user_annotation", "portbench.block", 0.0, 1000.0),
          _x("user_annotation", "portbench.propagate", 10.0, 500.0),
          _x("cpu_op", "aten::mm", 20.0, 30.0,
             **{"Input Dims": [[64, 32], [32, 16]],
                "Input type": ["float", "float"]}),
          _x("cuda_runtime", "cudaLaunchKernel", 25.0, 5.0, correlation=1),
          _x("user_annotation", "portbench.taylor", 100.0, 50.0),
          _x("cuda_driver", "cuLaunchKernel", 110.0, 5.0, correlation=2),
          _x("cpu_op", "aten::add", 600.0, 20.0),
          _x("cuda_runtime", "cudaLaunchKernel", 605.0, 5.0, correlation=3),
          _x("kernel", "gemm_kernel", 40.0, 100.0, correlation=1),
          _x("kernel", "taylor_kernel", 200.0, 300.0, correlation=2),
          _x("kernel", "add_kernel", 700.0, 100.0, correlation=3),
          # A kernel of another block (outside the block's span).
          _x("kernel", "late", 2000.0, 10.0, correlation=9)]
    return ev


def test_block_trace_attribution():
    bt = BlockTrace(_trace())
    assert bt.wall_s == pytest.approx(1e-3)
    assert bt.launches == 3
    assert bt.busy_s == pytest.approx(500e-6)
    assert bt.range_s["propagate"] == pytest.approx(400e-6)
    assert bt.range_s["taylor"] == pytest.approx(300e-6)
    assert bt.range_calls == {"propagate": 1, "taylor": 1}
    (g,) = bt.gemm
    assert g["device_s"] == pytest.approx(100e-6)
    assert g["ranges"] == {"propagate"}
    assert sum(bt.idle.values()) == pytest.approx(500e-6)
    assert bt.kernels.most_common(1)[0][0] == "taylor_kernel"


def test_readers_on_the_summary():
    s = TraceSummary([BlockTrace(_trace())], 10, {
        "taylor": {"ops": 67e6 * 300e-6 * 1e6 * 0.5, "bytes": 0,
                   "route.pallas": 1}}, 1e-3)
    s.mix = {"matmul_precision": "float32"}

    def reader(name):
        spec = importlib.util.spec_from_file_location(
            f"pb_trace_{name}", HERE / "layer_metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    assert reader("device_idle_pct").read(s) == pytest.approx(50.0)
    assert reader("launches_per_step").read(s) == pytest.approx(0.3)
    assert reader("propagate_ms_per_step").read(s) == pytest.approx(0.04)
    assert reader("taylor_roofline").read(s) == pytest.approx(50.0)
    gemm = reader("gemm_roofline").read(s)
    bound = max(2 * 64 * 32 * 16 / 67e12, 4 * (64 * 32 + 32 * 16 + 64 * 16)
                / 3.35e12)
    assert gemm == pytest.approx(100 * bound / 100e-6)
    assert reader("vhs_build_ms_per_step").read(s) is None
    assert reader("energy_ms_per_eval").read(s) is None
    mfu = reader("step_mfu").read(s)
    ops = 2 * 64 * 32 * 16 + s.counts["taylor"]["ops"]
    assert mfu == pytest.approx(100 * ops / (1e-3 * 67e12))
