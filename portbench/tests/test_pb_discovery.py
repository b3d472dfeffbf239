"""A configuration, a mix, a cell and a per-layer metric go in as new
files and entries: the registry finds them and no existing file changes."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench.registry import Registry
from portbench.trace import TraceSummary

HERE = Path(__file__).resolve().parents[1]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(bench)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # The additions: a config file, a mix file, a limits file, a reader.
    (bench / "configs" / "ueg14_rs2.json").write_text(json.dumps(
        {"builder": "ueg", "nup": 7, "ndown": 7, "rs": 2.0, "ecut": 2.0}))
    (bench / "mixes" / "w64.quick.json").write_text(json.dumps(
        {"nwalkers": 64, "nsteps": 5}))
    (bench / "limits" / "ueg14_rs2.quick.json").write_text(json.dumps(
        {"phi_gap": 1.0}))
    (bench / "layer_metrics" / "blocks.traced.py").write_text(
        "RANGES = ()\n\ndef read(t):\n    return float(t.nblocks)\n")
    spec["configs"].append({"name": "ueg14_rs2", "source": "x",
                            "file": "portbench/configs/ueg14_rs2.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "ueg14_rs2.quick",
                              "config": "ueg14_rs2", "traffic": "w64.quick",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "blocks.traced", "unit": "blocks",
                              "better": "higher", "source": "device_trace",
                              "layer": "x", "moves": "walker_steps_per_s",
                              "workloads": ["ueg14_rs2.quick"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    reg = Registry(bench)
    cell = reg.workload("ueg14_rs2.quick")
    assert reg.config(cell["config"])["rs"] == 2.0
    assert reg.mix(cell["traffic"])["nwalkers"] == 64
    assert reg.limits("ueg14_rs2.quick") == {"phi_gap": 1.0}
    assert reg.builder(reg.config(cell["config"])["builder"]).build
    names = [m["name"] for m in reg.per_layer("ueg14_rs2.quick")]
    assert names == ["blocks.traced"]
    reader = reg.metric_reader("blocks.traced")
    assert reader.read(TraceSummary([], 10, {}, 0.0)) == 0.0
    # The cells already there keep their metrics.
    assert "vhs_build_ms_per_step" in [
        m["name"] for m in reg.per_layer("ueg14_rs1.taylor_kernel")]
    assert "vhs_build_ms_per_step" not in [
        m["name"] for m in reg.per_layer("c6h6_dz.fp32")]


def test_every_cell_resolves():
    reg = Registry()
    for cell in reg.spec["workloads"]:
        cfg = reg.config(cell["config"])
        reg.mix(cell["traffic"])
        reg.limits(cell["name"])
        reg.builder(cfg["builder"])
        for m in reg.per_layer(cell["name"]):
            assert callable(reg.metric_reader(m["name"]).read)
