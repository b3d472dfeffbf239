"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port; top-level module names are compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pauxy_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"pauxy_tpu_torch"}), path
        assert "bench" not in {t for t in _imports(path)}, path


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(HERE.parent)!r})\n"
        f"sys.path.insert(0, {str(HERE / 'tests')!r})\n"
        "from pb_helpers import shrunk_registry, run_cell\n"
        "res = run_cell(shrunk_registry(), 'ueg14_rs1.taylor_kernel')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"print(sorted(tops & set({sorted(FORBIDDEN)!r})), res.correct)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
