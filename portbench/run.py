"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Measures ``pauxy_tpu_torch`` (the PyTorch and CUDA port) on the CUDA
card(s) of this machine. Prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted`` (blocks started in the window),
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number the check compared with its limit; the same
numbers are the last lines of standard error. Exits non-zero, printing no
result, without enough CUDA cards, or if the JAX package, ``jax``,
``jaxlib`` or ``flax`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pauxy_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's kernel library already builds into build/pauxy_tpu_torch."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    res = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return res.stdout.strip().replace("\n", "; ") or "unknown"


def loaded_forbidden() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.registry import Registry

    reg = Registry()
    cell = reg.workload(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    log(f"# {args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace}; card {power_limit()}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    res = harness.run(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, log)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of {bad} were loaded in the measuring process")
        return 3
    checks = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    log(f"correct {res.correct}; the numbers compared, each with its limit:")
    for name, v, lim in res.checks:
        log(f"check {name} {v!r} limit {lim!r}")
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics,
            "device": res.device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
