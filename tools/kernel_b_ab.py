"""Kernel B's time at the shapes the port gives it, for the checkouts named
on the command line, in turns, on one CUDA card.

    python3 tools/kernel_b_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for a parent commit, unpack it
with ``git archive`` into a directory that .gitignore lists, such as
build/parent). Each root's pauxy_tpu_torch is built from its own sources and
timed in a process of its own, on the same seeded inputs: the profiler's
device time of one launch (``chip_smoke.device_ms``) and the wrapper call's
median CUDA-event time (``chip_smoke.median_ms``) at the log-det-only n=7
w=1024 of the discrete path, the inverse at n=16 w=8192 (a D = 8
multi-determinant trial at the Generic bench shape, 1024 walkers) and n=93
w=512 with and without the inverse (the thermal QDT assembly). Roots run in
the order given, so give parent, change, change, parent to compare two
commits. Prints the card's name and power limit, then one JSON line per
root and shape.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((7, 1024, False), (16, 8192, True), (93, 512, True),
          (93, 512, False))


def child(root: str) -> None:
    """Time kernel B of the checkout at ``root``."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from pauxy_tpu_torch.ops import batchla_cuda, cuda_build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda_build.build()
    for n, w, want_inv in SHAPES:
        rng = np.random.default_rng(n)
        s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * (
            rng.normal(size=(w, n, n)) + 1j * rng.normal(size=(w, n, n)))
        s = torch.from_numpy(s).to("cuda", torch.complex64)

        def call():
            return batchla_cuda.inv_logdet_lanes(s, want_inv)

        wrapper = smoke.median_ms({"kernel": call})["kernel"]
        device = smoke.device_ms(call, "inv_logdet_kernel")
        print(json.dumps({"root": root, "n": n, "w": w, "inverse": want_inv,
                          "device_ms": device, "ms": wrapper}), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        os.path.abspath(root)], check=True)


if __name__ == "__main__":
    main()
