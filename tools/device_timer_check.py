"""The two device timers of chip_smoke.py held against each other on one
CUDA card, at the Cholesky and sweep kernels' main-path shapes.

    python3 tools/device_timer_check.py

For each shape it counts, over 15 profiler windows of 20 wrapper calls,
the kernel events the profiler kept (``chip_smoke.device_ms`` needs at
least half of them), and prints ``device_ms`` (the profiler's time a
launch) beside three readings of ``queued_ms`` (CUDA events around calls
queued behind a sleeping kernel, the fallback when the profiler keeps
none). The card's name and power limit come first.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pauxy_tpu_torch.ops import batchla_cuda, cuda_build, sweep_cuda  # noqa: E402


def kept_events(fn, key: str, windows: int = 15, reps: int = 20) -> list:
    from torch.profiler import ProfilerActivity, profile

    kept = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kept.append(sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and key in e.name))
    return kept


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("device_timer_check: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    cuda_build.library()
    rng = np.random.default_rng(3)
    cases = []
    for n, w in ((7, 1024), (16, 1024), (42, 256)):
        s = torch.from_numpy(cs.hpd(rng, w, n)).to("cuda", torch.complex64)
        cases.append((f"chol_inv n={n} w={w} c64", "chol_inv",
                      lambda s=s: batchla_cuda.chol_inv_lanes(s)))
    sw = cs.sweep_inputs(rng, 16, 7, 7, 1024, torch.float32)
    cases.append(("hirsch_sweep (16,7,7) W=1024 f32", "hirsch_sweep",
                  lambda: sweep_cuda.hirsch_sweep_real(*sw)))
    for name, key, fn in cases:
        fn()
        torch.cuda.synchronize()
        kept = kept_events(fn, key)
        dev = cs.device_ms(fn, key)
        queued = [cs.queued_ms(fn) for _ in range(3)]
        print(f"{name}: device_ms {dev:.5f} ms, queued_ms "
              + ", ".join(f"{q:.5f}" for q in queued)
              + f" ms; events kept per window of 20: {kept}", flush=True)


if __name__ == "__main__":
    main()
