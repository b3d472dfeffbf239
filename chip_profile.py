"""Where one block of the port's main path spends its time, on one CUDA card.

    python3 chip_profile.py [--trace PATH]

Builds the north-star configuration of chip_smoke.py (4x4 Hubbard (7, 7),
U=4, free-electron trial, complex64, dt=0.01, re-orthogonalisation every
10 steps, comb population control and the mixed energy every step), runs
one warm-up block, then one block under torch.profiler (CPU and CUDA
activity). Prints the card (nvidia-smi), the block's wall time, the summed
device time of its kernels, the device's idle share (1 - device time /
wall time; kernels run on one stream, so they do not overlap), the kernel
launch count, and the kernels by device time. With --trace the Chrome
trace is written there too. Needs the card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    nwalkers, nsteps = 1024, 10
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial,
               QMCOpts(nwalkers=nwalkers, dt=0.01, nsteps=nsteps,
                       nblocks=2, nstblz=10, npop_control=1, rng_seed=8),
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cuda")
    af.run_block()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        af.run_block()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total)
    device_us = sum(sum(v) for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    print(card)
    print(json.dumps({
        "nwalkers": nwalkers, "nsteps": nsteps,
        "block_wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches": len(kernels),
        "walker_steps_per_s": nwalkers * nsteps / wall,
    }))
    for name, times in rows[:25]:
        print(f"{sum(times) / 1e3:10.4f} ms {len(times):6d} x  {name[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
