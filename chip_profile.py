"""Where one block of each of the port's main paths spends its time, on one
CUDA card.

    python3 chip_profile.py [--trace PREFIX]

Builds the north-star configuration of chip_smoke.py (4x4 Hubbard (7, 7),
U=4, free-electron trial, complex64, 1024 walkers, dt=0.01,
re-orthogonalisation every 10 steps, comb population control and the mixed
energy every step) twice: with the continuous HS propagator (the lanes
block) and with the discrete Hirsch propagator (the generic block and the
sweep kernel); then the Generic path at chip_smoke.py's bench shape
(nmo=128, naux=512, (16, 16), RHF trial, 1024 walkers, dt=0.005,
re-orthogonalisation every 5 steps, taylor_impl="pallas", energy every
step); then the finite-temperature UEG path at chip_smoke.py's phase-11
shape (M=93, (7, 7), beta=2, dt=0.05, mu=0.9, 40 slices, 256 walkers,
complex64), whose block is one imaginary-time path. For each it runs
one warm-up block, then one block under
torch.profiler (CPU and CUDA activity), and prints the block's wall time,
the summed device time of its kernels, the device's idle share (1 - device
time / wall time; kernels run on one stream, so they do not overlap), the
kernel launch count, and the kernels by device time. The card's name and
power limit (nvidia-smi) come first. With --trace the Chrome traces are
written to PREFIX.<path>.json. Needs the card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def profile_block(af, name: str, trace: str | None, steps: int,
                  metric: str = "walker_steps_per_s") -> None:
    from torch.profiler import ProfilerActivity, profile

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
    nwalkers = af.qmc.nwalkers
    print(json.dumps({
        "path": name, "nwalkers": nwalkers, "nsteps": steps,
        "block_wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches": len(kernels),
        metric: nwalkers * steps / wall,
    }))
    for kname, times in rows[:25]:
        print(f"{sum(times) / 1e3:10.4f} ms {len(times):6d} x  "
              f"{kname[:100]}")
    if trace:
        prof.export_chrome_trace(f"{trace}.{name}.json")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import generic_model
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_hubbard, rhf_identity_trial)
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    qmc = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=2, nstblz=10,
                  npop_control=1, rng_seed=8)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    for name, popts in (("continuous", None),
                        ("discrete", {"hubbard_stratonovich": "discrete"})):
        af = AFQMC(ham, trial, qmc, propagator_options=popts,
                   estimator_options=eopts, device="cuda")
        profile_block(af, name, args.trace, qmc.nsteps)
    ham = generic_model(128, 512, 16, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc, propagator_options={"taylor_impl": "pallas"},
               estimator_options=eopts, device="cuda")
    profile_block(af, "generic", args.trace, qmc.nsteps)
    ham = make_ueg(7, 7, rs=1.0, ecut=4.0, device="cuda", dtype="single")
    trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device="cuda",
                                dtype="single")
    qmc = QMCOpts(nwalkers=256, dt=0.05, nsteps=1, nblocks=2, beta=2.0,
                  npop_control=1, rng_seed=8)
    af = ThermalAFQMC(ham, trial, qmc, device="cuda")
    profile_block(af, "thermal_ueg", args.trace, af.ntime_slices,
                  "walker_slice_steps_per_s")


if __name__ == "__main__":
    main()
