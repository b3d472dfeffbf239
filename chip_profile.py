"""Where one block of each of the port's main paths spends its time, on one
CUDA card.

    python3 chip_profile.py [--trace PREFIX] [--paths NAME,...]

Builds the north-star configuration of chip_smoke.py (4x4 Hubbard (7, 7),
U=4, free-electron trial, complex64, 1024 walkers, dt=0.01,
re-orthogonalisation every 10 steps, comb population control and the mixed
energy every step) twice: with the continuous HS propagator (the lanes
block) and with the discrete Hirsch propagator (the generic block and the
sweep kernel); then the Generic path at chip_smoke.py's bench shape
(nmo=128, naux=512, (16, 16), RHF trial, 1024 walkers, dt=0.005,
re-orthogonalisation every 5 steps, taylor_impl="pallas", energy every
step) and past the supermatrix cap at chip_smoke.py's phase-9 shape
(nmo=228, naux=1024, (42, 42), 256 walkers, the energy once a block: the
Taylor kernel at (228, 84) and the exchange kernel); then the
finite-temperature UEG path at chip_smoke.py's phase-11
shape (M=93, (7, 7), beta=2, dt=0.05, mu=0.9, 40 slices, 256 walkers,
complex64), whose block is one imaginary-time path, and the
finite-temperature Hubbard path of chip_smoke.py's phase 12 (3x3, U=4,
mu=0.9, beta=0.5, dt=0.05, 32 walkers, population control every 2
slices, complex64; cpqr at (64, 9)); and the discrete path with
back propagation and the ITCF of chip_smoke.py's phase 13 (tau_bp =
tau_max = 0.4, stable), three warm-up blocks so that the profiled block
ends with one measurement of each, whose wall times (synchronised)
come as ``bp_wall_ms`` and ``itcf_wall_ms``; the low-rank UEG path of
chip_smoke.py's phase 17 (phase 11's configuration with the low-rank
walkers); and the discrete thermal Hubbard path of its phase 18 (3x3,
U=4, mu=0.9, beta=2, dt=0.05, 128 walkers, population control every 2
slices, complex64), whose site sweeps' synchronised wall time comes as
``sweep_wall_ms``; the zero-temperature UEG of chip_smoke.py's phase 21
(make_ueg(7, 7, rs=1, ecut=8): M=257, 4216 fields, RHF trial, complex64,
512 walkers, dt=0.005, re-orthogonalisation every 5 steps, the energy
once a block) on the "xla" Taylor route and in the float32 and the bf16
Taylor tier (``ueg`` profiles the three: paths ``ueg_xla``,
``ueg_pallas`` and ``ueg_pallas_bf16``), with the Taylor
kernels' device time and launches as ``taylor_ms`` / ``taylor_launches``
(float32, "taylor_kernel") and ``taylor_bf16_ms`` /
``taylor_bf16_launches``, and the 3-pass split GEMM of the
"bfloat16_3x" tier as ``gemm_bf16x3_ms`` / ``gemm_bf16x3_launches``;
and PW_FFT at the same shape (chip_smoke.py's phase 23); the NOMSD path
of chip_smoke.py's phase 25 (``msd_generic``: the Generic bench shape
with the D = 8 rotated expansion, 1024 walkers, taylor_impl="pallas",
energy every step), whose per-determinant exchange
calls (``local_energy._exx``: the einsum route's cuBLAS product and
transposed trace) come with their synchronised wall time as
``exx_wall_ms``;
and the GHF path of its phase 27 (``ghf``: the 4x4 (7, 7) discrete
lattice with the D = 2 GHF trial, 1024 walkers), whose site sweeps'
synchronised wall time comes as ``sweep_wall_ms``; the Hubbard-Holstein
paths of its phase 28 (``hh``: the 4x4 (7, 7) lattice, U=4, w0=1,
lambda=0.25, the coherent-state trial, 1024 walkers, dt=0.005,
re-orthogonalisation and population control every 5 steps, the energy
every 2 steps; ``hh_mc``: the same with the translation-symmetrised
multi-coherent trial, P = 16), whose site sweeps' synchronised wall time
comes as ``sweep_wall_ms``; and the Generic energy variants of its phase
30 (``generic_variants``: the bench shape with the exact-ERI, PNO (1e-13)
and stochastic-RI (20 probes) energies, and taylor_impl="xla_3m"; paths
``generic_exact_eri``, ``generic_pno``, ``generic_stochastic_ri``,
``generic_xla_3m``), whose energy evaluations' synchronised wall time
comes as ``energy_wall_ms``. For each it runs
one warm-up block, then one block under
torch.profiler (CPU and CUDA activity), and prints the block's wall time,
the summed device time of its kernels, the device's idle share (1 - device
time / wall time; kernels run on one stream, so they do not overlap), the
kernel launch count, the device time and launches of the cpqr kernel,
kernel A, the Cholesky-inverse kernel and the sweep kernel (``cpqr_ms``,
``greens_ms``, ``chol_ms``, ``sweep_ms``: every kernel whose name holds
"cpqr", "greens_lanes", "chol_inv" or "hirsch_sweep"), and the kernels
by device time. The card's
name and power limit (nvidia-smi) come first. The drivers take the
matmul tier of ``PAUXY_TPU_MATMUL`` (default "float32"), and each line
names it (``matmul_precision``). --paths profiles only the
named paths (continuous, discrete, bp_discrete, generic, generic_exx,
thermal_ueg, thermal_hubbard, thermal_ueg_lowrank, thermal_discrete, ueg,
pw_fft, msd_generic, ghf, hh, hh_mc, generic_variants).
With --trace the Chrome traces are written to PREFIX.<path>.json. Needs
the card; there is no CPU fallback.
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
                  metric: str = "walker_steps_per_s", warmup: int = 1,
                  extra=None) -> None:
    """Profile one block after ``warmup`` blocks; ``extra()``, read after
    the profiled block, adds keys to the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
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
    mine = {key: [t for k, v in by_name.items() if key in k for t in v]
            for key in ("cpqr", "greens_lanes", "chol_inv", "hirsch_sweep",
                        "taylor_kernel", "taylor_bf16", "gemm_bf16x3")}
    print(json.dumps({
        "path": name, "matmul_precision": af.matmul_precision,
        "nwalkers": nwalkers, "nsteps": steps,
        "block_wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches": len(kernels),
        "cpqr_ms": sum(mine["cpqr"]) / 1e3,
        "cpqr_launches": len(mine["cpqr"]),
        "greens_ms": sum(mine["greens_lanes"]) / 1e3,
        "greens_launches": len(mine["greens_lanes"]),
        "chol_ms": sum(mine["chol_inv"]) / 1e3,
        "chol_launches": len(mine["chol_inv"]),
        "sweep_ms": sum(mine["hirsch_sweep"]) / 1e3,
        "sweep_launches": len(mine["hirsch_sweep"]),
        "taylor_ms": sum(mine["taylor_kernel"]) / 1e3,
        "taylor_launches": len(mine["taylor_kernel"]),
        "taylor_bf16_ms": sum(mine["taylor_bf16"]) / 1e3,
        "taylor_bf16_launches": len(mine["taylor_bf16"]),
        "gemm_bf16x3_ms": sum(mine["gemm_bf16x3"]) / 1e3,
        "gemm_bf16x3_launches": len(mine["gemm_bf16x3"]),
        metric: nwalkers * steps / wall,
        **(extra() if extra else {}),
    }))
    for kname, times in rows[:25]:
        print(f"{sum(times) / 1e3:10.4f} ms {len(times):6d} x  "
              f"{kname[:100]}")
    if trace:
        prof.export_chrome_trace(f"{trace}.{name}.json")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None)
    ap.add_argument("--paths", default=None,
                    help="comma-separated paths to profile (default all)")
    args = ap.parse_args()
    want = set(args.paths.split(",")) if args.paths else None

    def wanted(name: str) -> bool:
        return want is None or name in want

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import generic_model, rotated_msd_psi, spin_flip_psi
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_ghf_trial, make_hubbard,
                                        make_pw_fft, multi_slater_trial,
                                        rhf_identity_trial)
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    def timed(module, fname: str, seconds: list):
        """Wrap ``module.fname`` so each call's wall time (synchronised on
        both sides) is appended to ``seconds``."""
        fn = getattr(module, fname)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        setattr(module, fname, wrapper)
        return fn

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
        if not wanted(name):
            continue
        af = AFQMC(ham, trial, qmc, propagator_options=popts,
                   estimator_options=eopts, device="cuda")
        profile_block(af, name, args.trace, qmc.nsteps)
    if wanted("bp_discrete"):
        from pauxy_tpu_torch.estimators import back_prop
        from pauxy_tpu_torch.estimators import itcf as itcf_mod

        # chip_smoke.py phase 13: the warm-up blocks bring the field buffer
        # to 30 of its 40 steps, so the profiled block ends with one BP and
        # one ITCF measurement.
        bq = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=4,
                     nstblz=10, npop_control=1, rng_seed=8)
        af = AFQMC(ham, trial, bq,
                   propagator_options={"hubbard_stratonovich": "discrete"},
                   estimator_options={
                       "mixed": {"energy_eval_freq": 1},
                       "back_propagation": {"tau_bp": 0.4,
                                            "evaluate_energy": True},
                       "itcf": {"tau_max": 0.4, "stable": True}},
                   device="cuda")
        bp_s, itcf_s = [], []
        old = (timed(back_prop, "update", bp_s),
               timed(itcf_mod, "measure", itcf_s))
        try:
            profile_block(af, "bp_discrete", args.trace, bq.nsteps,
                          warmup=3, extra=lambda: {
                              "bp_wall_ms": 1e3 * sum(bp_s),
                              "itcf_wall_ms": 1e3 * sum(itcf_s),
                              "warmup_block_ms": [
                                  1e3 * t for t in af.block_seconds[:3]]})
        finally:
            back_prop.update, itcf_mod.measure = old
        del af
    if wanted("thermal_hubbard"):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device="cuda",
                           dtype="single")
        trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, device="cuda",
                                    dtype="single")
        qmc = QMCOpts(nwalkers=32, dt=0.05, nsteps=1, nblocks=2, beta=0.5,
                      npop_control=2, rng_seed=8)
        af = ThermalAFQMC(ham, trial, qmc, device="cuda")
        profile_block(af, "thermal_hubbard", args.trace, af.ntime_slices,
                      "walker_slice_steps_per_s")
    if wanted("generic"):
        ham = generic_model(128, 512, 16, make_generic)
        trial = rhf_identity_trial(ham, device="cuda", dtype="single")
        qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2,
                      nstblz=5, npop_control=1, rng_seed=8)
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"taylor_impl": "pallas"},
                   estimator_options=eopts, device="cuda")
        profile_block(af, "generic", args.trace, qmc.nsteps)
        del ham, trial, af
    if wanted("msd_generic"):
        from pauxy_tpu_torch.estimators import local_energy

        ham = generic_model(128, 512, 16, make_generic)
        psi, coeffs = rotated_msd_psi(128, 16, 16, 8, seed=25)
        trial = multi_slater_trial(ham, psi, coeffs, device="cuda",
                                   dtype="single")
        qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2,
                      nstblz=5, npop_control=1, rng_seed=8)
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"taylor_impl": "pallas"},
                   estimator_options=eopts, device="cuda")
        exx_s = []
        af.run_block()
        old = timed(local_energy, "_exx", exx_s)
        try:
            profile_block(af, "msd_generic", args.trace, qmc.nsteps,
                          warmup=0, extra=lambda: {
                              "exx_wall_ms": 1e3 * sum(exx_s),
                              "exx_calls": len(exx_s)})
        finally:
            local_energy._exx = old
        del ham, trial, af
    if wanted("ghf"):
        import numpy as np

        from pauxy_tpu_torch.propagation.hirsch import Hirsch

        gd = np.load(os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "data", "hubbard4x4_uhf_discrete.npz"))
        ua, ub = gd["psi"][:, :7], gd["psi"][:, 7:]
        ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                           dtype="single")
        trial = make_ghf_trial(ham, spin_flip_psi(ua, ub),
                               np.full(2, 2 ** -0.5), init=(ua, ub),
                               device="cuda", dtype="single")
        qmc = QMCOpts(nwalkers=1024, dt=0.01, nsteps=10, nblocks=2,
                      nstblz=10, npop_control=1, rng_seed=8)
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"hubbard_stratonovich": "discrete"},
                   estimator_options=eopts, device="cuda")
        sweep_s = []
        af.run_block()
        old = timed(Hirsch, "_site_sweep_ghf", sweep_s)
        try:
            profile_block(af, "ghf", args.trace, qmc.nsteps, warmup=0,
                          extra=lambda: {"sweep_wall_ms": 1e3 * sum(sweep_s),
                                         "sweeps": len(sweep_s)})
        finally:
            Hirsch._site_sweep_ghf = old
        del ham, trial, af
    for name in ("hh", "hh_mc"):
        if not wanted(name):
            continue
        from pauxy_tpu_torch.models.hubbard_holstein import (
            coherent_state_trial, make_hubbard_holstein)
        from pauxy_tpu_torch.models.multi_coherent import (
            multi_coherent_trial)
        from pauxy_tpu_torch.propagation.hirsch import Hirsch
        from pauxy_tpu_torch.propagation.hirsch_dmc import HirschDMC

        ham = make_hubbard_holstein(7, 7, U=4.0, nx=4, ny=4, w0=1.0,
                                    lmbda=0.25, device="cuda",
                                    dtype="single")
        trial = (multi_coherent_trial if name == "hh_mc"
                 else coherent_state_trial)(ham, device="cuda",
                                            dtype="single")
        qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2,
                      nstblz=5, npop_control=5, rng_seed=8)
        af = AFQMC(ham, trial, qmc,
                   estimator_options={"mixed": {"energy_eval_freq": 2}},
                   device="cuda")
        owner, fname = ((HirschDMC, "_site_sweep_mc") if name == "hh_mc"
                        else (Hirsch, "_site_sweep"))
        sweep_s = []
        af.run_block()
        old = timed(owner, fname, sweep_s)
        try:
            profile_block(af, name, args.trace, qmc.nsteps, warmup=0,
                          extra=lambda: {"sweep_wall_ms": 1e3 * sum(sweep_s),
                                         "sweeps": len(sweep_s)})
        finally:
            setattr(owner, fname, old)
        del ham, trial, af
    if wanted("generic_variants"):
        from pauxy_tpu_torch.estimators import mixed

        qmc = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=2,
                      nstblz=5, npop_control=1, rng_seed=8)
        for name, flags, popts in (
                ("exact_eri", {"exact_eri": True}, {"taylor_impl": "pallas"}),
                ("pno", {"pno": True, "thresh_pno": 1e-13},
                 {"taylor_impl": "pallas"}),
                ("stochastic_ri", {"stochastic_ri": True, "nsamples": 20},
                 {"taylor_impl": "pallas"}),
                ("xla_3m", {}, {"taylor_impl": "xla_3m"})):
            ham = generic_model(128, 512, 16, lambda *a, **kw: make_generic(
                *a, **flags, **kw))
            trial = rhf_identity_trial(ham, device="cuda", dtype="single")
            af = AFQMC(ham, trial, qmc, propagator_options=popts,
                       estimator_options=eopts, device="cuda")
            energy_s = []
            af.run_block()
            old = timed(mixed, "_energies", energy_s)
            try:
                profile_block(af, f"generic_{name}", args.trace, qmc.nsteps,
                              warmup=0, extra=lambda: {
                                  "energy_wall_ms": 1e3 * sum(energy_s),
                                  "energies": len(energy_s)})
            finally:
                mixed._energies = old
            del ham, trial, af
    if wanted("generic_exx"):
        ham = generic_model(228, 1024, 42, make_generic)
        trial = rhf_identity_trial(ham, device="cuda", dtype="single")
        qmc = QMCOpts(nwalkers=256, dt=0.005, nsteps=10, nblocks=2,
                      nstblz=5, npop_control=1, rng_seed=8)
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"taylor_impl": "pallas"},
                   device="cuda")
        profile_block(af, "generic_exx", args.trace, qmc.nsteps)
        del ham, trial, af
    if wanted("thermal_discrete"):
        from pauxy_tpu_torch.propagation import thermal_discrete

        # chip_smoke.py phase 18: the site sweep's wall time (synchronised)
        # comes as sweep_wall_ms.
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device="cuda",
                           dtype="single")
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device="cuda",
                                    dtype="single")
        qmc = QMCOpts(nwalkers=128, dt=0.05, nsteps=1, nblocks=2, beta=2.0,
                      npop_control=2, rng_seed=8)
        af = ThermalAFQMC(ham, trial, qmc, device="cuda",
                          propagator_options={
                              "hubbard_stratonovich": "discrete"})
        sweep_s = []
        af.run_block()
        old = timed(thermal_discrete.ThermalDiscrete, "_site_sweep", sweep_s)
        try:
            profile_block(af, "thermal_discrete", args.trace,
                          af.ntime_slices, "walker_slice_steps_per_s",
                          warmup=0, extra=lambda: {
                              "sweep_wall_ms": 1e3 * sum(sweep_s),
                              "sweeps": len(sweep_s)})
        finally:
            thermal_discrete.ThermalDiscrete._site_sweep = old
        del ham, trial, af
    uq = QMCOpts(nwalkers=512, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
                 npop_control=1, rng_seed=8)
    ueg_eopts = {"mixed": {"energy_eval_freq": 10}}
    if wanted("ueg"):
        ham = make_ueg(7, 7, rs=1.0, ecut=8.0, device="cuda",
                       dtype="single")
        trial = rhf_identity_trial(ham, device="cuda", dtype="single")
        for impl in ("xla", "pallas", "pallas_bf16"):
            # The UEG's tier comes from the environment, as in JAX.
            os.environ["PAUXY_TPU_TAYLOR_UEG"] = impl
            af = AFQMC(ham, trial, uq, estimator_options=ueg_eopts,
                       device="cuda")
            profile_block(af, f"ueg_{impl}", args.trace, uq.nsteps)
            del af
        os.environ.pop("PAUXY_TPU_TAYLOR_UEG")
        del ham, trial
    if wanted("pw_fft"):
        ham = make_pw_fft(7, 7, rs=1.0, ecut=8.0, device="cuda",
                          dtype="single")
        trial = free_electron_trial(ham, device="cuda", dtype="single")
        af = AFQMC(ham, trial, uq, estimator_options=ueg_eopts,
                   device="cuda")
        profile_block(af, "pw_fft", args.trace, uq.nsteps)
        del ham, trial, af
    for name, wopts in (("thermal_ueg", None),
                        ("thermal_ueg_lowrank", {"low_rank": True,
                                                 "low_rank_thresh": 1e-6})):
        if not wanted(name):
            continue
        ham = make_ueg(7, 7, rs=1.0, ecut=4.0, device="cuda",
                       dtype="single")
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device="cuda",
                                    dtype="single")
        qmc = QMCOpts(nwalkers=256, dt=0.05, nsteps=1, nblocks=2, beta=2.0,
                      npop_control=1, rng_seed=8)
        af = ThermalAFQMC(ham, trial, qmc, walker_options=wopts,
                          device="cuda")
        profile_block(af, name, args.trace, af.ntime_slices,
                      "walker_slice_steps_per_s")
        del ham, trial, af


if __name__ == "__main__":
    main()
