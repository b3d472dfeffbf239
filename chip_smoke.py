"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises, so the script exits
non-zero and prints no result line:
  1. environment: a CUDA card is required (no CPU fallback);
  2. build the CUDA kernels of pauxy_tpu_torch/csrc from this checkout;
  3. each kernel against its plain PyTorch version on the same card tensors,
     at the shapes the main path and the larger lattices give it, with
     median times at the main-path shape;
  4. the main path at full width: 4x4 Hubbard (7, 7), U=4, free-electron
     trial, complex64, 1024 walkers, dt=0.01, re-orthogonalisation every 10
     steps, comb population control and the mixed energy every step, driven
     through AFQMC(...).run(); every weight and ETotal finite, and the
     kernels launched as often as the step schedule says;
  5. the golden anchor: UHF trial of tests/data/hubbard4x4_uhf_continuous.npz,
     40 walkers, 100 blocks, against the reference's block energies:
     |diff| < max(4 se, 0.05).
Then the card's name and power limit (nvidia-smi), one JSON line about the
kernels, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN = dict(m=16, n=7, w=1024)
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fns: dict, reps: int = 25) -> dict:
    """Median CUDA-event time of each callable, measured in turns
    (a, b, b, a) after a warm-up."""
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for name in order:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in samples.items()}


def phase_diff(a: np.ndarray) -> np.ndarray:
    return np.abs(np.angle(np.exp(1j * a)))


def check_greens(greens_cuda, rng) -> float:
    """Kernel A against its plain version; returns the largest absolute
    difference at the main-path shape (complex64, with ghT)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        for m, n in ((9, 3), (16, 7), (36, 18), (64, 24)):
            for w in (1, 100, 1024, 1031):
                psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
                phi = psi[:, :, None] + 0.3 * (
                    rng.normal(size=(m, n, w)) + 1j * rng.normal(size=(m, n, w)))
                psi = torch.from_numpy(psi).to("cuda", dtype)
                phi = torch.from_numpy(phi).to("cuda", dtype)
                for want_gh in (True, False):
                    ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
                    ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi,
                                                                want_gh)
                    torch.cuda.synchronize()
                    d = (ld_k - ld_p).cpu().numpy()
                    dre = float(np.abs(d.real).max())
                    dim = float(phase_diff(d.imag).max())
                    dgh = rel = 0.0
                    if want_gh:
                        dgh = float((gh_k - gh_p).abs().max())
                        rel = dgh / float(gh_p.abs().max())
                    if dre > tol * n or dim > tol * n or rel > tol:
                        raise AssertionError(
                            f"greens_lanes disagrees at {dtype} M={m} n={n} "
                            f"W={w} want_gh={want_gh}: dRe={dre:.3e} "
                            f"dIm={dim:.3e} dghT/max={rel:.3e}")
                    if (dtype == torch.complex64 and (m, n, w) == (16, 7, 1024)
                            and want_gh):
                        main_err = max(dre, dim, dgh)
    return main_err


def check_batchla(batchla_cuda, rng) -> float:
    """Kernel B against its plain version, including matrices that need
    pivoting; returns the largest absolute difference at the main-path
    shape (complex64, n=7, w=1024, log-det only as at setup)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        for n in (3, 7, 18, 24):
            w = 1024
            s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * (
                rng.normal(size=(w, n, n)) + 1j * rng.normal(size=(w, n, n)))
            s[0] = np.eye(n)[::-1]                # zero leading minors
            s[1] = np.roll(np.eye(n), 1, axis=0)  # cyclic permutation
            s = torch.from_numpy(s).to("cuda", dtype)
            for want_inv in (True, False):
                ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
                ld_p, inv_p = batchla_cuda.inv_logdet_lanes_plain(s, want_inv)
                torch.cuda.synchronize()
                d = (ld_k - ld_p).cpu().numpy()
                dre = float(np.abs(d.real).max())
                dim = float(phase_diff(d.imag).max())
                rel = 0.0
                if want_inv:
                    rel = float((inv_k - inv_p).abs().max()
                                / inv_p.abs().max())
                if dre > tol * n or dim > tol * n or rel > tol:
                    raise AssertionError(
                        f"inv_logdet_lanes disagrees at {dtype} n={n} "
                        f"want_inv={want_inv}: dRe={dre:.3e} dIm={dim:.3e} "
                        f"dinv/max={rel:.3e}")
                if dtype == torch.complex64 and n == 7 and not want_inv:
                    main_err = max(dre, dim)
    return main_err


def main() -> None:
    # ---- 1. environment --------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check needs the "
                         "card and has no CPU fallback")
    sys.path.insert(0, ROOT)
    import pauxy_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(pauxy_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        raise SystemExit(f"chip_smoke: pauxy_tpu_torch found at {pkg_dir}, "
                         f"not beside this script in {ROOT}")
    from pauxy_tpu_torch.models import (free_electron_trial, make_hubbard,
                                        trial_from_orbitals)
    from pauxy_tpu_torch.ops import batchla_cuda, cuda_build, greens_cuda
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "pauxy_tpu")]
    if bad:
        raise SystemExit(f"chip_smoke: JAX modules imported: {bad}")
    card = nvidia_smi()
    say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"nvidia-smi: {card}")

    # ---- 2. build --------------------------------------------------------
    path, seconds = cuda_build.build()
    cuda_build.library()
    log = path.with_suffix(".log")
    usage = []
    if log.exists():
        usage = [line.split("ptxas info    : ")[-1] for line in
                 log.read_text().splitlines() if "Used" in line]
    say("2 build", f"{os.path.relpath(path, ROOT)} nvcc {seconds:.1f}s "
        f"(0 = cached); " + " | ".join(usage))

    # ---- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(2024)
    err_a = check_greens(greens_cuda, rng)
    err_b = check_batchla(batchla_cuda, rng)
    m, n, w = MAIN["m"], MAIN["n"], MAIN["w"]
    psi = torch.from_numpy(rng.normal(size=(m, n)) + 0j).to("cuda",
                                                            torch.complex64)
    phi = (psi[:, :, None] + 0.3 * torch.randn(m, n, w, dtype=torch.complex64,
                                               device="cuda")).contiguous()
    s = torch.einsum("mnw,mk->wnk", phi, psi.conj()).contiguous()
    t_a = median_ms({
        "plain": lambda: greens_cuda.greens_lanes_plain(psi, phi, True),
        "kernel": lambda: greens_cuda.greens_lanes(psi, phi, True),
    })
    t_b = median_ms({
        "plain": lambda: batchla_cuda.inv_logdet_lanes_plain(s, False),
        "kernel": lambda: batchla_cuda.inv_logdet_lanes(s, False),
    })
    say("3 kernels", "greens_lanes and inv_logdet_lanes agree with their "
        "plain versions at every shape (complex64 1e-4, complex128 1e-10); "
        f"at (16,7) W=1024 complex64: greens_lanes kernel "
        f"{t_a['kernel']:.4f} ms vs plain {t_a['plain']:.4f} ms (max abs "
        f"err {err_a:.3e}); inv_logdet_lanes kernel {t_b['kernel']:.4f} ms "
        f"vs plain {t_b['plain']:.4f} ms (max abs err {err_b:.3e})")

    # ---- 4. the main path at full width ----------------------------------
    nblocks, nsteps, nwalkers = 4, 10, 1024
    greens_cuda.launches = 0
    batchla_cuda.launches = 0
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    qmc = QMCOpts(nwalkers=nwalkers, dt=0.01, nsteps=nsteps, nblocks=nblocks,
                  nstblz=10, npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cuda", filename=None)
    rows = af.run()
    torch.cuda.synchronize()
    launches_a, launches_b = greens_cuda.launches, batchla_cuda.launches
    steps = nblocks * nsteps
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the main path: {rows}")
    if launches_a != 6 * steps or launches_b != 2:
        raise AssertionError(
            f"kernel launches on the main path: greens_lanes {launches_a} "
            f"(want {6 * steps}), inv_logdet_lanes {launches_b} (want 2)")
    timed = af.block_seconds[1:]
    rate = nwalkers * nsteps * len(timed) / sum(timed)
    say("4 main path", f"4x4 (7,7) U=4 complex64 {nwalkers} walkers "
        f"{steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches "
        f"greens_lanes {launches_a} = 6 x {steps}, inv_logdet_lanes "
        f"{launches_b}; {rate:.1f} walker-steps/s over {len(timed)} blocks "
        f"after a warm-up block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")

    # ---- 5. golden anchor on the card ------------------------------------
    g = np.load(os.path.join(ROOT, "tests", "data",
                             "hubbard4x4_uhf_continuous.npz"))
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), device="cuda",
                                dtype="single")
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    t0 = time.perf_counter()
    rows = AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cuda").run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                        theirs.std(ddof=1) / np.sqrt(len(theirs))))
    diff = float(abs(mine.mean() - theirs.mean()))
    if not (np.isfinite(et).all() and diff < max(4 * se, 0.05)):
        raise AssertionError(f"golden anchor missed: port {mine.mean()} "
                             f"reference {theirs.mean()} se {se}")
    say("5 golden", f"UHF trial, 40 walkers, 100 blocks, complex64: port "
        f"{mine.mean():.6f} vs reference {theirs.mean():.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- result ----------------------------------------------------------
    print(nvidia_smi())
    kernels = [
        {"name": "greens_lanes", "route": "cuda",
         "source": "pauxy_tpu_torch/csrc/greens.cu",
         "replaces": "pauxy_tpu/ops/greens_pallas.py:61",
         "launches": launches_a, "max_abs_err": err_a,
         "ms": t_a["kernel"], "plain_ms": t_a["plain"]},
        {"name": "inv_logdet_lanes", "route": "cuda",
         "source": "pauxy_tpu_torch/csrc/batchla.cu",
         "replaces": "pauxy_tpu/ops/batchla_pallas.py:135",
         "launches": launches_b, "max_abs_err": err_b,
         "ms": t_b["kernel"], "plain_ms": t_b["plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
