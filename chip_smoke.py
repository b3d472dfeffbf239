"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises, so the script exits
non-zero and prints no result line:
  1. environment: a CUDA card is required (no CPU fallback);
  2. build the CUDA kernels of pauxy_tpu_torch/csrc from this checkout, one
     nvcc per source, all at once;
  3. each kernel against its plain PyTorch version on the same card tensors,
     at the shapes the main paths and the larger lattices give it, with
     median times at the main-path shape (kernel, plain version, and the
     one PyTorch call that computes the same function where there is one);
  4. the continuous main path at full width: 4x4 Hubbard (7, 7), U=4,
     free-electron trial, complex64, 1024 walkers, dt=0.01,
     re-orthogonalisation every 10 steps, comb population control and the
     mixed energy every step, driven through AFQMC(...).run(); every weight
     and ETotal finite, and the kernels launched as often as the step
     schedule says;
  5. the continuous golden anchor: UHF trial of
     tests/data/hubbard4x4_uhf_continuous.npz, 40 walkers, 100 blocks,
     against the reference's block energies: |diff| < max(4 se, 0.05);
  6. the discrete main path at full width: the same system with the
     discrete (Hirsch) spin decomposition and the single-site sweep
     (constrained-path CPMC), through AFQMC(...).run(); every weight and
     ETotal finite, and the launches of the step schedule;
  7. the discrete golden anchor: UHF trial of
     tests/data/hubbard4x4_uhf_discrete.npz, 40 walkers, 100 blocks, the
     same criterion.
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
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10, torch.float32: 1e-4,
       torch.float64: 1e-10}
# One H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and FLOP/s outside the
# tensor cores by element type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.complex64: 67e12,
              torch.float64: 34e12, torch.complex128: 34e12}


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
    (a, b, ..., b, a) after a warm-up."""
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over the HBM rate and
    operations over the peak rate of the element type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gj_flops(n: int, ncol: int, cplx: bool) -> int:
    """Gauss-Jordan on n x ncol: elimination multiply-adds and row scaling."""
    mac, mul = (8, 6) if cplx else (2, 1)
    return sum((n - 1) * (ncol - k) * mac + (ncol - k) * mul
               for k in range(n))


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
    """Kernel B against its plain version, complex and real input,
    including matrices that need pivoting and negative determinants;
    returns the largest absolute difference at the main-path shape
    (complex64, n=7, w=1024, log-det only)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        tol = TOL[dtype]
        for n in (3, 7, 18, 24):
            w = 1024
            s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * rng.normal(size=(w, n, n))
            if dtype.is_complex:
                s = s + 0.3j / np.sqrt(n) * rng.normal(size=(w, n, n))
            s[0] = np.eye(n)[::-1]                # zero leading minors
            s[1] = np.roll(np.eye(n), 1, axis=0)  # cyclic permutation
            s[2] = -np.eye(n)
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
                    if inv_k.dtype != dtype:
                        raise AssertionError(f"inverse of {dtype} input "
                                             f"came back {inv_k.dtype}")
                    rel = float((inv_k - inv_p).abs().max()
                                / inv_p.abs().max())
                if not dtype.is_complex:
                    im = np.abs(ld_k.imag.cpu().numpy())
                    if not np.all((im == 0) | (np.abs(im - np.pi) < 1e-6)):
                        raise AssertionError("real log-det phase not 0/pi")
                if dre > tol * n or dim > tol * n or rel > tol:
                    raise AssertionError(
                        f"inv_logdet_lanes disagrees at {dtype} n={n} "
                        f"want_inv={want_inv}: dRe={dre:.3e} dIm={dim:.3e} "
                        f"dinv/max={rel:.3e}")
                if dtype == torch.complex64 and n == 7 and not want_inv:
                    main_err = max(dre, dim)
    return main_err


def scaled_err(a, b, s, tol) -> np.ndarray:
    """Per matrix: max|a_w - b_w| over its allowance
    max(tol, 2 n eps kappa(S_w)) max|b_w| (two stable inverses differ by
    about eps kappa |S^-1|; kappa the 2-norm condition number)."""
    n = s.shape[-1]
    eps = torch.finfo(s.dtype).eps
    kappa = np.linalg.cond(s.cpu().double().numpy())
    err = (a - b).abs().amax((1, 2)).cpu().double().numpy()
    scale = b.abs().amax((1, 2)).cpu().double().numpy()
    return err / (np.maximum(tol, 2 * n * eps * kappa) * scale)


def check_batchla_ill(batchla_cuda, rng) -> str:
    """Kernel B on ill-conditioned real input, 2 I + 0.5 N (eigenvalues
    near zero, as the sweep's real S = psi^T phi may have): the kernel
    against its plain version and against the float64 inverse, matrix by
    matrix within the error that conditioning allows. Returns a summary:
    the largest condition number, and the largest error of each float32
    inverse against the float64 one in units of eps kappa max|S^-1|."""
    out = []
    for dtype in (torch.float32, torch.float64):
        for n in (7, 18):
            s = 2.0 * np.eye(n) + 0.5 * rng.normal(size=(1031, n, n))
            s = torch.from_numpy(s).to("cuda", dtype)
            _, inv_k = batchla_cuda.inv_logdet_lanes(s)
            _, inv_p = batchla_cuda.inv_logdet_lanes_plain(s)
            truth64 = torch.linalg.inv(s.double())
            truth = truth64.to(dtype)
            torch.cuda.synchronize()
            worst = max(scaled_err(inv_k, inv_p, s, TOL[dtype]).max(),
                        scaled_err(inv_k, truth, s, TOL[dtype]).max())
            if worst > 1.0:
                raise AssertionError(
                    f"inv_logdet_lanes on ill-conditioned {dtype} n={n}: "
                    f"error {worst:.3f} of its allowance")
            if dtype == torch.float32:
                kappa = np.linalg.cond(s.cpu().double().numpy())
                eps = torch.finfo(dtype).eps

                def units(a):
                    err = (a.double() - truth64).abs().amax((1, 2))
                    err = err.cpu().numpy()
                    mx = truth64.abs().amax((1, 2)).cpu().numpy()
                    return float((err / (eps * kappa * mx)).max())
                out.append(f"n={n} max kappa {kappa.max():.4g}: kernel "
                           f"{units(inv_k):.4f}, plain {units(inv_p):.4f}")
    return "; ".join(out)


def hpd(rng, w: int, n: int) -> np.ndarray:
    phi = rng.normal(size=(w, 2 * n, n)) + 1j * rng.normal(size=(w, 2 * n, n))
    return np.conj(np.swapaxes(phi, 1, 2)) @ phi


def check_chol(batchla_cuda, rng) -> float:
    """The Cholesky-inverse kernel against its plain version, up to the
    largest n it launches (one walker per block there); returns the largest
    absolute difference at the main-path shape (complex64, n=7, w=1024)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        cap = batchla_cuda.chol_max_n(dtype)
        for n in (3, 7, 16, 24, 48, cap):
            for w in ((1, 37) if n == cap else (1, 1024, 1031)):
                s = torch.from_numpy(hpd(rng, w, n)).to("cuda", dtype)
                ld_k, l_k = batchla_cuda.chol_inv_lanes(s)
                ld_p, l_p = batchla_cuda.chol_inv_lanes_plain(s)
                torch.cuda.synchronize()
                dld = float((ld_k - ld_p).abs().max())
                dl = float((l_k - l_p).abs().max())
                if dld > tol * n or dl > tol * float(l_p.abs().max()):
                    raise AssertionError(
                        f"chol_inv_lanes disagrees at {dtype} n={n} W={w}: "
                        f"dlogdetL={dld:.3e} dLinv={dl:.3e}")
                if dtype == torch.complex64 and (n, w) == (7, 1024):
                    main_err = max(dld, dl)
    return main_err


def sweep_inputs(rng, m, na, nb, w, dtype):
    """Walkers near an orthonormal trial, the spin tables of dt=0.01, U=4,
    and a seventh of the walkers dead (weight 0)."""
    psia = np.linalg.qr(rng.normal(size=(m, na)))[0]
    psib = np.linalg.qr(rng.normal(size=(m, nb)))[0]
    phia = psia[None] + 0.1 * rng.normal(size=(w, m, na))
    phib = psib[None] + 0.1 * rng.normal(size=(w, m, nb))
    inva = np.linalg.inv(np.einsum("mi,wmj->wij", psia, phia))
    invb = np.linalg.inv(np.einsum("mi,wmj->wij", psib, phib))
    g = np.arccosh(np.exp(0.5 * 0.01 * 4.0))
    delta = np.exp(-0.02) * np.array([[np.exp(g), np.exp(-g)],
                                      [np.exp(-g), np.exp(g)]]) - 1.0
    weight = np.ones(w)
    weight[::7] = 0.0
    args = (psia, psib, delta, np.ones(2), phia, phib, inva, invb,
            rng.uniform(size=(m, w)), weight)
    return [torch.from_numpy(a).to("cuda", dtype) for a in args]


def check_sweep(sweep_cuda, rng) -> float:
    """The sweep kernel against its plain version: outputs within the
    tolerance, fields identical; returns the largest absolute difference
    at the main-path shape (float32, (16, 7, 7), W=1024)."""
    main_err = None
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for m, na, nb in ((9, 3, 3), (16, 7, 7), (9, 4, 2), (36, 18, 18)):
            for w in (1, 37, 1024, 1031):
                args = sweep_inputs(rng, m, na, nb, w, dtype)
                out_k = sweep_cuda.hirsch_sweep_real(*args)
                out_p = sweep_cuda.hirsch_sweep_real_plain(*args)
                torch.cuda.synchronize()
                err = 0.0
                for k, p in zip(out_k[:4], out_p[:4]):
                    d = float((k - p).abs().max())
                    err = max(err, d)
                    if d > tol * max(float(p.abs().max()), 1.0):
                        raise AssertionError(
                            f"hirsch_sweep disagrees at {dtype} "
                            f"(M,na,nb)=({m},{na},{nb}) W={w}: {d:.3e}")
                if not torch.equal(out_k[4], out_p[4]):
                    nd = int((out_k[4] != out_p[4]).sum())
                    raise AssertionError(
                        f"hirsch_sweep fields differ at {dtype} "
                        f"(M,na,nb)=({m},{na},{nb}) W={w}: {nd} of "
                        f"{m * w}")
                if dtype == torch.float32 and (m, na, w) == (16, 7, 1024):
                    main_err = err
    return main_err


def golden(path: str, propagator_options: dict | None, make_hubbard,
           trial_from_orbitals, AFQMC, QMCOpts):
    """Equilibrated mean ETotal of the port against the reference series:
    (port mean, reference mean, |diff|, se, seconds); raises on a miss."""
    g = np.load(os.path.join(ROOT, "tests", "data", path))
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), device="cuda",
                                dtype="single")
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    t0 = time.perf_counter()
    rows = AFQMC(ham, trial, qmc, propagator_options=propagator_options,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cuda").run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                        theirs.std(ddof=1) / np.sqrt(len(theirs))))
    diff = float(abs(mine.mean() - theirs.mean()))
    if not (np.isfinite(et).all() and diff < max(4 * se, 0.05)):
        raise AssertionError(f"golden anchor {path} missed: port "
                             f"{mine.mean()} reference {theirs.mean()} "
                             f"se {se}")
    return mine.mean(), theirs.mean(), diff, se, time.perf_counter() - t0


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
    from pauxy_tpu_torch.ops import (batchla_cuda, cuda_build, greens_cuda,
                                     sweep_cuda)
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

    def counts() -> dict:
        return {"greens_lanes": greens_cuda.launches,
                "inv_logdet_lanes": batchla_cuda.launches,
                "chol_inv_lanes": batchla_cuda.chol_launches,
                "hirsch_sweep": sweep_cuda.launches}

    def zero_counts() -> None:
        greens_cuda.launches = 0
        batchla_cuda.launches = 0
        batchla_cuda.chol_launches = 0
        sweep_cuda.launches = 0

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
    err = {"greens_lanes": check_greens(greens_cuda, rng),
           "inv_logdet_lanes": check_batchla(batchla_cuda, rng),
           "chol_inv_lanes": check_chol(batchla_cuda, rng),
           "hirsch_sweep": check_sweep(sweep_cuda, rng)}
    ill = check_batchla_ill(batchla_cuda, rng)
    m, n, w = 16, 7, 1024
    c64, f32 = torch.complex64, torch.float32
    psi = torch.from_numpy(rng.normal(size=(m, n)) + 0j).to("cuda", c64)
    phi = (psi[:, :, None] + 0.3 * torch.randn(m, n, w, dtype=c64,
                                               device="cuda")).contiguous()
    s = torch.einsum("mnw,mk->wnk", phi, psi.conj()).contiguous()
    g = torch.from_numpy(hpd(rng, w, n)).to("cuda", c64)
    sw = sweep_inputs(rng, m, n, n, w, f32)
    times = {
        "greens_lanes": median_ms({
            "plain": lambda: greens_cuda.greens_lanes_plain(psi, phi, True),
            "kernel": lambda: greens_cuda.greens_lanes(psi, phi, True)}),
        "inv_logdet_lanes": median_ms({
            "plain": lambda: batchla_cuda.inv_logdet_lanes_plain(s, False),
            "kernel": lambda: batchla_cuda.inv_logdet_lanes(s, False),
            "library": lambda: torch.linalg.slogdet(s)}),
        "chol_inv_lanes": median_ms({
            "plain": lambda: batchla_cuda.chol_inv_lanes_plain(g),
            "kernel": lambda: batchla_cuda.chol_inv_lanes(g)}),
        "hirsch_sweep": median_ms({
            "plain": lambda: sweep_cuda.hirsch_sweep_real_plain(*sw),
            "kernel": lambda: sweep_cuda.hirsch_sweep_real(*sw)}),
    }
    c8, f4 = 8, 4
    na = nb = n
    work = {   # (bytes read once + written once, FLOPs, element type)
        "greens_lanes": ((m * n + 2 * m * n * w + w) * c8,
                         w * (8 * m * n * n + gj_flops(n, 2 * n, True)
                              + 8 * m * n * n), c64),
        "inv_logdet_lanes": ((n * n * w + w) * c8,
                             w * gj_flops(n, n, True), c64),
        # The Cholesky kernel reads the lower triangle and writes L^-1
        # dense.
        "chol_inv_lanes": ((n * (n + 1) // 2 + n * n) * w * c8 + w * f4,
                           w * sum(8 * (n - k - 1) * (n - k) // 2
                                   + 2 * (n - k - 1) + 8 * k * (k + 1) // 2
                                   for k in range(n)), c64),
        "hirsch_sweep": ((m * (na + nb) + 6 + 2 * m * (na + nb) * w
                          + (na * na + nb * nb) * w + m * w + 3 * w) * f4
                         + m * w * 4,
                         w * m * sum(9 * k * k + 6 * k + 10
                                     for k in (na, nb)), f32),
    }
    bounds = {k: bound_ms(*v) for k, v in work.items()}
    say("3 kernels", "greens_lanes, inv_logdet_lanes (complex and real), "
        "chol_inv_lanes and hirsch_sweep agree with their plain versions at "
        "every shape (complex64/float32 1e-4, complex128/float64 1e-10, "
        "sweep fields identical); at the main-path shapes "
        "(greens (16,7) W=1024 c64; inv_logdet n=7 w=1024 c64 log-det only; "
        "chol n=7 w=1024 c64; sweep (16,7,7) W=1024 f32): " + "; ".join(
            f"{k} kernel {t['kernel']:.4f} ms vs plain {t['plain']:.4f} ms"
            + (f" vs torch {t['library']:.4f} ms" if "library" in t else "")
            + f", bound {bounds[k][0]:.5f} ms ({bounds[k][1]}), max abs err "
            f"{err[k]:.3e}" for k, t in times.items()))
    say("3 kernels", "inv_logdet_lanes on ill-conditioned real input "
        "(2 I + 0.5 N, 1031 matrices) within max(tol, 2 n eps kappa) of its "
        "plain version and of the float64 inverse, matrix by matrix; "
        "float32 error against the float64 inverse in units of "
        f"eps kappa max|S^-1|: {ill}")

    # ---- 4. the continuous main path at full width -----------------------
    nblocks, nsteps, nwalkers = 4, 10, 1024
    steps = nblocks * nsteps
    qmc = QMCOpts(nwalkers=nwalkers, dt=0.01, nsteps=nsteps, nblocks=nblocks,
                  nstblz=10, npop_control=1, rng_seed=8)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, qmc, estimator_options=eopts, device="cuda")
    rows = af.run()
    torch.cuda.synchronize()
    cont = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the main path: {rows}")
    want = {"greens_lanes": 6 * steps, "inv_logdet_lanes": 2,
            "chol_inv_lanes": 0, "hirsch_sweep": 0}
    if cont != want:
        raise AssertionError(f"continuous path launches {cont}, want {want}")
    timed = af.block_seconds[1:]
    rate = nwalkers * nsteps * len(timed) / sum(timed)
    say("4 main path", f"continuous, 4x4 (7,7) U=4 complex64 {nwalkers} "
        f"walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {cont}; "
        f"{rate:.1f} walker-steps/s over {len(timed)} blocks after a warm-up "
        f"block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")

    # ---- 5. continuous golden anchor -------------------------------------
    port, ref, diff, se, secs = golden(
        "hubbard4x4_uhf_continuous.npz", None, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("5 golden", f"continuous, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f} ({secs:.1f} s)")

    # ---- 6. the discrete main path at full width -------------------------
    discrete = {"hubbard_stratonovich": "discrete"}
    zero_counts()
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, qmc, propagator_options=discrete,
               estimator_options=eopts, device="cuda")
    if af.prop.sweep_kernel != "kernel":
        raise AssertionError(f"discrete sweep route {af.prop.sweep_kernel}")
    rows = af.run()
    torch.cuda.synchronize()
    disc = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the discrete path: "
                             f"{rows}")
    # Per step: kernel B 4x in the kinetic half-steps (log-det), 2x for the
    # sweep's real S^-1, 2x for the mixed energy's Green's functions; 2 at
    # set-up. Cholesky: 2 spins x 2 passes per re-orthogonalisation.
    want = {"greens_lanes": 0, "inv_logdet_lanes": 2 + 8 * steps,
            "chol_inv_lanes": 4 * (steps // 10), "hirsch_sweep": steps}
    if disc != want:
        raise AssertionError(f"discrete path launches {disc}, want {want}")
    timed = af.block_seconds[1:]
    rate_d = nwalkers * nsteps * len(timed) / sum(timed)
    say("6 discrete path", f"discrete spin HS, single-site sweep, 4x4 (7,7) "
        f"U=4 complex64 {nwalkers} walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {disc}; "
        f"{rate_d:.1f} walker-steps/s over {len(timed)} blocks after a "
        f"warm-up block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")

    # ---- 7. discrete golden anchor ---------------------------------------
    port, ref, diff, se, secs = golden(
        "hubbard4x4_uhf_discrete.npz", discrete, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("7 discrete golden", f"discrete, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f} ({secs:.1f} s)")

    # ---- result ----------------------------------------------------------
    print(nvidia_smi())
    meta = {
        "greens_lanes": ("pauxy_tpu_torch/csrc/greens.cu",
                         "pauxy_tpu/ops/greens_pallas.py:61"),
        "inv_logdet_lanes": ("pauxy_tpu_torch/csrc/batchla.cu",
                             "pauxy_tpu/ops/batchla_pallas.py:135"),
        "chol_inv_lanes": ("pauxy_tpu_torch/csrc/chol_inv.cu",
                           "pauxy_tpu/ops/batchla_pallas.py:255"),
        "hirsch_sweep": ("pauxy_tpu_torch/csrc/sweep.cu",
                         "pauxy_tpu/ops/sweep_pallas.py:54"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": cont[k] + disc[k],
         "launches_by_path": {"continuous": cont[k], "discrete": disc[k]},
         "max_abs_err": err[k],
         "ms": times[k]["kernel"], "plain_ms": times[k]["plain"],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": times[k].get("library")}
        for k, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
