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
     same criterion;
  8. the Generic (Cholesky ab-initio) main path at the bench shape
     (bench.py:301-330: nmo=128, naux=512, (16, 16), random seed-7
     Hamiltonian), RHF-identity trial, complex64, 1024 walkers, dt=0.005,
     re-orthogonalisation every 5 steps, comb population control, the mixed
     energy every step and taylor_impl="pallas", through AFQMC(...).run():
     finite output and the launches of the step schedule (the Taylor kernel
     once a step; no exchange kernel, the supermatrix exists);
  9. the same path past the supermatrix cap: nmo=228, naux=1024, (42, 42)
     (the size class of a benzene dimer in cc-pVDZ), 256 walkers, the
     energy once a block: the exchange kernel twice per energy evaluation;
 10. the Generic golden system (tests/data/generic_nmo11.npz, 40 walkers,
     complex64, taylor_impl="pallas"): first 10 blocks on the card with
     injected draws against the port's complex128 run of the same draws on
     the host, block by block within 2e-4 (float32 rounding); then, as a
     sanity check, the golden anchor over 100 blocks, |diff| <
     max(4 se, 0.02) over the last two thirds. This anchor's block series
     are strongly autocorrelated (the JAX package misses its naive se at
     two of three seeds), so se combines the spread of 8 independent runs'
     means with the reference series' reblocked se.
Each phase line ends with its seconds. Then the card's name and power limit
(nvidia-smi), one JSON line about the kernels, and last
{"ok": true, "device": {...}}.
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


C8, F4 = 8, 4   # bytes of a complex64 and of a float32


def greens_work(m: int, n: int, w: int):
    """(bytes read once + written once, FLOPs, element type) of kernel A:
    S = phi^T psi*, its inverse and log-det, ghT."""
    return ((m * n + 2 * m * n * w + w) * C8,
            w * (8 * m * n * n + gj_flops(n, 2 * n, True) + 8 * m * n * n),
            torch.complex64)


def batchla_work(n: int, w: int, want_inv: bool):
    """Kernel B: S in, the log-det (and the inverse) out; Gauss-Jordan on
    [S | I] for the inverse, on S alone for the log-det."""
    return ((n * n * w * (2 if want_inv else 1) + w) * C8,
            w * gj_flops(n, 2 * n if want_inv else n, True), torch.complex64)


def chol_work(n: int, w: int):
    """The Cholesky kernel reads the lower triangle and writes L^-1 dense
    and log det L."""
    return ((n * (n + 1) // 2 + n * n) * w * C8 + w * F4,
            w * sum(8 * (n - k - 1) * (n - k) // 2 + 2 * (n - k - 1)
                    + 8 * k * (k + 1) // 2 for k in range(n)),
            torch.complex64)


def sweep_work(m: int, na: int, nb: int, w: int):
    return ((m * (na + nb) + 6 + 2 * m * (na + nb) * w
             + (na * na + nb * nb) * w + m * w + 3 * w) * F4 + m * w * 4,
            w * m * sum(9 * k * k + 6 * k + 10 for k in (na, nb)),
            torch.float32)


def taylor_work(m: int, c: int, w: int):
    """VHS and phi read once, the result written once; 6 orders of a
    complex [M, M] x [M, C] product (8 FLOPs a multiply-add)."""
    return ((w * m * m + 2 * w * m * c) * C8, 6 * 8 * m * m * c * w,
            torch.complex64)


def exx_work(x: int, n: int, m: int, w: int):
    """rchol (real) and Ghalf read once, exx written once; the T builds
    (real x complex: 4 FLOPs a multiply-add) and the products."""
    return (x * n * m * F4 + w * n * m * C8 + w * C8,
            w * x * (4 * n * n * m + 8 * n * n), torch.complex64)


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
    including matrices that need pivoting and negative determinants, up to
    the Generic paths' shapes (n=16 with 1024 walkers, n=42 with 256);
    returns the largest absolute difference at the main-path shape
    (complex64, n=7, w=1024, log-det only)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        tol = TOL[dtype]
        for n, w in ((3, 1024), (7, 1024), (16, 1024), (18, 1024),
                     (24, 1024), (42, 256)):
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
    largest n it launches (one walker per block there) and at the Generic
    paths' shapes (n=16 with 1024 walkers, n=42 with 256); returns the
    largest absolute difference at the main-path shape (complex64, n=7,
    w=1024)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        tol = TOL[dtype]
        cap = batchla_cuda.chol_max_n(dtype)
        for n in (3, 7, 16, 24, 42, 48, cap):
            ws = {cap: (1, 37), 42: (1, 256)}.get(n, (1, 1024, 1031))
            for w in ws:
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


TAYLOR_SHAPES = ((16, 14), (128, 32), (228, 84))
# The listed exchange shapes, then two whose walker exceeds a block's
# shared memory (the kernel stages column chunks; n = 130 takes its pair
# tiles in several rounds).
EXX_SHAPES = ((30, 3, 12), (512, 16, 128), (1024, 42, 228), (8, 60, 500),
              (4, 130, 200))
# The exchange kernel against its plain version computed in float64 on the
# same inputs, per walker, in units of S_w. The float32 plain version is no
# yardstick at this scale: its reduction of X n^2 same-sign products in
# long float32 sums errs by up to ~1e-5 S_w on coherent inputs, where the
# kernel's short per-thread sums err by ~2e-7 S_w (an emulation of its
# summation order in numpy at (1024, 42, 228)). A kernel that drops one of
# X Cholesky vectors misses by about S_w / X on coherent inputs (1e-3 at
# X = 1024) and S_w / (X n) on random phases.
EXX_TOL = {torch.complex64: 5e-6, torch.complex128: 1e-13}
RDTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def taylor_inputs(gen, w, m, ncol, dtype):
    """VHS of spectral norm ~0.6 (as the bench shape's) and walkers."""
    vhs = (0.3 / m ** 0.5) * torch.randn((w, m, m), generator=gen,
                                         dtype=dtype, device="cuda")
    phi = torch.randn((w, m, ncol), generator=gen, dtype=dtype,
                      device="cuda")
    return vhs, phi


def exx_inputs(gen, x, n, m, w, dtype, coherent=False):
    """Random phases (exx cancels: |exx_w| << S_w) or coherent ones (real
    positive rchol, Ghalf near real positive: |exx_w| ~ S_w)."""
    rc = torch.randn((x, n, m), generator=gen, dtype=RDTYPE[dtype],
                     device="cuda") / m ** 0.5
    gh = torch.randn((w, n, m), generator=gen, dtype=dtype, device="cuda")
    if coherent:
        rc = rc.abs()
        gh = (gh.real.abs() + 0.1j * gh.imag).to(dtype)
    return rc, gh


def check_taylor(taylor_cuda, gen) -> float:
    """The Taylor kernel against its plain version: max|d| <= tol max|out|;
    returns the largest absolute difference at the main-path shape
    ((M, C) = (128, 32), w=1024, complex64)."""
    main_err = None
    for dtype in (torch.complex64, torch.complex128):
        for m, ncol in TAYLOR_SHAPES:
            for w in (1, 37, 1024):
                vhs, phi = taylor_inputs(gen, w, m, ncol, dtype)
                out_k = taylor_cuda.apply_taylor(vhs, phi)
                out_p = taylor_cuda.apply_taylor_plain(vhs, phi)
                torch.cuda.synchronize()
                err = float((out_k - out_p).abs().max())
                if err > TOL[dtype] * float(out_p.abs().max()):
                    raise AssertionError(
                        f"apply_taylor disagrees at {dtype} (M,C)=({m},"
                        f"{ncol}) w={w}: {err:.3e}")
                if dtype == torch.complex64 and (m, w) == (128, 1024):
                    main_err = err
                del vhs, phi, out_k, out_p
    return main_err


def check_exx(exx_cuda, gen) -> tuple[float, dict]:
    """The exchange kernel against its plain version in float64, walker by
    walker: |d_w| <= EXX_TOL S_w, S_w = sum_x sum_ij |T_ij||T_ji|, on
    random-phase and coherent inputs; the same bits on a second launch; and
    on coherent inputs the same inputs without their first Cholesky vector
    (what a kernel that drops one vector returns) must miss the allowance
    (on random phases that reading is recorded). Returns the largest
    absolute difference at the main-path shape ((X, n, M) = (1024, 42, 228),
    w=256, complex64, random phases) and, by type, the largest reading
    max_w |d_w| / S_w of the kernel and of the plain version in its own
    type, and the smallest readings of the dropped vector on random and
    coherent phases."""
    main_err = None
    readings = {}
    for dtype in (torch.complex64, torch.complex128):
        sound, plain, dropped = 0.0, 0.0, [float("inf"), float("inf")]
        for x, n, m in EXX_SHAPES:
            for coherent in (False, True):
                for w in (1, 37, 256):
                    rc, gh = exx_inputs(gen, x, n, m, w, dtype, coherent)
                    out_k = exx_cuda.exx(rc, gh)
                    again = exx_cuda.exx(rc, gh)
                    drop = exx_cuda.exx(rc[1:].contiguous(), gh)
                    out_p = exx_cuda.exx_plain(rc.double(),
                                               gh.to(torch.complex128))
                    own = exx_cuda.exx_plain(rc, gh)
                    scale = exx_cuda.exx_magnitude(rc, gh)
                    torch.cuda.synchronize()
                    err = (out_k - out_p).abs()
                    reading = float((err / scale).max())
                    plain = max(plain, float(((own - out_p).abs()
                                              / scale).max()))
                    miss = float(((drop - out_p).abs() / scale).max())
                    where = (f"{dtype} (X,n,M)=({x},{n},{m}) w={w} "
                             f"coherent={coherent}")
                    if reading > EXX_TOL[dtype]:
                        raise AssertionError(f"exx disagrees at {where}: "
                                             f"max |d_w|/S_w {reading:.3e}")
                    if coherent and miss <= EXX_TOL[dtype]:
                        raise AssertionError(f"exx criterion misses a "
                                             f"dropped vector at {where}: "
                                             f"{miss:.3e}")
                    if not torch.equal(out_k, again):
                        raise AssertionError(f"exx not reproducible at "
                                             f"{where}")
                    sound = max(sound, reading)
                    dropped[coherent] = min(dropped[coherent], miss)
                    if (dtype == torch.complex64 and (x, w) == (1024, 256)
                            and not coherent):
                        main_err = float(err.max())
        readings[str(dtype).split(".")[-1]] = (sound, plain, dropped)
    return main_err, readings


def generic_model(nmo: int, naux: int, nel: int, make_generic):
    """bench.py:317-330's random Hamiltonian (numpy default_rng(7), chol
    scale 0.01 and h1 scale 0.1, both symmetrised, ecore 0) on the card in
    complex64/float32."""
    rng = np.random.default_rng(7)
    chol = rng.normal(scale=0.01, size=(nmo, nmo, naux))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.1, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    return make_generic((nel, nel), np.stack([h1, h1]), chol, ecore=0.0,
                        device="cuda", dtype="single")


def reblocked_se(x: np.ndarray) -> float:
    """Standard error of a correlated series by Flyvbjerg-Petersen
    blocking, at the first level where successive estimates agree within
    their errors (pauxy_tpu/analysis/blocking.py's rule)."""
    x = np.asarray(x, dtype=float)
    ses, errs = [], []
    while len(x) >= 2:
        se = x.std(ddof=1) / np.sqrt(len(x))
        ses.append(se)
        errs.append(se / np.sqrt(2.0 * (len(x) - 1)))
        if len(x) < 4:
            break
        x = 0.5 * (x[: len(x) // 2 * 2: 2] + x[1: len(x) // 2 * 2: 2])
    for i in range(len(ses) - 1):
        if abs(ses[i + 1] - ses[i]) <= errs[i + 1] + errs[i]:
            return ses[i]
    return ses[-1]


def injected_blocks(af, xi: np.ndarray, pop: np.ndarray, nblocks: int,
                    run_block, BlockNoise, mixed) -> np.ndarray:
    """Per block (ETotal, summed unscaled weight) of ``af``'s path driven
    through run_block with injected draws: xi [nblocks * nsteps, w, X]
    fields and pop [nblocks * nsteps, 1] comb uniforms; the shift held at
    the trial energy."""
    q = af.qmc
    dev, rdt = af.state.weight.device, af.state.weight.dtype
    state, out = af.state, []
    for b in range(nblocks):
        steps = slice(b * q.nsteps, (b + 1) * q.nsteps)
        noise = BlockNoise(torch.from_numpy(xi[steps]).to(dev, rdt),
                           torch.from_numpy(pop[steps]).to(dev, rdt))
        state, acc = run_block(
            af.ham, af.trial, af.prop, state, None, float(af.trial.etrial),
            b * q.nsteps, nsteps=q.nsteps, nstblz=q.nstblz,
            npop_control=q.npop_control, pop_method=q.pop_control_method,
            target_weight=float(q.nwalkers), energy_eval_freq=1, noise=noise)
        z = acc.cpu().double().numpy()
        z = z[0] + 1j * z[1]
        out.append(((z[mixed.ENUMER] / z[mixed.EDENOM]).real,
                    z[mixed.UWEIGHT].real))
    return np.array(out)


def golden(path: str, propagator_options: dict | None, make_hubbard,
           trial_from_orbitals, AFQMC, QMCOpts):
    """Equilibrated mean ETotal of the port against the reference series:
    (port mean, reference mean, |diff|, se); raises on a miss."""
    g = np.load(os.path.join(ROOT, "tests", "data", path))
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), device="cuda",
                                dtype="single")
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
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
    return mine.mean(), theirs.mean(), diff, se


def main() -> None:
    seconds = {}
    t_phase = time.perf_counter()

    def lap(phase: str) -> str:
        """Seconds since the last lap, recorded under ``phase``."""
        nonlocal t_phase
        now = time.perf_counter()
        seconds[phase] = round(now - t_phase, 1)
        t_phase = now
        return f" ({seconds[phase]} s)"

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
    from pauxy_tpu_torch.estimators import local_energy, mixed
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_hubbard, rhf_identity_trial,
                                        trial_from_orbitals)
    from pauxy_tpu_torch.models import trial as trial_module
    from pauxy_tpu_torch.ops import (batchla_cuda, cuda_build, exx_cuda,
                                     greens_cuda, sweep_cuda, taylor_cuda)
    from pauxy_tpu_torch.propagation.generic import apply_exponential_taylor
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "pauxy_tpu")]
    if bad:
        raise SystemExit(f"chip_smoke: JAX modules imported: {bad}")
    card = nvidia_smi()
    say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"nvidia-smi: {card}" + lap("1"))

    def counts() -> dict:
        return {"greens_lanes": greens_cuda.launches,
                "inv_logdet_lanes": batchla_cuda.launches,
                "chol_inv_lanes": batchla_cuda.chol_launches,
                "hirsch_sweep": sweep_cuda.launches,
                "taylor_exp": taylor_cuda.launches,
                "exx": exx_cuda.launches}

    def zero_counts() -> None:
        greens_cuda.launches = 0
        batchla_cuda.launches = 0
        batchla_cuda.chol_launches = 0
        sweep_cuda.launches = 0
        taylor_cuda.launches = 0
        exx_cuda.launches = 0

    def only(**nonzero) -> dict:
        want = dict.fromkeys(counts(), 0)
        want.update(nonzero)
        return want

    # ---- 2. build --------------------------------------------------------
    path, nvcc_s = cuda_build.build()
    cuda_build.library()
    log = path.with_suffix(".log")
    usage = []
    if log.exists():
        usage = [line.split("ptxas info    : ")[-1] for line in
                 log.read_text().splitlines() if "Used" in line]
    say("2 build", f"{os.path.relpath(path, ROOT)} nvcc {nvcc_s:.1f}s "
        f"(0 = cached); " + " | ".join(usage) + lap("2"))

    # ---- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(2024)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    exx_err, exx_readings = check_exx(exx_cuda, gen)
    err = {"greens_lanes": check_greens(greens_cuda, rng),
           "inv_logdet_lanes": check_batchla(batchla_cuda, rng),
           "chol_inv_lanes": check_chol(batchla_cuda, rng),
           "hirsch_sweep": check_sweep(sweep_cuda, rng),
           "taylor_exp": check_taylor(taylor_cuda, gen),
           "exx": exx_err}
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
    # Taylor at the bench shape; the yardstick is the port's own "xla"
    # route (six batched matmuls, the JAX default).
    tm, tc, tw = 128, 32, 1024
    vt, pt = taylor_inputs(gen, tw, tm, tc, torch.complex64)
    times["taylor_exp"] = median_ms({
        "plain": lambda: taylor_cuda.apply_taylor_plain(vt, pt),
        "kernel": lambda: taylor_cuda.apply_taylor(vt, pt),
        "library": lambda: apply_exponential_taylor(vt, pt)})
    # exx past the cap (the path that runs it); the yardstick is the einsum
    # route, which is also the plain version.
    ex, en, em, ew = 1024, 42, 228, 256
    rce, ghe = exx_inputs(gen, ex, en, em, ew, torch.complex64)
    times["exx"] = median_ms({
        "plain": lambda: exx_cuda.exx_plain(rce, ghe),
        "kernel": lambda: exx_cuda.exx(rce, ghe),
        "library": lambda: exx_cuda.exx_plain(rce, ghe)}, reps=5)
    del rce, ghe
    work = {
        "greens_lanes": greens_work(m, n, w),
        "inv_logdet_lanes": batchla_work(n, w, False),
        "chol_inv_lanes": chol_work(n, w),
        "hirsch_sweep": sweep_work(m, n, n, w),
        "taylor_exp": taylor_work(tm, tc, tw),
        "exx": exx_work(ex, en, em, ew),
    }
    bounds = {k: bound_ms(*v) for k, v in work.items()}

    # The other shapes the main paths give the kernels (complex64): kernel
    # B and the Cholesky kernel on the Generic paths (n=16 with 1024
    # walkers, n=42 with 256), Taylor past the cap, exx at the bench shape
    # (with the supermatrix GEMM that the path takes there).
    at_shapes = {k: [] for k in times}

    def at_shape(kernel, shape, fns, wk, reps=25):
        t = median_ms(fns, reps)
        bnd = bound_ms(*wk)
        at_shapes[kernel].append({
            "shape": shape, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t.get("library"), "bound_ms": bnd[0],
            "bound_by": bnd[1], **{k: v for k, v in t.items()
                                   if k not in ("kernel", "plain",
                                                "library")}})

    for gn, gw in ((16, 1024), (42, 256)):
        sg = torch.from_numpy(2.0 * np.eye(gn) + 0.3 / np.sqrt(gn) * (
            rng.normal(size=(gw, gn, gn))
            + 1j * rng.normal(size=(gw, gn, gn)))).to("cuda", c64)
        for want_inv in (True, False):
            fns = {"plain": lambda: batchla_cuda.inv_logdet_lanes_plain(
                       sg, want_inv),
                   "kernel": lambda: batchla_cuda.inv_logdet_lanes(
                       sg, want_inv)}
            if not want_inv:
                fns["library"] = lambda: torch.linalg.slogdet(sg)
            at_shape("inv_logdet_lanes",
                     f"n={gn} w={gw} c64 "
                     + ("inverse+log-det" if want_inv else "log-det only"),
                     fns, batchla_work(gn, gw, want_inv))
        hg = torch.from_numpy(hpd(rng, gw, gn)).to("cuda", c64)
        at_shape("chol_inv_lanes", f"n={gn} w={gw} c64",
                 {"plain": lambda: batchla_cuda.chol_inv_lanes_plain(hg),
                  "kernel": lambda: batchla_cuda.chol_inv_lanes(hg)},
                 chol_work(gn, gw))
    vb, pb = taylor_inputs(gen, 256, 228, 84, torch.complex64)
    at_shape("taylor_exp", "(M,C)=(228,84) w=256 c64",
             {"plain": lambda: taylor_cuda.apply_taylor_plain(vb, pb),
              "kernel": lambda: taylor_cuda.apply_taylor(vb, pb),
              "library": lambda: apply_exponential_taylor(vb, pb)},
             taylor_work(228, 84, 256), reps=10)
    del vb, pb
    rcs, ghs = exx_inputs(gen, 512, 16, 128, 1024, torch.complex64)
    sup = torch.from_numpy(
        trial_module._exx_supermatrix(rcs.cpu().numpy())).to("cuda", f32)
    at_shape("exx", "(X,n,M)=(512,16,128) w=1024 c64",
             {"plain": lambda: exx_cuda.exx_plain(rcs, ghs),
              "kernel": lambda: exx_cuda.exx(rcs, ghs),
              "library": lambda: exx_cuda.exx_plain(rcs, ghs),
              "supermatrix_ms": lambda: local_energy._exx(rcs, ghs, sup)},
             exx_work(512, 16, 128, 1024), reps=10)
    sup_err = float((local_energy._exx(rcs, ghs, sup)
                     - exx_cuda.exx(rcs, ghs)).abs().max()
                    / exx_cuda.exx_magnitude(rcs, ghs).max())
    del rcs, ghs, sup
    say("3 kernels", "greens_lanes, inv_logdet_lanes (complex and real), "
        "chol_inv_lanes and hirsch_sweep agree with their plain versions at "
        "every shape (complex64/float32 1e-4, complex128/float64 1e-10, "
        "sweep fields identical); at the main-path shapes "
        "(greens (16,7) W=1024 c64; inv_logdet n=7 w=1024 c64 log-det only; "
        "chol n=7 w=1024 c64; sweep (16,7,7) W=1024 f32; taylor (128,32) "
        "w=1024 c64 with the xla route as library call; exx (1024,42,228) "
        "w=256 c64 with the einsum route as library call): " + "; ".join(
            f"{k} kernel {t['kernel']:.4f} ms vs plain {t['plain']:.4f} ms"
            + (f" vs library {t['library']:.4f} ms" if "library" in t
               else "")
            + f", bound {bounds[k][0]:.5f} ms ({bounds[k][1]}), max abs err "
            f"{err[k]:.3e}" for k, t in times.items()))
    say("3 kernels", "at the other main-path shapes (kernel / plain / "
        "library / bound ms): " + "; ".join(
            f"{k} {e['shape']} {e['ms']:.4f} / {e['plain_ms']:.4f} / "
            + (f"{e['library_ms']:.4f}" if e["library_ms"] is not None
               else "none")
            + f" / {e['bound_ms']:.5f} ({e['bound_by']})"
            + (f" supermatrix GEMM {e['supermatrix_ms']:.4f}"
               if "supermatrix_ms" in e else "")
            for k, es in at_shapes.items() for e in es)
        + f" (supermatrix vs kernel max |d|/S {sup_err:.3e})")
    say("3 kernels", "apply_taylor at (M,C) in {(16,14),(128,32),(228,84)} "
        "w in {1,37,1024} agrees with its plain version (max|d| <= tol "
        "max|out|); exx at (X,n,M) in {(30,3,12),(512,16,128),"
        "(1024,42,228),(8,60,500),(4,130,200)} w in {1,37,256}, random and "
        "coherent phases, agrees walker by walker with its plain version in "
        "float64 (|d_w| <= tol S_w, tol 5e-6 c64 / 1e-13 c128), is "
        "bit-identical on a second launch, and "
        "on coherent inputs the same inputs less one Cholesky vector miss "
        "the allowance; readings max_w |d_w|/S_w (largest: kernel, plain "
        "version in its own type) and dropped vector (smallest, random / "
        "coherent phases): " + "; ".join(
            f"{k} {a:.3e}, {p:.3e} vs {b[0]:.3e} / {b[1]:.3e}"
            for k, (a, p, b) in exx_readings.items()))
    say("3 kernels", "inv_logdet_lanes on ill-conditioned real input "
        "(2 I + 0.5 N, 1031 matrices) within max(tol, 2 n eps kappa) of its "
        "plain version and of the float64 inverse, matrix by matrix; "
        "float32 error against the float64 inverse in units of "
        f"eps kappa max|S^-1|: {ill}" + lap("3"))
    del vt, pt

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
    want = only(greens_lanes=6 * steps, inv_logdet_lanes=2)
    if cont != want:
        raise AssertionError(f"continuous path launches {cont}, want {want}")
    timed = af.block_seconds[1:]
    rate = nwalkers * nsteps * len(timed) / sum(timed)
    say("4 main path", f"continuous, 4x4 (7,7) U=4 complex64 {nwalkers} "
        f"walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {cont}; "
        f"{rate:.1f} walker-steps/s over {len(timed)} blocks after a warm-up "
        f"block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})" + lap("4"))

    # ---- 5. continuous golden anchor -------------------------------------
    port, ref, diff, se = golden(
        "hubbard4x4_uhf_continuous.npz", None, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("5 golden", f"continuous, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f}" + lap("5"))

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
    want = only(inv_logdet_lanes=2 + 8 * steps,
                chol_inv_lanes=4 * (steps // 10), hirsch_sweep=steps)
    if disc != want:
        raise AssertionError(f"discrete path launches {disc}, want {want}")
    timed = af.block_seconds[1:]
    rate_d = nwalkers * nsteps * len(timed) / sum(timed)
    say("6 discrete path", f"discrete spin HS, single-site sweep, 4x4 (7,7) "
        f"U=4 complex64 {nwalkers} walkers {steps} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=4)}; launches {disc}; "
        f"{rate_d:.1f} walker-steps/s over {len(timed)} blocks after a "
        f"warm-up block (block seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})" + lap("6"))

    # ---- 7. discrete golden anchor ---------------------------------------
    port, ref, diff, se = golden(
        "hubbard4x4_uhf_discrete.npz", discrete, make_hubbard,
        trial_from_orbitals, AFQMC, QMCOpts)
    say("7 discrete golden", f"discrete, UHF trial, 40 walkers, 100 blocks, "
        f"complex64: port {port:.6f} vs reference {ref:.6f}, |diff| "
        f"{diff:.6f} < max(4 se, 0.05) with se {se:.6f}" + lap("7"))

    # ---- 8. the Generic main path at the bench shape ---------------------
    pallas = {"taylor_impl": "pallas"}
    gq = QMCOpts(nwalkers=1024, dt=0.005, nsteps=10, nblocks=4, nstblz=5,
                 npop_control=1, rng_seed=8)
    gsteps = gq.nblocks * gq.nsteps
    zero_counts()
    ham = generic_model(128, 512, 16, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, gq, propagator_options=pallas,
               estimator_options=eopts, device="cuda")
    if trial.exx_supera is None or af.prop.inner.taylor_impl != "pallas":
        raise AssertionError("bench shape: no supermatrix or not the kernel")
    rows = af.run()
    torch.cuda.synchronize()
    gen_counts = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output on the Generic path: {rows}")
    # Per step: Taylor 1; kernel B 2 for the Green's functions, 2 for the
    # new overlaps, 2 for the energy; 2 at set-up. Cholesky: 2 spins x 2
    # passes per re-orthogonalisation (every 5 steps).
    want = only(taylor_exp=gsteps, inv_logdet_lanes=2 + 6 * gsteps,
                chol_inv_lanes=4 * (gsteps // gq.nstblz))
    if gen_counts != want:
        raise AssertionError(f"Generic path launches {gen_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_g = gq.nwalkers * gq.nsteps * len(timed) / sum(timed)
    say("8 Generic path", f"nmo=128 naux=512 (16,16) RHF complex64 "
        f"taylor_impl=pallas {gq.nwalkers} walkers {gsteps} steps: ETotal "
        f"per block {np.array2string(rows[:, 5].real, precision=5)} (etrial "
        f"{trial.etrial:.5f}); launches {gen_counts}; {rate_g:.1f} "
        f"walker-steps/s over {len(timed)} blocks after a warm-up block "
        f"(block seconds {', '.join(f'{t:.4f}' for t in af.block_seconds)})"
        + lap("8"))
    del ham, trial, af

    # ---- 9. Generic past the supermatrix cap -----------------------------
    xq = QMCOpts(nwalkers=256, dt=0.005, nsteps=10, nblocks=3, nstblz=5,
                 npop_control=1, rng_seed=8)
    xsteps = xq.nblocks * xq.nsteps
    zero_counts()
    ham = generic_model(228, 1024, 42, make_generic)
    trial = rhf_identity_trial(ham, device="cuda", dtype="single")
    af = AFQMC(ham, trial, xq, propagator_options=pallas, device="cuda")
    setup_s = time.perf_counter() - t_phase
    if trial.exx_supera is not None or trial.exx_superb is not None:
        raise AssertionError("past the cap the trial has a supermatrix")
    rows = af.run()
    torch.cuda.synchronize()
    exx_counts = counts()
    if not (np.isfinite(rows.real).all()
            and bool(torch.isfinite(af.state.weight).all())):
        raise AssertionError(f"non-finite output past the cap: {rows}")
    nenergy = xsteps // af.energy_eval_freq
    want = only(taylor_exp=xsteps, exx=2 * nenergy,
                inv_logdet_lanes=2 + 4 * xsteps + 2 * nenergy,
                chol_inv_lanes=4 * (xsteps // xq.nstblz))
    if exx_counts != want:
        raise AssertionError(f"past-the-cap launches {exx_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_x = xq.nwalkers * xq.nsteps * len(timed) / sum(timed)
    say("9 Generic past the cap", f"nmo=228 naux=1024 (42,42) RHF "
        f"complex64 taylor_impl=pallas {xq.nwalkers} walkers {xsteps} steps, "
        f"energy every {af.energy_eval_freq} steps: ETotal per block "
        f"{np.array2string(rows[:, 5].real, precision=5)} (etrial "
        f"{trial.etrial:.5f}); launches {exx_counts}; {rate_x:.1f} "
        f"walker-steps/s over {len(timed)} blocks after a warm-up block "
        f"(block seconds {', '.join(f'{t:.4f}' for t in af.block_seconds)}; "
        f"set-up {setup_s:.1f} s)" + lap("9"))
    del ham, trial, af

    # ---- 10. Generic golden anchor ---------------------------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "generic_nmo11.npz"))
    nmo = g["h1e"].shape[-1]
    golden_qmc = dict(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                      nsteps=int(g["nsteps"]), nstblz=10, npop_control=1)

    def golden_generic(device, dtype, nblocks=100, rng_seed=8):
        ham = make_generic((3, 3), np.stack([g["h1e"], g["h1e"]]),
                           np.asarray(g["chol"]).reshape(-1, nmo, nmo)
                           .transpose(1, 2, 0), ecore=float(g["enuc"]),
                           device=device, dtype=dtype)
        trial = trial_from_orbitals(ham, np.asarray(g["psi"]),
                                    device=device, dtype=dtype)
        return AFQMC(ham, trial, QMCOpts(nblocks=nblocks, rng_seed=rng_seed,
                                         **golden_qmc),
                     propagator_options=pallas, estimator_options=eopts,
                     device=device)

    # The card's complex64 path (kernels) against the port's complex128 path
    # on the host (plain versions) with the same injected draws, block by
    # block. Limit: float32's unit roundoff 6e-8 times ~30 chained rounding
    # steps per walker step times the 100 steps, 2e-4 of the block values'
    # scale (the same comparison between the port's complex64 and complex128
    # paths on a host reads 7.6e-7).
    tb = 10
    draws = np.random.default_rng(10)
    nx = g["chol"].shape[0]
    xi = draws.normal(size=(tb * golden_qmc["nsteps"],
                            golden_qmc["nwalkers"], nx))
    pop = draws.uniform(size=(tb * golden_qmc["nsteps"], 1))
    zero_counts()
    card = injected_blocks(golden_generic("cuda", "single", tb), xi, pop, tb,
                           run_block, BlockNoise, mixed)
    tight_counts = counts()
    host = injected_blocks(golden_generic("cpu", "double", tb), xi, pop, tb,
                           run_block, BlockNoise, mixed)
    tight = (np.abs(card - host).max(axis=0)
             / np.abs(host).max(axis=0)).max()
    if tight_counts["taylor_exp"] != tb * golden_qmc["nsteps"]:
        raise AssertionError(f"Generic golden system on the card: launches "
                             f"{tight_counts}")
    if not (np.isfinite(card).all() and tight <= 2e-4):
        raise AssertionError(f"Generic golden system: complex64 on the card "
                             f"{card.tolist()} vs complex128 on the host "
                             f"{host.tolist()}: {tight:.3e} > 2e-4")
    say("10 Generic golden", f"nmo=11 (3,3), 40 walkers, {tb} blocks with "
        f"injected draws: complex64 on the card (launches {tight_counts}) vs "
        f"complex128 on the host, block ETotal "
        f"{np.array2string(card[:, 0], precision=6)} vs "
        f"{np.array2string(host[:, 0], precision=6)}: max |d| over the "
        f"block values' scale (ETotal, unscaled weight) {tight:.3e} <= 2e-4")
    ref = np.asarray(g["etotal_blocks"])
    theirs = ref[len(ref) // 3:]
    means = []
    for seed in range(8, 16):
        rows = golden_generic("cuda", "single", rng_seed=seed).run()
        et = rows[:, 5].real
        if not np.isfinite(et).all():
            raise AssertionError(f"Generic golden: non-finite ETotal {et}")
        mine = et[len(et) // 3:]
        if seed == 8:
            naive = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                                   theirs.std(ddof=1)
                                   / np.sqrt(len(theirs))))
            first = float(mine.mean())
        means.append(float(mine.mean()))
    port = float(np.mean(means))
    se = float(np.hypot(np.std(means, ddof=1) / np.sqrt(len(means)),
                        reblocked_se(theirs)))
    diff = abs(port - float(theirs.mean()))
    if not diff < max(4 * se, 0.02):
        raise AssertionError(f"Generic golden missed: port {port} "
                             f"(runs {means}) reference {theirs.mean()} "
                             f"se {se}")
    say("10 Generic golden", f"sanity check: nmo=11 (3,3), 40 walkers, 100 "
        f"blocks, complex64, taylor_impl=pallas, {len(means)} runs (seeds "
        f"8-15): "
        f"port {port:.6f} (run means "
        f"{', '.join(f'{m:.4f}' for m in means)}) vs reference "
        f"{theirs.mean():.6f}, |diff| {diff:.6f} < max(4 se, 0.02) with se "
        f"{se:.6f} (run spread and reference reblocked); seed 8 alone "
        f"{first:.6f}, |diff| {abs(first - theirs.mean()):.6f} against "
        f"4 x naive se {4 * naive:.6f}" + lap("10"))
    say("seconds", json.dumps(seconds))

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
        "taylor_exp": ("pauxy_tpu_torch/csrc/taylor.cu",
                       "pauxy_tpu/ops/taylor_pallas.py:47"),
        "exx": ("pauxy_tpu_torch/csrc/exx.cu",
                "pauxy_tpu/ops/exx_pallas.py:36"),
    }
    by_path = {"continuous": cont, "discrete": disc, "generic": gen_counts,
               "generic_exx": exx_counts}
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[k] for c in by_path.values()),
         "launches_by_path": {p: c[k] for p, c in by_path.items()},
         "max_abs_err": err[k],
         "ms": times[k]["kernel"], "plain_ms": times[k]["plain"],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": times[k].get("library"), "at_shapes": at_shapes[k]}
        for k, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
