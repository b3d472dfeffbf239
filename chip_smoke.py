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
 11. the finite-temperature UEG path at the bench shape (bench.py:692-716:
     make_ueg(7, 7, rs=1, ecut=4), M=93, 1500 fields; the one-body trial at
     beta=2, dt=0.05, mu=0.9, 40 slices in 4 bins of 10), complex64, 256
     walkers, population control every slice, through
     ThermalAFQMC(...).run(): every row finite, Nav > 0, the cpqr kernel
     and kernel B launched as often as the slice schedule says, and
     walker-slice-steps/s over the paths after a warm-up path; then one
     path of 16 walkers at M=93 with injected draws, complex64 on the card
     against complex128 on the host (ETotal and Nav within float32
     rounding);
 12. the finite-temperature Hubbard path: 3x3, U=4, mu=0.9, beta=0.5,
     dt=0.05, 32 walkers, population control every 2 slices, complex64:
     paths with injected draws on the card against the host's complex128
     run, then the golden anchor tests/data/thermal_hubbard3x3.npz over 60
     paths, |dE| < max(4 se, 0.05) and |dNav| < max(4 se, 0.02).
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
# One H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and the fastest FLOP/s
# of each element type at its own precision: float32 outside the tensor
# cores, float64 on the FP64 tensor cores (DMMA; 34e12 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.complex64: 67e12,
              torch.float64: 67e12, torch.complex128: 67e12}


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


def cpqr_work(m: int, b: int, dtype=torch.complex64):
    """The pivoted QR: a read once, q and r written once (and perm); per
    matrix the factor pass's trailing dot products and updates (8 FLOPs a
    complex multiply-add), the norms downdated by |r_kj|^2 (4 a column, as
    LAPACK and the plain version do; the kernel's exact recompute is its
    own choice, not the function's work), the Householder vectors, and the
    form-Q pass's reflector applications that touch each column
    (16 (m - k) for reflector k <= column j)."""
    c = 16 if dtype == torch.complex128 else C8
    flops = 0
    for k in range(m):
        t = m - k
        flops += 16 * t * (t - 1) + 4 * (t - 1) + 4 * t + 6 * (t - 1)
    flops += sum(16 * (m - k) for j in range(m) for k in range(j + 1))
    return (3 * b * m * m * c + b * m * 8, b * flops, dtype)


CPQR_EPS = {torch.complex64: 2.0 ** -24, torch.float32: 2.0 ** -24,
            torch.complex128: 2.0 ** -53, torch.float64: 2.0 ** -53}


def cpqr_identities(a, q, r, perm):
    """(max reconstruction ||A[:, perm] - QR||_F / ||A||_F, max |Q^H Q - I|,
    max |below R's diagonal|, worst rise of |r_kk| over |r_00|)."""
    b, m, _ = a.shape
    ap = torch.gather(a, 2, perm[:, None, :].expand(b, m, m))
    rec = (torch.linalg.matrix_norm(ap - q @ r)
           / torch.linalg.matrix_norm(a)).max().item()
    eye = torch.eye(m, dtype=q.dtype, device=q.device)
    orth = (q.conj().transpose(1, 2) @ q - eye).abs().max().item()
    low = torch.tril(r, -1).abs().max().item()
    d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    rise = ((d[:, 1:] - d[:, :-1]).clamp_min(0).amax(-1)
            / d[:, 0].clamp_min(1e-300)).max().item()
    return rec, orth, low, rise


def separated_norms(rng, b, m, cplx):
    """(W D)[:, shuffle]: W = I + 0.05 N / sqrt(m) (cond(W) ~ 1.1), D a
    geometric column scaling from 1 down to 1e-4, the columns then
    shuffled. Consecutive scales differ by 1e4^(1/(m-1)) (10% at m = 93),
    far more than W moves a column's residual norm (~0.3%), so the pivots
    are unambiguous; and the k-th pivot column's dominant entry sits in
    row k, so its x_k is not small against ||x||: the LAPACK phase choice
    beta = -(x_k/|x_k|) ||x|| makes Q as sensitive as x_k's phase, and
    only then are Q and R well determined in float32 (~1e-6 from float64
    up to m = 162, tools/thermal_precision.py)."""
    w = np.eye(m) + 0.05 / np.sqrt(m) * rng.normal(size=(b, m, m))
    if cplx:
        w = w + 0.05j / np.sqrt(m) * rng.normal(size=(b, m, m))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return (w * scale[None, None, :])[:, :, rng.permutation(m)]


def gaussian_separated(rng, b, m, cplx):
    """(G D)[:, shuffle]: G Gaussian, D the geometric column scaling of
    separated_norms. A pivot column's k-th entry is as small against its
    norm as a Gaussian entry happens to be, so the phase that the LAPACK
    choice gives q_k and row k of R is ill-determined in float32 on a few
    columns: the plain version in float32 misses float64 there by up to
    1.021e-3 in Q (B=128, m=162, tools/thermal_precision.py), a quarter of
    what a planted phase error of 2^-8 reads. R, weighted by |r_kk|, and Q
    with each column's phase aligned to float64 stay within 6.5e-6."""
    g = rng.normal(size=(b, m, m))
    if cplx:
        g = g + 1j * rng.normal(size=(b, m, m))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return (g * scale[None, None, :])[:, :, rng.permutation(m)]


def against_double(q64, r64, q, r):
    """Float32 factors q, r against the double-precision ones q64, r64 of
    the same (float32) input with the same pivots: (max |R - R64| over each
    matrix's max |R64|, max |Q D - Q64| with D the column phases that align
    Q to Q64, max |Q - Q64|)."""
    q, r = q.to(q64.dtype), r.to(r64.dtype)
    rmax = r64.abs().amax((-2, -1), keepdim=True)
    d_r = ((r - r64).abs() / rmax).max().item()
    d = (q64.conj() * q).sum(-2)
    d = d / d.abs()
    d_qa = (q * d.conj()[:, None, :] - q64).abs().max().item()
    return d_r, d_qa, (q - q64).abs().max().item()


def check_cpqr(cpqr_cuda, rng) -> tuple[float, str]:
    """The pivoted QR kernel against its plain version at m in {9, 16, 36,
    48, 93, cap} x B in {1, 37, 512}, complex64 and complex128, and real
    float32 at (512, 93): on Gaussian input (one zero column) the
    identities within 10 m eps, exact zeros below R's diagonal, |r_kk|
    non-increasing within 10 m eps of |r_00|, the same bits on a second
    launch; on separated-norm input the plain version's pivots and Q
    within tol, R within tol max|R|; in complex64 and float32 on Gaussian
    separated-norm input, the factors against the plain version in double
    precision with the kernel's pivots: R within 1e-4 of each matrix's
    max|R| and Q, its column phases aligned, within 1e-4, a limit above the
    plain float32 version's own reading and below that of the kernel's
    factors with a planted phase error of 2^-8 on every column; a rank-7
    input finite with a vanishing trailing diagonal. Returns (largest
    |R - R_plain| at (512, 93) complex64 on separated norms, the largest
    readings)."""
    main_err, worst = None, {}
    wide = {"kernel": [0.0] * 3, "plain": [0.0] * 3, "planted": np.inf}
    cases = [(dt, m, b) for dt in (torch.complex64, torch.complex128)
             for m in (9, 16, 36, 48, 93, cpqr_cuda.max_m(dt))
             for b in (1, 37, 512)] + [(torch.float32, 93, 512)]
    for dtype, m, b in cases:
        tol, allow = TOL[dtype], 10 * m * CPQR_EPS[dtype]
        cplx = dtype.is_complex
        a = rng.normal(size=(b, m, m))
        if cplx:
            a = a + 1j * rng.normal(size=(b, m, m))
        a[0, :, m // 2] = 0.0
        a = torch.from_numpy(a).to("cuda", dtype)
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        q2, r2, p2 = cpqr_cuda.cpqr_lanes(a)
        torch.cuda.synchronize()
        where = f"{dtype} m={m} B={b}"
        if not (torch.equal(q, q2) and torch.equal(r, r2)
                and torch.equal(p, p2)):
            raise AssertionError(f"cpqr not reproducible at {where}")
        rec, orth, low, rise = cpqr_identities(a, q, r, p)
        if not (rec <= allow and orth <= allow and low == 0.0
                and rise <= allow):
            raise AssertionError(f"cpqr identities at {where}: rec {rec:.3e} "
                                 f"orth {orth:.3e} below-diagonal {low} "
                                 f"rise {rise:.3e} (allowance {allow:.3e})")
        sep = torch.from_numpy(separated_norms(rng, b, m, cplx)).to(
            "cuda", dtype)
        qk, rk, pk = cpqr_cuda.cpqr_lanes(sep)
        qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(sep)
        torch.cuda.synchronize()
        dq = (qk - qp).abs().max().item()
        dr = (rk - rp).abs().max().item()
        rmax = rp.abs().max().item()
        if not (torch.equal(pk, pp) and dq <= tol and dr <= tol * rmax):
            raise AssertionError(f"cpqr disagrees with its plain version at "
                                 f"{where}: same pivots "
                                 f"{bool(torch.equal(pk, pp))}, dQ {dq:.3e}, "
                                 f"dR/max {dr / rmax:.3e} (tol {tol})")
        if dtype in (torch.complex64, torch.float32):
            g = torch.from_numpy(gaussian_separated(rng, b, m, cplx)).to(
                "cuda", dtype)
            qk, rk, pk = cpqr_cuda.cpqr_lanes(g)
            gp = torch.gather(g, 2, pk[:, None, :].expand(b, m, m))
            qp, rp, _ = cpqr_cuda.cpqr_lanes_plain(gp, pivot=False)
            q64, r64, _ = cpqr_cuda.cpqr_lanes_plain(
                gp.to(torch.complex128 if cplx else torch.float64),
                pivot=False)
            kern = against_double(q64, r64, qk, rk)
            plain = against_double(q64, r64, qp, rp)
            planted = np.inf
            if cplx:
                turn = complex(np.exp(1j * 2.0 ** -8))
                planted = against_double(q64, r64, qk * turn, rk / turn)[0]
            del q64, r64
            if not (kern[0] <= tol and kern[1] <= tol and plain[0] <= tol
                    and plain[1] <= tol and planted > tol):
                raise AssertionError(
                    f"cpqr against double precision on Gaussian separated "
                    f"norms at {where}: kernel dR {kern[0]:.3e}, aligned dQ "
                    f"{kern[1]:.3e}; plain version {plain[0]:.3e}, "
                    f"{plain[1]:.3e}; planted phase error dR {planted:.3e} "
                    f"(limit {tol})")
            wide["kernel"] = [max(x, y) for x, y in zip(wide["kernel"], kern)]
            wide["plain"] = [max(x, y) for x, y in zip(wide["plain"], plain)]
            wide["planted"] = min(wide["planted"], planted)
        key = str(dtype).split(".")[-1]
        w = worst.setdefault(key, [0.0] * 4)
        worst[key] = [max(w[0], rec / allow), max(w[1], orth / allow),
                      max(w[2], dq / tol), max(w[3], dr / rmax / tol)]
        if (dtype, m, b) == (torch.complex64, 93, 512):
            main_err = dr
    for dtype in (torch.complex64, torch.complex128):
        m, k = 93, 7
        a = (rng.normal(size=(37, m, k)) + 1j * rng.normal(size=(37, m, k))
             ) @ rng.normal(size=(37, k, m))
        a = torch.from_numpy(a).to("cuda", dtype)
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        torch.cuda.synchronize()
        rec, orth, low, _ = cpqr_identities(a, q, r, p)
        d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
        allow = 10 * m * CPQR_EPS[dtype]
        if not (torch.isfinite(q).all() and torch.isfinite(r).all()
                and rec <= allow and orth <= allow and low == 0.0
                and bool((d[:, k:] <= 10 * allow * d[:, :1]).all())):
            raise AssertionError(f"cpqr on rank-7 input at {dtype}: rec "
                                 f"{rec:.3e} orth {orth:.3e}")
    kern, plain = wide["kernel"], wide["plain"]
    return main_err, "; ".join(
        f"{k} rec {v[0]:.3f}, orth {v[1]:.3f} of 10 m eps, dQ {v[2]:.3f}, "
        f"dR {v[3]:.3f} of tol" for k, v in worst.items()) + (
        f"; Gaussian separated norms against double precision (complex64 "
        f"and float32, limit 1e-4): kernel dR {kern[0]:.3e}, aligned dQ "
        f"{kern[1]:.3e} (raw dQ {kern[2]:.3e}, not held); plain version "
        f"dR {plain[0]:.3e}, aligned dQ {plain[1]:.3e} (raw dQ "
        f"{plain[2]:.3e}); planted phase error 2^-8 dR >= "
        f"{wide['planted']:.3e}")


def check_batchla_thermal(batchla_cuda, clinalg, rng) -> str:
    """Kernel B at the thermal shape n=93 with 512 matrices, in every type
    and mode it launches, against its plain version; complex128 with the
    inverse (past its cap of 85) goes to torch.linalg by shape and agrees
    with it."""
    out = []
    for dtype in (torch.complex64, torch.complex128, torch.float32,
                  torch.float64):
        n, w, tol = 93, 512, TOL[dtype]
        s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * rng.normal(size=(w, n, n))
        if dtype.is_complex:
            s = s + 0.3j / np.sqrt(n) * rng.normal(size=(w, n, n))
        s = torch.from_numpy(s).to("cuda", dtype)
        for want_inv in (True, False):
            if n > batchla_cuda.inv_max_n(dtype, want_inv):
                before = batchla_cuda.launches
                ld, inv = clinalg.inv_logdet(s)
                want = torch.linalg.inv(s)
                torch.cuda.synchronize()
                d = ((inv - want).abs().max() / want.abs().max()).item()
                if batchla_cuda.launches != before or d > tol:
                    raise AssertionError(f"kernel B route at {dtype} n={n}")
                out.append(f"{dtype} inverse -> torch.linalg")
                continue
            ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
            ld_p, inv_p = batchla_cuda.inv_logdet_lanes_plain(s, want_inv)
            torch.cuda.synchronize()
            dd = (ld_k - ld_p).cpu().numpy()
            dre = float(np.abs(dd.real).max())
            dim = float(phase_diff(dd.imag).max())
            rel = 0.0
            if want_inv:
                rel = float((inv_k - inv_p).abs().max() / inv_p.abs().max())
            if dre > tol * n or dim > tol * n or rel > tol:
                raise AssertionError(
                    f"inv_logdet_lanes disagrees at {dtype} n={n} w={w} "
                    f"want_inv={want_inv}: dRe={dre:.3e} dIm={dim:.3e} "
                    f"dinv/max={rel:.3e}")
    return ", ".join(out)


def thermal_launches(nbins: int, stack_size: int, nslices: int,
                     npaths: int) -> tuple[int, int]:
    """(cpqr, kernel B) launches of ThermalAFQMC.run() over npaths paths:
    each walker initialisation (the driver's and the reset after every
    path) folds all nbins bins and assembles G once (5 kernel B launches:
    two inverses, three log-dets); each slice ts folds bins
    ts // stack_size .. nbins - 1, plus one prefix fold on entering bins
    1.., and assembles G once."""
    per_path = sum(nbins - ts // stack_size
                   + (ts % stack_size == 0 and ts >= stack_size)
                   for ts in range(nslices))
    return ((npaths + 1) * nbins + npaths * per_path,
            5 * (npaths + 1) + 5 * nslices * npaths)


def thermal_injected(af, xi: np.ndarray, pop: np.ndarray, PathNoise):
    """One path of ``af`` with injected draws; its row."""
    dev, rdt = af.state.weight.device, af.state.weight.dtype
    return af.run_block(PathNoise(torch.from_numpy(xi).to(dev, rdt),
                                  torch.from_numpy(pop).to(dev, rdt)))


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
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.ops import (batchla_cuda, clinalg, cpqr_cuda,
                                     cuda_build, exx_cuda, greens_cuda,
                                     sweep_cuda, taylor_cuda)
    from pauxy_tpu_torch.propagation.generic import apply_exponential_taylor
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
    from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise, ThermalAFQMC

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
                "exx": exx_cuda.launches,
                "cpqr": cpqr_cuda.launches}

    def zero_counts() -> None:
        greens_cuda.launches = 0
        batchla_cuda.launches = 0
        batchla_cuda.chol_launches = 0
        sweep_cuda.launches = 0
        taylor_cuda.launches = 0
        exx_cuda.launches = 0
        cpqr_cuda.launches = 0

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
    err["cpqr"], cpqr_readings = check_cpqr(cpqr_cuda, rng)
    b93_route = check_batchla_thermal(batchla_cuda, clinalg, rng)
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
    # The pivoted QR at the thermal UEG shape (B = 2 x 256 walkers, M=93);
    # PyTorch has no pivoted QR, so no library call.
    qa = torch.randn(512, 93, 93, dtype=c64, device="cuda", generator=gen)
    times["cpqr"] = median_ms({
        "plain": lambda: cpqr_cuda.cpqr_lanes_plain(qa),
        "kernel": lambda: cpqr_cuda.cpqr_lanes(qa)}, reps=10)
    del qa
    work = {
        "greens_lanes": greens_work(m, n, w),
        "inv_logdet_lanes": batchla_work(n, w, False),
        "chol_inv_lanes": chol_work(n, w),
        "hirsch_sweep": sweep_work(m, n, n, w),
        "taylor_exp": taylor_work(tm, tc, tw),
        "exx": exx_work(ex, en, em, ew),
        "cpqr": cpqr_work(93, 512),
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
    # The thermal shapes: kernel B at n=93 with 512 matrices (the QDT
    # assembly; the library calls torch.linalg.inv and slogdet), the
    # pivoted QR at the Hubbard thermal shape (2 x 32 walkers, m=9).
    st = torch.from_numpy(2.0 * np.eye(93) + 0.3 / np.sqrt(93) * (
        rng.normal(size=(512, 93, 93))
        + 1j * rng.normal(size=(512, 93, 93)))).to("cuda", c64)
    for want_inv in (True, False):
        fns = {"plain": lambda: batchla_cuda.inv_logdet_lanes_plain(
                   st, want_inv),
               "kernel": lambda: batchla_cuda.inv_logdet_lanes(st, want_inv),
               "library": ((lambda: torch.linalg.inv(st)) if want_inv
                           else (lambda: torch.linalg.slogdet(st)))}
        at_shape("inv_logdet_lanes",
                 "n=93 w=512 c64 " + ("inverse+log-det" if want_inv
                                      else "log-det only"),
                 fns, batchla_work(93, 512, want_inv), reps=5)
    del st
    qh = torch.randn(64, 9, 9, dtype=c64, device="cuda", generator=gen)
    at_shape("cpqr", "(B,m)=(64,9) c64",
             {"plain": lambda: cpqr_cuda.cpqr_lanes_plain(qh),
              "kernel": lambda: cpqr_cuda.cpqr_lanes(qh)}, cpqr_work(9, 64))
    qd = torch.randn(512, 93, 93, dtype=torch.complex128, device="cuda",
                     generator=gen)
    at_shape("cpqr", "(B,m)=(512,93) c128",
             {"plain": lambda: cpqr_cuda.cpqr_lanes_plain(qd),
              "kernel": lambda: cpqr_cuda.cpqr_lanes(qd)},
             cpqr_work(93, 512, torch.complex128), reps=5)
    del qd
    say("3 kernels", "greens_lanes, inv_logdet_lanes (complex and real), "
        "chol_inv_lanes and hirsch_sweep agree with their plain versions at "
        "every shape (complex64/float32 1e-4, complex128/float64 1e-10, "
        "sweep fields identical); at the main-path shapes "
        "(greens (16,7) W=1024 c64; inv_logdet n=7 w=1024 c64 log-det only; "
        "chol n=7 w=1024 c64; sweep (16,7,7) W=1024 f32; taylor (128,32) "
        "w=1024 c64 with the xla route as library call; exx (1024,42,228) "
        "w=256 c64 with the einsum route as library call; cpqr (512,93) "
        "c64, no library call): " + "; ".join(
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
    say("3 kernels", "cpqr at m in {9,16,36,48,93,cap} x B in {1,37,512} "
        "complex64 and complex128, and float32 at (512,93): identities "
        "within 10 m eps, exact zeros below R's diagonal, |r_kk| "
        "non-increasing, the same bits on a second launch, on separated "
        "norms the plain version's pivots and factors within tol, on "
        "Gaussian separated norms the factors against double precision, "
        "rank-7 "
        f"input finite; largest readings: {cpqr_readings}; kernel B at "
        f"n=93 w=512 agrees with its plain version in every type and mode "
        f"it launches ({b93_route})")
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

    # ---- 11. thermal UEG at the bench shape ------------------------------
    def thermal_ueg(device, dtype, nwalkers, nblocks):
        ham = make_ueg(7, 7, rs=1.0, ecut=4.0, device=device, dtype=dtype)
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device=device,
                                    dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=nwalkers, dt=0.05, nsteps=1, nblocks=nblocks, beta=2.0,
            npop_control=1, rng_seed=8), device=device)

    zero_counts()
    af = thermal_ueg("cuda", "single", 256, 2)
    shape = (af.ham.nbasis, af.ham.nfields, af.ntime_slices, af.trial.nbins,
             af.trial.stack_size)
    if shape != (93, 1500, 40, 4, 10):
        raise AssertionError(f"thermal UEG bench shape {shape}")
    rows = af.run()
    torch.cuda.synchronize()
    ueg_counts = counts()
    if not (np.isfinite(rows).all() and (rows[:, 10].real > 0).all()):
        raise AssertionError(f"thermal UEG rows {rows}")
    ncpqr, nkb = thermal_launches(4, 10, 40, af.qmc.nblocks)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if ueg_counts != want:
        raise AssertionError(f"thermal UEG launches {ueg_counts}, want "
                             f"{want}")
    timed = af.block_seconds[1:]
    rate_t = af.qmc.nwalkers * af.ntime_slices * len(timed) / sum(timed)
    say("11 thermal UEG", f"rs=1 ecut=4 M=93 (7,7) beta=2 dt=0.05 mu=0.9 "
        f"(40 slices, 4 bins of 10) complex64 256 walkers, pop control "
        f"every slice: ETotal per row "
        f"{np.array2string(rows[:, 5].real, precision=5)}, Nav "
        f"{np.array2string(rows[:, 10].real, precision=5)}; launches "
        f"{ueg_counts}; {rate_t:.1f} walker-slice-steps/s over "
        f"{len(timed)} path(s) after a warm-up path (path seconds "
        f"{', '.join(f'{t:.4f}' for t in af.block_seconds)})")
    del af
    # The card's complex64 path against the host's complex128 path, one
    # path of 16 walkers with the same injected draws. Limit: float32's
    # unit roundoff 6e-8 times the 40 slices of ~40 chained rounding steps
    # of a walker (cpqr folds, inverses, log-dets at M=93), 1e-4 of the
    # values (the port's complex64 against complex128 on a host reads
    # 3.0e-6 for ETotal and 1.9e-6 for Nav, tools/thermal_precision.py).
    draws = np.random.default_rng(11)
    xi = draws.normal(size=(40, 16, 1500))
    pop = draws.uniform(size=(40, 1))
    card = thermal_injected(thermal_ueg("cuda", "single", 16, 1), xi, pop,
                            PathNoise)
    host = thermal_injected(thermal_ueg("cpu", "double", 16, 1), xi, pop,
                            PathNoise)
    d_e = abs(card[5] - host[5]) / abs(host[5])
    d_n = abs(card[10] - host[10]) / abs(host[10])
    if not (np.isfinite(card).all() and d_e <= 1e-4 and d_n <= 1e-4):
        raise AssertionError(f"thermal UEG: complex64 on the card {card} vs "
                             f"complex128 on the host {host}: dE {d_e:.3e}, "
                             f"dNav {d_n:.3e} > 1e-4")
    say("11 thermal UEG", f"16 walkers, one path with injected draws: "
        f"complex64 on the card ETotal {card[5].real:.6f} Nav "
        f"{card[10].real:.6f} vs complex128 on the host "
        f"{host[5].real:.6f} / {host[10].real:.6f}: relative "
        f"{d_e:.3e} / {d_n:.3e} <= 1e-4" + lap("11"))

    # ---- 12. thermal Hubbard and its golden anchor -----------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "thermal_hubbard3x3.npz"))
    tnw, tbeta, tdt = int(g["nwalkers"]), float(g["beta"]), float(g["dt"])

    def thermal_hubbard(device, dtype, nblocks, rng_seed=8):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device=device,
                           dtype=dtype)
        trial = make_one_body_trial(ham, tbeta, tdt, mu=float(g["mu"]),
                                    device=device, dtype=dtype)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=tnw, dt=tdt, nsteps=1, nblocks=nblocks, beta=tbeta,
            npop_control=2, rng_seed=rng_seed), device=device)

    # Limit: 6e-8 times the 10 slices of ~100 chained rounding steps, 1e-4
    # of the values' scale (the port's complex64 against complex128 on a
    # host reads 1.5e-6, tools/thermal_precision.py).
    npaths = 5
    card_af = thermal_hubbard("cuda", "single", npaths)
    host_af = thermal_hubbard("cpu", "double", npaths)
    ns = card_af.ntime_slices
    xi = draws.normal(size=(npaths * ns, tnw, card_af.prop.nfields))
    pop = draws.uniform(size=(npaths * ns, 1))
    pairs = []
    for i in range(npaths):
        sl = slice(i * ns, (i + 1) * ns)
        c = thermal_injected(card_af, xi[sl], pop[sl], PathNoise)
        h = thermal_injected(host_af, xi[sl], pop[sl], PathNoise)
        pairs.append([c[5].real, h[5].real, c[10].real, h[10].real])
    pairs = np.array(pairs)
    tight = max(np.abs(pairs[:, 0] - pairs[:, 1]).max()
                / np.abs(pairs[:, 1]).max(),
                np.abs(pairs[:, 2] - pairs[:, 3]).max()
                / np.abs(pairs[:, 3]).max())
    if not (np.isfinite(pairs).all() and tight <= 1e-4):
        raise AssertionError(f"thermal Hubbard: card vs host {pairs}")
    zero_counts()
    gaf = thermal_hubbard("cuda", "single", 60)
    rows = gaf.run()
    torch.cuda.synchronize()
    hub_counts = counts()
    ncpqr, nkb = thermal_launches(gaf.trial.nbins, gaf.trial.stack_size,
                                  gaf.ntime_slices, 60)
    want = only(cpqr=ncpqr, inv_logdet_lanes=nkb)
    if hub_counts != want:
        raise AssertionError(f"thermal Hubbard launches {hub_counts}, want "
                             f"{want}")
    et, nav = rows[1:, 5].real, rows[1:, 10].real
    ref_e, ref_n = np.asarray(g["etotal"])[1:], np.asarray(g["nav"])[1:]
    se_e = float(np.hypot(et.std(ddof=1) / np.sqrt(len(et)),
                          ref_e.std(ddof=1) / np.sqrt(len(ref_e))))
    se_n = float(np.hypot(nav.std(ddof=1) / np.sqrt(len(nav)),
                          ref_n.std(ddof=1) / np.sqrt(len(ref_n))))
    de = abs(et.mean() - ref_e.mean())
    dn = abs(nav.mean() - ref_n.mean())
    if not (np.isfinite(rows).all() and de < max(4 * se_e, 0.05)
            and dn < max(4 * se_n, 0.02)):
        raise AssertionError(f"thermal golden missed: E {et.mean()} vs "
                             f"{ref_e.mean()} (se {se_e}), Nav {nav.mean()} "
                             f"vs {ref_n.mean()} (se {se_n})")
    say("12 thermal Hubbard", f"3x3 U=4 mu={float(g['mu'])} beta={tbeta} "
        f"dt={tdt} {tnw} walkers: {npaths} paths with injected draws, "
        f"complex64 on the card vs complex128 on the host, (ETotal, Nav) "
        f"per path {pairs.round(6).tolist()}: max |d| over the scale "
        f"{tight:.3e} <= 1e-4; golden anchor over 60 paths, complex64: "
        f"E {et.mean():.6f} vs reference {ref_e.mean():.6f}, |d| {de:.6f} "
        f"< max(4 se, 0.05) with se {se_e:.6f}; Nav {nav.mean():.6f} vs "
        f"{ref_n.mean():.6f}, |d| {dn:.6f} < max(4 se, 0.02) with se "
        f"{se_n:.6f}; launches {hub_counts}" + lap("12"))
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
        "cpqr": ("pauxy_tpu_torch/csrc/cpqr.cu",
                 "pauxy_tpu/ops/cpqr_pallas.py:89"),
    }
    by_path = {"continuous": cont, "discrete": disc, "generic": gen_counts,
               "generic_exx": exx_counts, "thermal_ueg": ueg_counts,
               "thermal_hubbard": hub_counts}
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
