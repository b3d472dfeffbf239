"""Float32 rounding of the port's thermal path and pivoted QR, on the CPU.

    python tools/thermal_precision.py [--skip-ueg]

Prints the readings that chip_smoke.py's card-against-host limits and its
separated-norm cpqr inputs are argued from:

1. the port's complex64 path against its complex128 path with the same
   injected draws: one 16-walker path of the thermal UEG at the bench shape
   (M=93, beta=2, 40 slices; a few minutes) and 5 paths of the 3x3 thermal
   Hubbard golden system (ETotal and Nav, relative to the values' scale);
2. the plain pivoted QR in float32 against float64 (max |dQ|, max |dR| /
   max |R|) on inputs W D with well-separated column scales, once with each
   pivot column's dominant entry off the diagonal (the LAPACK phase choice
   beta = -(x_k/|x_k|) ||x|| then makes Q as sensitive as the phase of a
   small x_k) and once with it on the diagonal; beside them
   torch.linalg.qr (LAPACK's real-beta convention) in float32 against
   float64 on the pre-pivoted first input;
3. on chip_smoke.py's Gaussian separated-norm inputs, the plain pivoted QR
   in float32 against float64 with the same pivots, as chip_smoke.py reads
   the kernel (max |dR| / max |R| per matrix, max |dQ| with each column's
   phase aligned, max |dQ|), and the float32 factors with a planted phase
   error of 2^-8 on every column.

The port only; no JAX, no card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pauxy_tpu_torch.models import (make_hubbard, make_one_body_trial,  # noqa: E402
                                    make_ueg)
from pauxy_tpu_torch.ops import cpqr_cuda  # noqa: E402
from pauxy_tpu_torch.qmc import QMCOpts, ThermalAFQMC  # noqa: E402
from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise  # noqa: E402
from chip_smoke import against_double, gaussian_separated  # noqa: E402


def paths(make, nwalkers, npaths, seed):
    """(ETotal, Nav) per path of complex64 and complex128 runs with the
    same draws."""
    out = {}
    rng = np.random.default_rng(seed)
    afs = {dt: make(dt) for dt in ("single", "double")}
    ns = afs["double"].ntime_slices
    xi = rng.normal(size=(npaths * ns, nwalkers, afs["double"].prop.nfields))
    pop = rng.uniform(size=(npaths * ns, 1))
    for dt, af in afs.items():
        rdt = af.state.weight.dtype
        rows = [af.run_block(PathNoise(
            torch.from_numpy(xi[i * ns:(i + 1) * ns]).to(rdt),
            torch.from_numpy(pop[i * ns:(i + 1) * ns]).to(rdt)))
            for i in range(npaths)]
        out[dt] = np.array([[r[5].real, r[10].real] for r in rows])
    d = np.abs(out["single"] - out["double"]).max(0)
    return d / np.abs(out["double"]).max(0)


def separated(rng, b, m, diagonal):
    w = np.eye(m) + 0.05 / np.sqrt(m) * (rng.normal(size=(b, m, m))
                                         + 1j * rng.normal(size=(b, m, m)))
    scale = 1e-4 ** (np.arange(m) / (m - 1))
    if diagonal:
        return (w * scale)[:, :, rng.permutation(m)]
    return w * scale[rng.permutation(m)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-ueg", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    g = np.load(os.path.join(ROOT, "tests", "data", "thermal_hubbard3x3.npz"))

    def hubbard(dt):
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device="cpu", dtype=dt)
        trial = make_one_body_trial(ham, float(g["beta"]), float(g["dt"]),
                                    mu=float(g["mu"]), device="cpu",
                                    dtype=dt)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=int(g["nwalkers"]), dt=float(g["dt"]), nsteps=1,
            nblocks=5, beta=float(g["beta"]), npop_control=2),
            device="cpu")

    def ueg(dt):
        ham = make_ueg(7, 7, rs=1.0, ecut=4.0, device="cpu", dtype=dt)
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, device="cpu",
                                    dtype=dt)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=16, dt=0.05, nsteps=1, nblocks=1, beta=2.0,
            npop_control=1), device="cpu")

    e, n = paths(hubbard, int(g["nwalkers"]), 5, 12)
    print(f"thermal Hubbard 3x3, 5 paths: complex64 vs complex128, ETotal "
          f"{e:.3e}, Nav {n:.3e} of the scale")
    if not args.skip_ueg:
        e, n = paths(ueg, 16, 1, 11)
        print(f"thermal UEG M=93, one 16-walker path: complex64 vs "
              f"complex128, ETotal {e:.3e}, Nav {n:.3e} (relative)")
    rng, grng = np.random.default_rng(0), np.random.default_rng(1)
    for m in (93, 162):
        for diagonal in (False, True):
            a = torch.from_numpy(separated(rng, 128, m, diagonal)).to(
                torch.complex64)
            q1, r1, _ = cpqr_cuda.cpqr_lanes_plain(a)
            q2, r2, p2 = cpqr_cuda.cpqr_lanes_plain(a.to(torch.complex128))
            dq = float((q1.to(torch.complex128) - q2).abs().max())
            dr = float((r1.to(torch.complex128) - r2).abs().max()
                       / r2.abs().max())
            line = (f"plain cpqr m={m} B=128, dominant entries "
                    f"{'on' if diagonal else 'off'} the diagonal: float32 vs "
                    f"float64 dQ {dq:.3e}, dR/max {dr:.3e}")
            if not diagonal:
                ap_ = torch.gather(a, 2, p2[:, None, :].expand(128, m, m))
                ql = torch.linalg.qr(ap_)[0].to(torch.complex128)
                ql64 = torch.linalg.qr(ap_.to(torch.complex128))[0]
                line += (f"; torch.linalg.qr (real beta) dQ "
                         f"{float((ql - ql64).abs().max()):.3e}")
            print(line, flush=True)
        for b in (37, 128):
            a = torch.from_numpy(gaussian_separated(grng, b, m, True)).to(
                torch.complex64)
            p = cpqr_cuda.cpqr_lanes_plain(a.to(torch.complex128))[2]
            ap = torch.gather(a, 2, p[:, None, :].expand(b, m, m))
            q64, r64, _ = cpqr_cuda.cpqr_lanes_plain(
                ap.to(torch.complex128), pivot=False)
            q, r, _ = cpqr_cuda.cpqr_lanes_plain(ap, pivot=False)
            turn = complex(np.exp(1j * 2.0 ** -8))
            d_r, d_qa, d_q = against_double(q64, r64, q, r)
            planted = against_double(q64, r64, q * turn, r / turn)[0]
            print(f"plain cpqr m={m} B={b}, Gaussian separated norms: "
                  f"float32 vs float64 with the same pivots dR/max "
                  f"{d_r:.3e}, aligned dQ {d_qa:.3e}, dQ {d_q:.3e}; planted "
                  f"phase error 2^-8 dR/max {planted:.3e}", flush=True)


if __name__ == "__main__":
    main()
