"""Spread of the Generic golden anchor over random seeds, on the CPU.

    python tools/generic_golden_seeds.py [--seeds 8 9 10] [--package jax|port|both]

Runs the anchor of tests/test_afqmc_driver.py (tests/data/generic_nmo11.npz:
the reference's Hamiltonian and trial orbitals, 40 walkers, dt 0.005, 100
blocks of 10 steps, energy every step, float64) once per seed with the JAX
package and/or the PyTorch port, and prints for each run the mean ETotal
over the last two thirds, its distance from the reference series' mean, and
whether that distance passes max(4 se, 0.02) with se from the naive standard
errors (the test's) and from Flyvbjerg-Petersen reblocking
(pauxy_tpu.analysis.blocking.reblock_summary) of both series.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load():
    g = np.load(os.path.join(ROOT, "tests", "data", "generic_nmo11.npz"))
    nmo = g["h1e"].shape[-1]
    chol = np.asarray(g["chol"]).reshape(-1, nmo, nmo).transpose(1, 2, 0)
    return g, np.stack([g["h1e"], g["h1e"]]), chol


def jax_run(seed: int) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pauxy_tpu.models.generic import make_generic
    from pauxy_tpu.models.trial import trial_from_orbitals
    from pauxy_tpu.qmc import AFQMC, QMCOpts

    g, h1, chol = load()
    ham = make_generic((3, 3), h1, chol, ecore=float(g["enuc"]))
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]))
    qmc = QMCOpts(nwalkers=40, dt=0.005, nsteps=10, nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=seed)
    with tempfile.TemporaryDirectory() as tmp:     # the JAX driver's h5
        rows = AFQMC(ham, trial, qmc,
                     estimator_options={"mixed": {"energy_eval_freq": 1}},
                     filename=os.path.join(tmp, "est.h5")).run()
    return np.asarray(rows)[:, 5].real


def port_run(seed: int) -> np.ndarray:
    from pauxy_tpu_torch.models import make_generic, trial_from_orbitals
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    g, h1, chol = load()
    kw = dict(device="cpu", dtype="double")
    ham = make_generic((3, 3), h1, chol, ecore=float(g["enuc"]), **kw)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), **kw)
    qmc = QMCOpts(nwalkers=40, dt=0.005, nsteps=10, nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=seed)
    rows = AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cpu").run()
    return rows[:, 5].real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[8, 9, 10])
    ap.add_argument("--package", choices=("jax", "port", "both"),
                    default="both")
    args = ap.parse_args()
    from pauxy_tpu.analysis.blocking import reblock_summary

    g, _, _ = load()
    ref = np.asarray(g["etotal_blocks"])
    theirs = ref[len(ref) // 3:]
    ref_naive = theirs.std(ddof=1) / np.sqrt(len(theirs))
    ref_rb = reblock_summary(theirs)["standard error"]
    print(f"reference mean {theirs.mean():.6f} naive se {ref_naive:.6f} "
          f"reblocked se {ref_rb:.6f}")
    runs = {"jax": jax_run, "port": port_run}
    names = list(runs) if args.package == "both" else [args.package]
    for name in names:
        for seed in args.seeds:
            et = runs[name](seed)
            mine = et[len(et) // 3:]
            diff = abs(mine.mean() - theirs.mean())
            naive = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                             ref_naive)
            rb = np.hypot(reblock_summary(mine)["standard error"], ref_rb)
            print(f"{name} seed {seed}: mean {mine.mean():.6f} |diff| "
                  f"{diff:.6f}; naive se {naive:.6f} pass "
                  f"{diff < max(4 * naive, 0.02)}; reblocked se {rb:.6f} "
                  f"pass {diff < max(4 * rb, 0.02)}", flush=True)


if __name__ == "__main__":
    main()
