"""Spread of the UEG golden anchor over random seeds, Taylor tiers and
matmul tiers, on the card.

    python tools/ueg_golden_seeds.py [--seeds 8 9 10] [--tiers pallas/single,pallas_bf16/single,pallas/double]
    python tools/ueg_golden_seeds.py --tiers xla/single --matmul float32,bfloat16_3x,bfloat16
    python tools/ueg_golden_seeds.py --anchor generic --tiers xla/single --matmul float32,bfloat16
    python tools/ueg_golden_seeds.py --package jax [--seeds 8 9 10]

Runs the anchor of tests/test_afqmc_driver.py:180-212
(tests/data/ueg_rs2.44_ecut2.npz: (7, 7), rs 2.44, ecut 2, M=33, RHF
trial, 40 walkers, dt 0.01, 100 blocks of 10 steps, the energy every step)
with the PyTorch port on one CUDA card, once per seed and tier (the
PAUXY_TPU_TAYLOR_UEG value and the precision, "single" or "double"), and
prints for each run the mean ETotal over the last two thirds, its distance
from the reference series' mean, and whether that passes max(4 se, 0.05)
with the test's naive se; then per tier the mean over seeds with the
standard error of the seeds' spread, and each tier's distance from the
reference and from the first tier in units of the combined errors
(the reference's se reblocked, chip_smoke.reblocked_se). Needs the card.
``--matmul`` runs every tier once per name of the matmul-precision ladder
(the drivers' ``propagator_options["matmul_precision"]``). ``--anchor
generic`` runs the Generic golden instead (tests/data/generic_nmo11.npz:
(3, 3), 40 walkers, dt 0.005, 100 blocks of 10 steps, the energy every
step, the tier's ``taylor_impl``; criterion max(4 se, 0.02)).
With ``--package jax`` the same UEG anchor runs in the JAX package on the
CPU in float64 (its "xla" Taylor route; one tier, ``jax/double``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


ANCHORS = {"ueg": ("ueg_rs2.44_ecut2.npz", 0.05),
           "generic": ("generic_nmo11.npz", 0.02)}


def run(anchor: str, impl: str, dtype: str, matmul: str, seed: int,
        g) -> np.ndarray:
    from pauxy_tpu_torch.models import (make_generic, make_ueg,
                                        rhf_identity_trial,
                                        trial_from_orbitals)
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    popts = {"matmul_precision": matmul}
    if anchor == "ueg":
        os.environ["PAUXY_TPU_TAYLOR_UEG"] = impl
        ham = make_ueg(int(g["nup"]), int(g["ndown"]), rs=float(g["rs"]),
                       ecut=float(g["ecut"]), device="cuda", dtype=dtype)
        trial = rhf_identity_trial(ham, device="cuda", dtype=dtype)
    else:
        popts["taylor_impl"] = impl
        nmo = g["h1e"].shape[-1]
        ham = make_generic((3, 3), np.stack([g["h1e"], g["h1e"]]),
                           np.asarray(g["chol"]).reshape(-1, nmo, nmo)
                           .transpose(1, 2, 0), ecore=float(g["enuc"]),
                           device="cuda", dtype=dtype)
        trial = trial_from_orbitals(ham, np.asarray(g["psi"]),
                                    device="cuda", dtype=dtype)
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=seed)
    af = AFQMC(ham, trial, qmc, propagator_options=popts,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cuda")
    if af.matmul_precision != matmul:
        raise SystemExit(f"ueg_golden_seeds: the driver runs "
                         f"{af.matmul_precision}, not {matmul}")
    return np.asarray(af.run())[:, 5].real


def jax_run(seed: int, g) -> np.ndarray:
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pauxy_tpu.models import make_ueg, rhf_identity_trial
    from pauxy_tpu.qmc import AFQMC, QMCOpts

    ham = make_ueg(nup=int(g["nup"]), ndown=int(g["ndown"]),
                   rs=float(g["rs"]), ecut=float(g["ecut"]))
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=seed)
    with tempfile.TemporaryDirectory() as tmp:     # JAX's AFQMC writes h5
        rows = AFQMC(ham, rhf_identity_trial(ham), qmc,
                     estimator_options={"mixed": {"energy_eval_freq": 1}},
                     filename=os.path.join(tmp, "est.h5")).run()
    return np.asarray(rows)[:, 5].real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8, 18)))
    ap.add_argument("--tiers",
                    default="pallas/single,pallas_bf16/single,pallas/double")
    ap.add_argument("--matmul", default="float32",
                    help="comma-separated matmul tiers (float32, "
                    "bfloat16_3x, bfloat16)")
    ap.add_argument("--anchor", choices=tuple(ANCHORS), default="ueg")
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    args = ap.parse_args()
    from chip_smoke import reblocked_se

    if args.package == "jax":
        if args.anchor != "ueg":
            raise SystemExit("ueg_golden_seeds: --package jax runs the UEG "
                             "anchor only")
        args.tiers, args.matmul = "jax/double", "float32"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("ueg_golden_seeds: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip())
    data, floor = ANCHORS[args.anchor]
    g = np.load(os.path.join(ROOT, "tests", "data", data))
    ref = np.asarray(g["etotal_blocks"])
    theirs = ref[len(ref) // 3:]
    ref_se = reblocked_se(theirs)
    tiers = [tuple(t.split("/")) + (m,) for m in args.matmul.split(",")
             for t in args.tiers.split(",")]
    means = {t: [] for t in tiers}
    for impl, dtype, matmul in tiers:
        for seed in args.seeds:
            et = (jax_run(seed, g) if args.package == "jax"
                  else run(args.anchor, impl, dtype, matmul, seed, g))
            mine = et[len(et) // 3:]
            se = float(np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                                theirs.std(ddof=1) / np.sqrt(len(theirs))))
            diff = float(abs(mine.mean() - theirs.mean()))
            means[(impl, dtype, matmul)].append(float(mine.mean()))
            print(json.dumps({
                "anchor": args.anchor, "tier": impl, "dtype": dtype,
                "matmul": matmul, "seed": seed,
                "mean": float(mine.mean()), "diff": diff, "naive_se": se,
                "passes": bool(diff < max(4 * se, floor)),
                "finite": bool(np.isfinite(et).all())}), flush=True)
    first = tiers[0]
    m0 = np.mean(means[first])
    se0 = np.std(means[first], ddof=1) / np.sqrt(len(means[first]))
    for t in tiers:
        m = float(np.mean(means[t]))
        se = float(np.std(means[t], ddof=1) / np.sqrt(len(means[t])))
        print(json.dumps({
            "anchor": args.anchor, "tier": t[0], "dtype": t[1],
            "matmul": t[2], "seeds": len(means[t]),
            "mean_over_seeds": m, "se_over_seeds": se,
            "reference": float(theirs.mean()), "reference_se": ref_se,
            "sigmas_from_reference": abs(m - theirs.mean())
            / float(np.hypot(se, ref_se)),
            f"sigmas_from_{'_'.join(first)}": abs(m - m0)
            / float(np.hypot(se, se0)) if t != first else 0.0}))


if __name__ == "__main__":
    main()
