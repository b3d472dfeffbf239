"""Which products the 'bfloat16_3x' tier's split GEMM gets on a path, and
each one's time against cuBLAS's IEEE float32 product, on one CUDA card.

    python3 tools/gemm3_shapes.py [--paths thermal_ueg,generic,ueg_xla]

Builds each path at chip_profile.py's shape in the 'bfloat16_3x' tier
(thermal_ueg: make_ueg(7, 7, rs=1, ecut=4), beta=2, 256 walkers; generic:
the bench shape nmo=128, naux=512, (16, 16), 1024 walkers,
taylor_impl="pallas"; ueg_xla: make_ueg(7, 7, rs=1, ecut=8), 512 walkers,
the "xla" Taylor route), runs one warm-up block, then one block in which
every call of ops/gemm3_cuda.gemm is timed by CUDA events (synchronised,
so a call's host time is in it) and grouped by the operands' shapes,
strides, conjugation and type. For the 12 groups of most time it times
the wrapper and torch.matmul in the "float32" tier (cuBLAS; with torch's
own copy of an operand it cannot read in place) on random operands of the
same layout, five calls each. Prints the card's name and power limit,
then one JSON line a group: the shapes and strides, the calls and their
summed ms in the block, the route ``plan`` picks (tile, narrow or
skinny), its code (a tile's columns or the skinny mode), whether it
transposes, how A and B are staged (k-major, TMA, a float32 pair) and the
two ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PATHS = ("thermal_ueg", "generic", "ueg_xla")


def like(t: torch.Tensor) -> torch.Tensor:
    """Random operand of t's shape, strides (0 included), storage offset's
    parity, type and lazy conjugation: a complex tensor's plane stays a
    plane (its storage holds the pair of every element)."""
    off = t.storage_offset() % 2
    extent = 2 + off + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    out = torch.randn(extent, dtype=t.dtype, device=t.device).as_strided(
        t.shape, t.stride(), off)
    return out.conj() if t.is_conj() else out


def staging(flags: int) -> str:
    """An operand's staging flags in words."""
    from pauxy_tpu_torch.ops import gemm3_cuda as g

    return "+".join(name for name, bit in (
        ("kmaj", g.KMAJ), ("tma", g.TMA), ("pair", g.PAIR),
        ("imag", g.PLANE), ("swap", g.SWAP), ("bcast", g.BCAST),
        ("groups of 2", g.GROUP2), ("groups of 4", g.GROUP4),
        ("rows", g.ROWS)) if flags & bit) or "element"


def ms_of(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build(name: str):
    from chip_smoke import generic_model
    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    kw = dict(device="cuda", dtype="single")
    tier = {"matmul_precision": "bfloat16_3x"}
    if name == "thermal_ueg":
        ham = make_ueg(7, 7, rs=1.0, ecut=4.0, **kw)
        trial = make_one_body_trial(ham, 2.0, 0.05, mu=0.9, **kw)
        return ThermalAFQMC(ham, trial, QMCOpts(
            nwalkers=256, dt=0.05, nsteps=1, nblocks=2, beta=2.0,
            npop_control=1, rng_seed=8), propagator_options=tier,
            device="cuda")
    if name == "generic":
        ham = generic_model(128, 512, 16, make_generic)
        return AFQMC(ham, rhf_identity_trial(ham, **kw), QMCOpts(
            nwalkers=1024, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
            npop_control=1, rng_seed=8),
            propagator_options={"taylor_impl": "pallas", **tier},
            estimator_options={"mixed": {"energy_eval_freq": 1}},
            device="cuda")
    os.environ.pop("PAUXY_TPU_TAYLOR_UEG", None)
    ham = make_ueg(7, 7, rs=1.0, ecut=8.0, **kw)
    return AFQMC(ham, rhf_identity_trial(ham, **kw), QMCOpts(
        nwalkers=512, dt=0.005, nsteps=10, nblocks=2, nstblz=5,
        npop_control=1, rng_seed=8), propagator_options=tier,
        estimator_options={"mixed": {"energy_eval_freq": 10}},
        device="cuda")


def census(name: str) -> None:
    from pauxy_tpu_torch import config
    from pauxy_tpu_torch.ops import gemm3_cuda

    af = build(name)
    af.run_block()
    torch.cuda.synchronize()
    groups = {}
    wrapped = gemm3_cuda.gemm

    def timed(a, b, c=None, alpha=1.0, beta=0.0):
        key = (tuple(a.shape), a.stride(), a.is_conj(), tuple(b.shape),
               b.stride(), b.is_conj(), str(a.dtype).split(".")[-1])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapped(a, b, c, alpha, beta)
        end.record()
        end.synchronize()
        g = groups.setdefault(key, {"calls": 0, "ms": 0.0, "a": like(a),
                                    "b": like(b),
                                    "plan": gemm3_cuda.plan(a, b)})
        g["calls"] += 1
        g["ms"] += start.elapsed_time(end)
        return out

    gemm3_cuda.gemm = timed
    try:
        af.run_block()
        torch.cuda.synchronize()
    finally:
        gemm3_cuda.gemm = wrapped
    del af
    config.set_matmul_precision("float32", "cuda")
    for key, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"])[:12]:
        a, b, pl = g["a"], g["b"], g["plan"]
        print(json.dumps({
            "path": name, "dtype": key[6], "shape_a": key[0],
            "stride_a": key[1], "conj_a": key[2], "shape_b": key[3],
            "stride_b": key[4], "conj_b": key[5], "calls": g["calls"],
            "ms_in_block": round(g["ms"], 4),
            "route": pl.route, "code": pl.code, "transposed": pl.transposed,
            "staging": [staging(pl.flags_a), staging(pl.flags_b)],
            "split_ms": round(ms_of(lambda: gemm3_cuda.gemm(a, b)), 4),
            "cublas_ms": round(ms_of(lambda: torch.matmul(a, b)), 4)}),
            flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm3_shapes: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    for name in args.paths.split(","):
        if name not in PATHS:
            raise SystemExit(f"gemm3_shapes: no path {name!r}; want one of "
                             f"{PATHS}")
        census(name)


if __name__ == "__main__":
    main()
