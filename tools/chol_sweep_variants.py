"""The Cholesky-inverse and sweep kernels under other launch plans and
other constants, timed against the checked-in ones on one CUDA card.

    python3 tools/chol_sweep_variants.py

Both kernels take their launch (threads a block, lanes a matrix or walker)
at run time, so one build serves every plan: each is the wrapper's call
with its plan (``batchla_cuda.chol_plan``, ``sweep_cuda.plan``) replaced.
The constants (``CONSTANTS``: row entries a thread updates at once) are
compiled in, so each of those is a copy of its source under
build/variants/ with one constant changed, built by its own nvcc, all at
once, and called through the same wrapper. For each shape of the main
paths (and the route edge n = 32) and each variant, it checks the result
against the plain version (1e-4 of the scale, the sweep's fields
identical) and prints the kernel's device time (``chip_smoke.device_ms``,
the profiler's time a launch over 20 launches), the checked-in build and
plan first. The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import device_ms, hpd, nvidia_smi, sweep_inputs  # noqa: E402
from pauxy_tpu_torch.ops import (batchla_cuda, cuda_build,  # noqa: E402
                                 sweep_cuda)

C64 = torch.complex64
Plan = batchla_cuda.CholPlan
OUT = os.path.join(ROOT, "build", "variants")
# (source, constant) -> the other values built.
CONSTANTS = {("chol_inv.cu", "kBlockChunk"): (2, 4),
             ("chol_inv.cu", "kChunk"): (2, 8),
             ("sweep.cu", "kChunk"): (4, 16)}


def build_constants() -> dict:
    """One library a changed constant, compiled at once: {(source,
    constant, value): CDLL}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for (src, const), values in CONSTANTS.items():
        base = open(os.path.join(cuda_build.CSRC, src)).read()
        for v in values:
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {v};", base)
            if n != 1:
                raise SystemExit(f"chol_sweep_variants: {const} not in {src}")
            stem = os.path.join(OUT, f"{src[:-3]}_{const}_{v}")
            with open(stem + ".cu", "w") as f:
                f.write(text)
            cmd = [cuda_build.nvcc(), *cuda_build.FLAGS, "-shared",
                   f"-I{cuda_build.CSRC}", "-o", stem + ".so", stem + ".cu"]
            jobs[(src, const, v)] = (stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (stem, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chol_sweep_variants: nvcc {key}:\n{text}")
        lib = ctypes.CDLL(stem + ".so")
        for name, argtypes in cuda_build.SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def chol_variants(n: int) -> dict:
    """The checked-in plan, the lanes route with other block sizes (n <=
    32), the block route with 64 to 1024 threads."""
    out = {"checked-in": batchla_cuda.chol_plan(n, C64)}
    ld = out["checked-in"].ld
    if n <= 32:
        g = 1 << (n - 1).bit_length()
        for t in (32, 128, 256):
            out[f"lanes, {t} threads"] = Plan("lanes", max(t, g), g, g, ld)
    for t in (64, 128, 256, 512, 1024):
        if t >= n and (n > 32 or t > 32):
            out[f"block, {t} threads"] = Plan("block", t, t, n, ld)
    return out


def timed(kernel: str, fn, ref, check) -> float:
    out = fn()
    torch.cuda.synchronize()
    check(out, ref)
    return device_ms(fn, kernel)


def close(out, ref, fields=False):
    for k, p in zip(out[:4], ref[:4]):
        d = float((k - p).abs().max())
        if d > 1e-4 * max(float(p.abs().max()), 1.0):
            raise AssertionError(f"variant disagrees: {d:.3e}")
    if fields and not torch.equal(out[4], ref[4]):
        raise AssertionError("variant's fields differ")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chol_sweep_variants: no CUDA device")
    print(nvidia_smi(), flush=True)
    libs = build_constants()
    rng = np.random.default_rng(8)
    base_lib = cuda_build.library()
    base_plan, base_sweep = batchla_cuda.chol_plan, sweep_cuda.plan

    def report(kernel, shape, variant, fn, ref, check, lib=base_lib,
               plan=None):
        """Time fn with the library and (if given) the plan swapped in."""
        cuda_build.library = lambda: lib
        if plan is not None and kernel == "chol_inv":
            batchla_cuda.chol_plan = lambda *_: plan
        if plan is not None and kernel == "hirsch_sweep":
            sweep_cuda.plan = lambda *_: plan
        try:
            ms = timed(kernel, fn, ref, check)
        finally:
            cuda_build.library = lambda: base_lib
            batchla_cuda.chol_plan, sweep_cuda.plan = base_plan, base_sweep
        print(json.dumps({"kernel": kernel, "shape": shape,
                          "variant": variant, "device_ms": ms}), flush=True)

    for n, w in ((7, 1024), (16, 1024), (32, 1024), (42, 256)):
        s = torch.from_numpy(hpd(rng, w, n)).to("cuda", C64)
        ref = batchla_cuda.chol_inv_lanes_plain(s)
        shape = f"n={n} w={w} c64"
        call = lambda: batchla_cuda.chol_inv_lanes(s)  # noqa: E731
        for name, pl in chol_variants(n).items():
            report("chol_inv", shape, name, call, ref, close, plan=pl)
        for (src, const, v), lib in libs.items():
            if src == "chol_inv.cu":
                report("chol_inv", shape, f"{const} = {v}", call, ref,
                       close, lib=lib)
    for m, na, nb, w in ((16, 7, 7, 1024), (36, 32, 32, 1024)):
        args = sweep_inputs(rng, m, na, nb, w, torch.float32)
        ref = sweep_cuda.hirsch_sweep_real_plain(*args)
        shape = f"({m},{na},{nb}) W={w} f32"
        call = lambda: sweep_cuda.hirsch_sweep_real(*args)  # noqa: E731
        check = lambda o, r: close(o, r, fields=True)  # noqa: E731
        g = base_sweep(na, nb).lanes
        for t in (64, 32, 128, 256):
            pl = sweep_cuda.Plan(g, max(t, g) // g, na | 1, nb | 1)
            report("hirsch_sweep", shape,
                   "checked-in" if t == 64 else f"{max(t, g)} threads",
                   call, ref, check, plan=pl)
        for (src, const, v), lib in libs.items():
            if src == "sweep.cu":
                report("hirsch_sweep", shape, f"{const} = {v}", call, ref,
                       check, lib=lib)


if __name__ == "__main__":
    main()
