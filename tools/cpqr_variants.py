"""The cpqr kernel's block route under other constants, timed in turns
against the checked-in ones on one CUDA card.

    python3 tools/cpqr_variants.py

Builds csrc/cpqr.cu once as it is and once per variant below (the block
route's threads, lanes a column, columns a pass, rows held in registers, or
the column order of a half-warp's groups changed in a copy under
build/variants/, one nvcc each, all at once), prints each build's registers
and spills, then times every build's call (CUDA events, median of 10 after
a warm-up, in the order a, b, ..., b, a) at (512, 93), (1, 93), (37, 48)
and (2, 115) in complex64 and complex128, after checking its factors'
residual. The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from pauxy_tpu_torch.ops import cuda_build  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
# name -> constants changed (threads, lanes a column, columns a pass, rows
# in registers; "noperm": adjacent columns for a half-warp's two groups).
VARIANTS = {
    "checked-in": {},
    "16 lanes, 6 columns": {"kBlockGroup": 16, "kBlockRc": 6},
    "4 lanes, 2 columns": {"kBlockGroup": 4, "kBlockRc": 2},
    "12 rows in registers": {"kBlockRm": 12},
    "512 threads, 2 columns": {"kBlockThreads": 512, "kBlockRc": 2},
    "adjacent columns": {"noperm": True},
}


def variant_source(base: str, changes: dict) -> str:
    s = base
    for key, val in changes.items():
        if key == "noperm":
            s, n = re.subn(r"if \(G == 8 && NG == 32 && sizeof\(T\) == 4\)",
                           "if (false)", s)
        else:
            s, n = re.subn(rf"constexpr int {key} = \d+;",
                           f"constexpr int {key} = {val};", s)
        if n != 1:
            raise SystemExit(f"cpqr_variants: {key} not found in cpqr.cu")
    if changes.get("kBlockThreads", 256) > 256:
        # Two blocks an SM, as the 256-thread build has.
        s = s.replace(
            "__launch_bounds__(NT * TEAMS)",
            "__launch_bounds__(NT * TEAMS, NT * TEAMS > 256 ? 2 : 1)")
    return s


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cpqr_variants: no CUDA device")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "gauss_jordan.cuh"), "w") as f:
        f.write(open(os.path.join(cuda_build.CSRC, "gauss_jordan.cuh")).read())
    base = open(os.path.join(cuda_build.CSRC, "cpqr.cu")).read()
    jobs = {}
    for i, (name, changes) in enumerate(VARIANTS.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(base, changes))
        so = cu[:-3] + ".so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    libs = {}
    for name, (so, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(text)
        print(name, "|", " | ".join(
            line.split("info    : ")[-1].strip() for line in text.splitlines()
            if "Used" in line or ("spill" in line and "0 bytes spill s" not in
                                  line)))
        lib = ctypes.CDLL(so)
        for fn in ("pauxy_cpqr_c64", "pauxy_cpqr_c128"):
            getattr(lib, fn).argtypes = (ctypes.c_void_p,) * 4 + (
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
        libs[name] = lib
    for dtype, fn in ((torch.complex64, "pauxy_cpqr_c64"),
                      (torch.complex128, "pauxy_cpqr_c128")):
        for b, m in ((512, 93), (1, 93), (37, 48), (2, 115)):
            a = torch.randn(b, m, m, dtype=dtype, device="cuda")
            q, r = torch.empty_like(a), torch.empty_like(a)
            p = torch.empty(b, m, dtype=torch.long, device="cuda")
            ms = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                call = getattr(libs[name], fn)
                args = (a.data_ptr(), q.data_ptr(), r.data_ptr(),
                        p.data_ptr(), b, m, None)
                for _ in range(2):
                    if call(*args) != 0:
                        raise SystemExit(f"{name}: launch failed")
                torch.cuda.synchronize()
                ap = torch.gather(a, 2, p[:, None, :].expand(b, m, m))
                rec = (torch.linalg.matrix_norm(ap - q @ r)
                       / torch.linalg.matrix_norm(a)).max().item()
                if rec > 1e-5:
                    raise SystemExit(f"{name}: residual {rec:.3e}")
                for _ in range(10):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call(*args)
                    end.record()
                    end.synchronize()
                    ms[name].append(start.elapsed_time(end))
            print(f"{dtype} (B,m)=({b},{m}) ms:", {
                k: round(statistics.median(v), 4) for k, v in ms.items()},
                flush=True)


if __name__ == "__main__":
    main()
