"""Where a block of the cpqr kernel and of kernel A spends its cycles, on
one CUDA card.

    python3 tools/kernel_stamps.py

Copies csrc/cpqr.cu and csrc/greens.cu into build/stamps/, puts clock64()
stamps between their phases (thread 0 of block 0 adds each phase's cycles
to a device array), builds each copy with nvcc like ops/cuda_build.py, and
prints the cycles by phase and the call's time (CUDA events) at the thermal
UEG shape (512, 93), one matrix (1, 93) and the thermal Hubbard shape
(64, 9) in both types, and kernel A at (16, 7) with W = 1 and 1024. The
stamps are inserted by matching the sources' text, so the script fails
loudly when a phase it marks has been rewritten: adapt the markers then.
A stamp costs a few cycles and a global add, so the sums run a little
above the unstamped kernel. The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from pauxy_tpu_torch.ops import cuda_build, greens_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "stamps")
STAMP = ("__device__ long long g_prof[32];\n"
         "#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
         "long long _t = clock64(); g_prof[i] += _t - _t0; _t0 = _t; } } "
         "while (0)\n")
GET = ('\nextern "C" int prof_get(long long* h) { return (int)'
       "cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
       'extern "C" int prof_zero() { long long z[32] = {0}; return (int)'
       "cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n")
CPQR_PHASES = ["pivot+scalars", "row pass", "barrier 1", "update",
               "barrier 2", "form-Q X", "barrier a", "T", "barrier b",
               "TW + V rows", "barrier c", "Q update", "barrier d"]
GREENS_PHASES = ["stage", "S", "elimination", "ghT"]


def put(src: str, marker: str, text: str, after: bool = True) -> str:
    """Insert text after (or before) the one occurrence of marker."""
    if src.count(marker) != 1:
        raise SystemExit(f"kernel_stamps: marker not found once: {marker!r}")
    return src.replace(marker, marker + text if after else text + marker)


def stamped_cpqr() -> str:
    s = open(os.path.join(cuda_build.CSRC, "cpqr.cu")).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    s = put(s, "  team_sync<NT>();\n\n  for (int k = 0; k < m; ++k) {\n",
            "    long long _t0 = clock64();\n")
    s = put(s, "    const T tk = degen ? T(0) : T(1) + aabs / anorm;\n",
            "    STAMP(0);\n")
    s = put(s, "    team_sync<NT>();\n    if (p == k && tid == 0)",
            "    STAMP(1);\n", after=False)
    s = put(s, "    if (p == k && tid == 0)", "    STAMP(2);\n", after=False)
    s = put(s, "    team_sync<NT>();\n  }\n}\n\n// Form-Q",
            "    STAMP(3);\n", after=False)
    s = put(s, "  }\n}\n\n// Form-Q", "    STAMP(4);\n", after=False)
    s = put(s, "  for (int pn = (m - 1) / kNb; pn >= 0; --pn) {\n",
            "    long long _t0 = clock64();\n")
    for i, phase in enumerate(("(b)", "(c)", "(d)")):
        s = put(s, f"    team_sync<NT>();\n    // ---- {phase}",
                f"    STAMP({5 + 2 * i});\n", after=False)
        s = put(s, f"    // ---- {phase}", f"    STAMP({6 + 2 * i});\n",
                after=False)
    s = put(s, "        A[c * ld + i] = q;\n      }\n    }\n",
            "    STAMP(11);\n")
    s = put(s, "    STAMP(11);\n    team_sync<NT>();\n", "    STAMP(12);\n")
    return s + GET


def stamped_greens() -> str:
    s = open(os.path.join(cuda_build.CSRC, "greens.cu")).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    s = put(s, "  const cplx<T> zero = mk(T(0), T(0));\n",
            "  long long _t0 = clock64();\n")
    s = put(s, "    fb = slab + wl * mn;\n  }\n", "  STAMP(0);\n")
    s = put(s, "  __syncwarp(mask);\n\n  // ---- elimination", "  STAMP(1);\n",
            after=False)
    s = put(s, "  if (valid && lane == 0) logdet[wk]", "  STAMP(2);\n",
            after=False)
    s = put(s, "      if (valid) ght[((size_t)q * n + i) * w + wk] = g;\n"
               "    }\n  }\n", "  STAMP(3);\n")
    return s + GET


def build(name: str, src: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    for h in ("gauss_jordan.cuh",):
        with open(os.path.join(OUT, h), "w") as f:
            f.write(open(os.path.join(cuda_build.CSRC, h)).read())
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.FLAGS, "-shared",
                          "-o", so, cu], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    return ctypes.CDLL(so)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_stamps: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    P, I = ctypes.c_void_p, ctypes.c_int
    cp = build("cpqr_stamped", stamped_cpqr())
    gr = build("greens_stamped", stamped_greens())
    for f in (cp.pauxy_cpqr_c64, cp.pauxy_cpqr_c128):
        f.argtypes = (P,) * 4 + (I, I, P)
    gr.pauxy_greens_lanes_c64.argtypes = (P,) * 4 + (I,) * 8 + (P,)
    buf = (ctypes.c_longlong * 32)()

    def run(lib, call, names, label):
        call()
        torch.cuda.synchronize()
        lib.prof_zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        lib.prof_get(buf)
        cycles = dict(zip(names, list(buf)[:len(names)]))
        print(f"{label} {start.elapsed_time(end):.4f} ms, block 0's cycles "
              f"{sum(cycles.values())}: {cycles}", flush=True)

    for dtype, fn in ((torch.complex64, cp.pauxy_cpqr_c64),
                      (torch.complex128, cp.pauxy_cpqr_c128)):
        for b, m in ((512, 93), (1, 93), (64, 9)):
            a = torch.randn(b, m, m, dtype=dtype, device="cuda")
            q, r = torch.empty_like(a), torch.empty_like(a)
            p = torch.empty(b, m, dtype=torch.long, device="cuda")
            run(cp, lambda: fn(a.data_ptr(), q.data_ptr(), r.data_ptr(),
                               p.data_ptr(), b, m, None),
                CPQR_PHASES, f"cpqr {dtype} (B,m)=({b},{m})")
    for w in (1, 1024):
        m, n = 16, 7
        psi = torch.randn(m, n, dtype=torch.complex64, device="cuda")
        phi = (psi[:, :, None] + 0.3 * torch.randn(
            m, n, w, dtype=torch.complex64, device="cuda")).contiguous()
        ld = torch.empty(w, dtype=torch.complex64, device="cuda")
        ght = torch.empty_like(phi)
        pl = greens_cuda.plan(m, n, torch.complex64, True)
        run(gr, lambda: gr.pauxy_greens_lanes_c64(
                psi.data_ptr(), phi.data_ptr(), ld.data_ptr(),
                ght.data_ptr(), m, n, w, 1, pl.lanes, pl.walkers, pl.ld,
                int(pl.staged), None),
            GREENS_PHASES, f"greens (M,n)=(16,7) W={w} {pl}")


if __name__ == "__main__":
    main()
