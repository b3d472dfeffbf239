"""Where a block of the cpqr kernel, kernel A, the Cholesky-inverse
kernel, the sweep kernel, the bf16 Taylor kernel and the split GEMM's
wgmma tiles spends its cycles, on one CUDA card.

    python3 tools/kernel_stamps.py [--csrc DIR] [--only chol,sweep,taylor_bf16,gemm3]

Copies csrc/cpqr.cu, csrc/greens.cu, csrc/chol_inv.cu, csrc/sweep.cu and
csrc/taylor_bf16.cu (or those in DIR, e.g. another build of the same
kernels) into build/stamps/, puts clock64() stamps between their phases
(thread 0 of block 0 adds each phase's cycles to a device array), builds
each copy with nvcc like ops/cuda_build.py, and prints the cycles by phase
and the call's time (CUDA events) at the thermal UEG shape (512, 93), one
matrix (1, 93) and the thermal Hubbard shape (64, 9) in both types; kernel
A at (16, 7) with W = 1 and 1024; the Cholesky kernel at the discrete and
Generic paths' shapes (n = 7 and 16 with 1024 matrices, n = 42 with 256
and 1); the sweep at (16, 7, 7) with W = 1024 and 1, with every seventh
walker dead and with none; the bf16 Taylor kernel's resident route at the
UEG bench class (M, C) = (257, 14) with w = 512 and 1 (and w = 512 in
clusters of 4 and 8), and the golden's (33, 14) with w = 40 (there every
CTA's thread 0 adds its phases, and the mean a CTA is printed: the V
load, each order's products, the exchange of the term through
distributed shared memory, the cluster barrier); the split GEMM
(csrc/gemm_bf16x3.cu, built with PAUXY_GEMM3_STAMPS, which compiles in
its own GEMM3_STAMP markers) at the Generic VHS shape in float32, with A
the real plane of a complex64 tensor and in complex64, the "xla" Taylor
product and the thermal UEG's [512, 93, 93] product: the mean cycles of a
consumer warpgroup's phases (wait for a slab, convert, fence and barrier,
issue the products, wait for the previous slab's, drain, the epilogue's
shared-memory and global halves, the wait for a tile's first slab, the
barrier after the epilogue) and of the producer's (wait for a free stage,
issue the loads), per persistent block. --only names the
kernels to stamp (cpqr, greens, chol, sweep, taylor_bf16, gemm3). The stamps
are inserted by matching the sources' text, so the script fails loudly
when a phase it marks has been rewritten: adapt the markers then. A cpqr
or kernel A stamp costs a few cycles and a global add, so their sums run
a little above the unstamped kernel; the Cholesky, sweep and bf16 Taylor
stamps add into registers, written once at the end. The card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from pauxy_tpu_torch.ops import (batchla_cuda, cuda_build,  # noqa: E402
                                 greens_cuda, sweep_cuda, taylor_cuda)

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
# The Cholesky and sweep kernels' stamps add into registers and thread 0
# of block 0 writes them once at the end: a global add a stamp would wait
# on its load inside the chain it measures.
STAMP_REG = ("__device__ long long g_prof[32];\n"
             "#define STAMP(i) do { long long _t = clock64(); "
             "_acc[i] += _t - _t0; _t0 = _t; } while (0)\n"
             "#define STAMP_FLUSH() do { if (blockIdx.x == 0 && "
             "threadIdx.x == 0) { for (int _q = 0; _q < 16; ++_q) "
             "g_prof[_q] += _acc[_q]; } } while (0)\n")
STAMP_INIT = "  long long _t0 = clock64();\n  long long _acc[16] = {};\n"
CHOL_PHASES = ["load", "phase A", "barrier A", "phase B", "barrier B",
               "out"]
SWEEP_PHASES = ["load", "prefetch", "G_ii", "decision", "row", "t1 t2 dot",
                "sync 1", "update", "sync 2"]
# The bf16 Taylor kernel's resident route: every CTA's thread 0 adds its
# register-accumulated phases to the device array once, at its end, and
# counts itself in slot 31.
STAMP_ALL = ("__device__ unsigned long long g_prof[32];\n"
             "#define STAMP(i) do { long long _t = clock64(); "
             "_acc[i] += _t - _t0; _t0 = _t; } while (0)\n"
             "#define STAMP_FLUSH() do { if (threadIdx.x == 0) { "
             "for (int _q = 0; _q < 16; ++_q) atomicAdd(&g_prof[_q], "
             "(unsigned long long)_acc[_q]); atomicAdd(&g_prof[31], 1ull); "
             "} } while (0)\n")
# The split GEMM's tile route (csrc/gemm_bf16x3.cu carries its own
# GEMM3_STAMP markers, compiled in with PAUXY_GEMM3_STAMPS): each block's
# first thread of each consumer warpgroup and of the producer warpgroup
# add their phases once, at their end.
GEMM3_CONSUMER = ["wait full", "convert", "fence + barrier", "issue wgmma",
                  "wait group", "drain", "epilogue to smem",
                  "epilogue stores", "wait full, a tile's first slab",
                  "end barrier"]
GEMM3_PRODUCER = ["wait empty", "issue loads"]
BF16_PHASES = ["V issue, phi, sums", "V load and round", "products order 1",
               "products own rows", "products other rows", "start wait",
               "cluster wait", "term to own buffer", "term to other CTAs",
               "arrive + CTA barrier", "out"]
CSRC = cuda_build.CSRC


def put(src: str, marker: str, text: str, after: bool = True) -> str:
    """Insert text after (or before) the one occurrence of marker."""
    if src.count(marker) != 1:
        raise SystemExit(f"kernel_stamps: marker not found once: {marker!r}")
    return src.replace(marker, marker + text if after else text + marker)


def stamped_cpqr() -> str:
    s = open(os.path.join(CSRC, "cpqr.cu")).read()
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
    s = open(os.path.join(CSRC, "greens.cu")).read()
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


def stamped_chol() -> str:
    s = open(os.path.join(CSRC, "chol_inv.cu")).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP_REG, 1)
    s = put(s, "  const int tg = threadIdx.x % group;\n", STAMP_INIT,
            after=False)
    s = put(s, "  T ldl = T(0);\n", "  STAMP(0);\n")
    s = put(s, "    id_prev = id;\n", "    STAMP(1);\n")
    s = put(s, "    // ---- phase B:", "    STAMP(2);\n", after=False)
    s, n = re.subn(r"(    sync_group<\w+>\(\);\n)(  }\n  if \(tg == 0\) a\[)",
                   r"    STAMP(3);\n\1    STAMP(4);\n\2", s)
    if n != 1:
        raise SystemExit("kernel_stamps: chol_inv.cu's step end not found")
    s = put(s, "}\n\n// The plan's launch, checked",
            "  STAMP(5);\n  STAMP_FLUSH();\n", after=False)
    return s + GET


def stamped_sweep() -> str:
    s = open(os.path.join(CSRC, "sweep.cu")).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP_REG, 1)
    s = put(s, "  const int r = threadIdx.x % G;\n", STAMP_INIT, after=False)
    s = put(s, "  for (int i = 0; i < m; ++i) {\n", "  STAMP(0);\n",
            after=False)
    s = put(s, "    u = ur[i1 * in.rs_s[0]];\n", "    STAMP(1);\n")
    s = put(s, "    // Heat-bath probabilities", "    STAMP(2);\n",
            after=False)
    s = put(s, "fields[(size_t)wk * m + i] = xi ? 1 : 0;\n", "    STAMP(3);\n")
    s = put(s, "    // Sherman-Morrison", "    STAMP(4);\n", after=False)
    mark = "    __syncwarp();  // every lane has read the columns\n"
    s = put(s, mark, "    STAMP(5);\n", after=False)
    s = put(s, mark, "    STAMP(6);\n")
    mark = ("    __syncwarp();  // the rows are updated before the next "
            "site reads them\n")
    s = put(s, mark, "    STAMP(7);\n", after=False)
    s = put(s, mark, "    STAMP(8);\n")
    s = put(s, "  if (valid && r == 0) {\n    weight_out[wk] = wt;",
            "  STAMP_FLUSH();\n", after=False)
    return s + GET


def stamped_bf16() -> str:
    s = open(os.path.join(CSRC, "taylor_bf16.cu")).read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP_ALL, 1)
    s = put(s, "  const bool active = r0 < mp;\n", STAMP_INIT)
    s = put(s, "  if (active) vl.finish(sr, si, lane);\n", "  STAMP(0);\n",
            after=False)
    s = put(s, "  if (active) vl.finish(sr, si, lane);\n  __syncwarp();\n",
            "  STAMP(1);\n")
    s = put(s, "    if (k > 1 && c > 1) {\n      cluster_wait();\n",
            "    if (k == 1) STAMP(2); else STAMP(3);\n", after=False)
    s = put(s, "    if (k > 1 && c > 1) {\n      cluster_wait();\n",
            "      STAMP(6);\n")
    s = put(s, "    // Every CTA of the cluster has started",
            "    STAMP(4);\n", after=False)
    s = put(s, "    if (k == 1) cluster_wait();\n", "    STAMP(5);\n")
    s = put(s, "      if (c > 1) {\n        __syncwarp();", "      STAMP(7);\n",
            after=False)
    s = put(s, "    // This order's term is in every CTA before any reads it",
            "    STAMP(8);\n", after=False)
    s = put(s, "  }\n  if (order == 0) cluster_wait();\n", "    STAMP(9);\n",
            after=False)
    s = put(s, "              make_float2(sumr[j][i], sumi[j][i]);\n"
               "        }\n      }\n    }\n  }\n",
            "  STAMP(10);\n  STAMP_FLUSH();\n")
    return s + GET


def build(name: str, src: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    for h in ("gauss_jordan.cuh",):
        with open(os.path.join(OUT, h), "w") as f:
            f.write(open(os.path.join(CSRC, h)).read())
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.FLAGS, "-shared",
                          "-o", so, cu], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    return ctypes.CDLL(so)


def main() -> None:
    global CSRC
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=str(CSRC),
                    help="directory of the kernel sources to stamp")
    ap.add_argument("--only",
                    default="cpqr,greens,chol,sweep,taylor_bf16,gemm3")
    args = ap.parse_args()
    CSRC = args.csrc
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_stamps: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    P, I = ctypes.c_void_p, ctypes.c_int
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

    if "cpqr" in only:
        stamp_cpqr(run, P, I)
    if "greens" in only:
        stamp_greens(run, P, I)
    if "chol" in only:
        stamp_chol(run, P, I)
    if "sweep" in only:
        stamp_sweep(run, P, I)
    if "taylor_bf16" in only:
        stamp_bf16(P, I, buf)
    if "gemm3" in only:
        stamp_gemm3()


def stamp_cpqr(run, P, I) -> None:
    cp = build("cpqr_stamped", stamped_cpqr())
    for f in (cp.pauxy_cpqr_c64, cp.pauxy_cpqr_c128):
        f.argtypes = (P,) * 4 + (I, I, P)
    for dtype, fn in ((torch.complex64, cp.pauxy_cpqr_c64),
                      (torch.complex128, cp.pauxy_cpqr_c128)):
        for b, m in ((512, 93), (1, 93), (64, 9)):
            a = torch.randn(b, m, m, dtype=dtype, device="cuda")
            q, r = torch.empty_like(a), torch.empty_like(a)
            p = torch.empty(b, m, dtype=torch.long, device="cuda")
            run(cp, lambda: fn(a.data_ptr(), q.data_ptr(), r.data_ptr(),
                               p.data_ptr(), b, m, None),
                CPQR_PHASES, f"cpqr {dtype} (B,m)=({b},{m})")


def stamp_greens(run, P, I) -> None:
    gr = build("greens_stamped", stamped_greens())
    gr.pauxy_greens_lanes_c64.argtypes = (P,) * 4 + (I,) * 8 + (P,)
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


def stamp_chol(run, P, I) -> None:
    ch = build("chol_stamped", stamped_chol())
    ch.pauxy_chol_inv_c64.argtypes = (P, P, P) + (I,) * 6 + (P,)
    for n, w in ((7, 1024), (16, 1024), (42, 256), (42, 1)):
        phi = torch.randn(w, 2 * n, n, dtype=torch.complex64, device="cuda")
        s = (phi.mH @ phi).contiguous()
        ld = torch.empty(w, dtype=torch.float32, device="cuda")
        linv = torch.empty_like(s)
        pl = batchla_cuda.chol_plan(n, torch.complex64)
        run(ch, lambda: ch.pauxy_chol_inv_c64(
                s.data_ptr(), ld.data_ptr(), linv.data_ptr(), n, w,
                pl.threads, pl.group, pl.rows, pl.ld, None),
            CHOL_PHASES, f"chol_inv n={n} w={w} c64 {pl}")


def stamp_sweep(run, P, I) -> None:
    from chip_smoke import sweep_inputs

    sw = build("sweep_stamped", stamped_sweep())
    sw.pauxy_hirsch_sweep_f32.argtypes = (P,) * 16 + (I,) * 8 + (P,)
    rng = np.random.default_rng(8)
    m, na, nb = 16, 7, 7
    for w, dead in ((1024, True), (1024, False), (1, False)):
        args = sweep_inputs(rng, m, na, nb, w, torch.float32)
        if not dead:
            args[9].fill_(1.0)
        strides = (ctypes.c_longlong * 22)(*(st for a in args
                                              for st in a.stride()))
        outs = [torch.empty((w, m, na), device="cuda"),
                torch.empty((w, m, nb), device="cuda"),
                torch.empty(w, device="cuda"), torch.empty(w, device="cuda"),
                torch.empty((w, m), dtype=torch.int32, device="cuda")]
        pl = sweep_cuda.plan(na, nb)
        run(sw, lambda: sw.pauxy_hirsch_sweep_f32(
                *(a.data_ptr() for a in list(args) + outs),
                ctypes.addressof(strides), m, na, nb, w, pl.lanes,
                pl.walkers, pl.lda, pl.ldb, None),
            SWEEP_PHASES, f"sweep (16,7,7) W={w} "
            f"{'every seventh walker dead' if dead else 'all alive'} {pl}")


def stamp_bf16(P, I, buf) -> None:
    tb = build("taylor_bf16_stamped", stamped_bf16())
    fn = tb.pauxy_taylor_bf16_resident
    fn.argtypes = (P, P, P) + (I,) * 6 + (P,)
    for m, ncol, w, cluster in ((257, 14, 512, None), (257, 14, 1, None),
                                (33, 14, 40, None), (257, 14, 512, 4),
                                (257, 14, 512, 8)):
        plan = taylor_cuda.route_bf16(m, ncol)
        if cluster is not None:
            plan = taylor_cuda.resident_plan(m, ncol, cluster)
        vhs = (0.3 / m ** 0.5) * torch.randn(w, m, m, dtype=torch.complex64,
                                             device="cuda")
        phi = torch.randn(w, m, ncol, dtype=torch.complex64, device="cuda")
        out = torch.empty_like(phi)

        def call():
            rc = fn(vhs.data_ptr(), phi.data_ptr(), out.data_ptr(), w, m,
                    ncol, 6, plan.cluster, plan.tiles, None)
            if rc:
                raise SystemExit(f"kernel_stamps: bf16 launch failed {rc}")

        call()
        torch.cuda.synchronize()
        tb.prof_zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        tb.prof_get(buf)
        ctas = max(buf[31], 1)
        cycles = {k: round(v / ctas, 1) for k, v in
                  zip(BF16_PHASES, list(buf)[:len(BF16_PHASES)])}
        print(f"taylor_bf16 resident (M,C)=({m},{ncol}) w={w} {plan} "
              f"{start.elapsed_time(end):.4f} ms, {ctas} CTAs, mean cycles "
              f"a CTA {round(sum(cycles.values()), 1)}: {cycles}",
              flush=True)


def gemm3_cases():
    """(label, a, b) of the split GEMM at the Generic VHS shape (float32,
    the same with A the real plane of a complex64 tensor, complex64), the
    "xla" Taylor product and the thermal UEG's [512, 93, 93] product."""
    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, dtype=dtype, device="cuda")

    c64 = torch.complex64
    b = rnd(512, 16384)
    return [("f32 [1024,512]x[512,16384]", rnd(1024, 512), b),
            ("f32 A .real of c64 [1024,512]", rnd(1024, 512, dtype=c64).real,
             b),
            ("c64 [1024,512]x[512,16384]", rnd(1024, 512, dtype=c64),
             rnd(512, 16384, dtype=c64)),
            ("c64 [512,257,257]x[512,257,14]", rnd(512, 257, 257, dtype=c64),
             rnd(512, 257, 14, dtype=c64)),
            ("c64 [512,93,93]x[512,93,93]", rnd(512, 93, 93, dtype=c64),
             rnd(512, 93, 93, dtype=c64))]


def stamp_gemm3() -> None:
    from pauxy_tpu_torch.ops import gemm3_cuda

    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "gemm3_stamped.so")
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.FLAGS,
                          "-DPAUXY_GEMM3_STAMPS", "-shared", "-o", so,
                          os.path.join(CSRC, "gemm_bf16x3.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    lib = ctypes.CDLL(so)
    saved = dict(gemm3_cuda._fns)
    for dtype, name in gemm3_cuda._SYMBOLS.items():
        fn = getattr(lib, name)
        fn.argtypes = cuda_build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        gemm3_cuda._fns[dtype] = fn
    buf = (ctypes.c_ulonglong * 32)()
    try:
        for label, a, b in gemm3_cases():
            pl = gemm3_cuda.plan(a, b)
            gemm3_cuda.gemm(a, b)
            torch.cuda.synchronize()
            lib.prof_zero()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            gemm3_cuda.gemm(a, b)
            end.record()
            end.synchronize()
            lib.prof_get(buf)
            nc, npr = max(buf[12], 1), max(buf[28], 1)
            cons = {k: round(v / nc) for k, v in
                    zip(GEMM3_CONSUMER, list(buf)[:len(GEMM3_CONSUMER)])}
            prod = {k: round(v / npr) for k, v in
                    zip(GEMM3_PRODUCER, list(buf)[16:16 + 2])}
            print(f"gemm3 {label} route {pl.route} {pl.code} flags "
                  f"{pl.flags_a}/{pl.flags_b}: "
                  f"{start.elapsed_time(end):.4f} ms (stamped), mean cycles "
                  f"a consumer warpgroup {sum(cons.values())}: {cons}; "
                  f"the producer: {prod}", flush=True)
    finally:
        gemm3_cuda._fns.clear()
        gemm3_cuda._fns.update(saved)


if __name__ == "__main__":
    main()
