"""Build and load the CUDA kernels of ``pauxy_tpu_torch/csrc``.

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds). The build happens at first use, never at import,
into ``build/pauxy_tpu_torch/`` at the root of the checkout, keyed on a hash
of the sources and flags so that an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pauxy_tpu_torch"
SOURCES = ("gauss_jordan.cuh", "async_copy.cuh", "greens.cu", "batchla.cu",
           "chol_inv.cu", "sweep.cu", "taylor.cu", "taylor_bf16.cu", "exx.cu",
           "cpqr.cu", "gemm_bf16x3.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Shared memory one block may use on sm_90 (227 KB, pauxy::kSmemMax); the
# kernels' caps and tile plans are sized against it.
SMEM_MAX = 232448


def round_up(a: int, b: int) -> int:
    """a rounded up to a multiple of b."""
    return -(-a // b) * b


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# The split GEMM: a, b, c, d, batch, m, n, k, the four operands' (batch,
# row, column) strides, alpha and beta (re, im), A's and B's staging
# flags, the route, stream.
_GEMM3 = (_P,) * 4 + (_I,) * 4 + (_L,) * 12 + (_F,) * 4 + (_I,) * 3 + (_P,)
# name -> argtypes; each returns the cudaError_t of its launch.
SIGNATURES = {
    "pauxy_greens_lanes_c64": (_P,) * 4 + (_I,) * 8 + (_P,),
    "pauxy_greens_lanes_c128": (_P,) * 4 + (_I,) * 8 + (_P,),
    "pauxy_inv_logdet_c64": (_P, _P, _P, _I, _I, _I, _P),
    "pauxy_inv_logdet_c128": (_P, _P, _P, _I, _I, _I, _P),
    "pauxy_inv_logdet_f32": (_P, _P, _P, _I, _I, _I, _P),
    "pauxy_inv_logdet_f64": (_P, _P, _P, _I, _I, _I, _P),
    "pauxy_chol_inv_c64": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "pauxy_chol_inv_c128": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "pauxy_hirsch_sweep_f32": (_P,) * 16 + (_I,) * 8 + (_P,),
    "pauxy_hirsch_sweep_f64": (_P,) * 16 + (_I,) * 8 + (_P,),
    "pauxy_taylor_c64": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "pauxy_taylor_c128": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "pauxy_taylor_bf16": (_P, _P, _P) + (_I,) * 5 + (_P,),
    "pauxy_taylor_bf16_resident": (_P, _P, _P) + (_I,) * 6 + (_P,),
    "pauxy_exx_c64": (_P,) * 6 + (_I,) * 11 + (_P,),
    "pauxy_exx_c128": (_P,) * 6 + (_I,) * 11 + (_P,),
    "pauxy_cpqr_c64": (_P,) * 4 + (_I, _I, _P),
    "pauxy_cpqr_c128": (_P,) * 4 + (_I, _I, _P),
    "pauxy_gemm_bf16x3_f32": _GEMM3,
    "pauxy_gemm_bf16x3_c64": _GEMM3,
}

_lib = None


def nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME, or /usr/local/cuda."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpauxy_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless a build of these sources exists.
    Returns (path, seconds spent compiling). One ``nvcc -c`` per source,
    started together, then one link. The compilers' reports (registers,
    shared memory, spills) are kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in SOURCES if s.endswith(".cu")):
        obj = BUILD_DIR / f"{tag}.{src}.o"
        cmd = [nvcc(), *FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports = []
    failed = []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        reports.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_name(f"{tag}.so.tmp")
    res = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(tmp),
                          *(str(obj) for _, obj, _ in jobs)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    out.with_suffix(".log").write_text("".join(reports))
    os.replace(tmp, out)
    return out, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
