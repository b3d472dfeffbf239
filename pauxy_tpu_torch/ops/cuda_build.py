"""Build and load the CUDA kernels of ``pauxy_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The build happens at first use, never at import,
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
SOURCES = ("gauss_jordan.cuh", "greens.cu", "batchla.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; each returns the cudaError_t of its launch.
SIGNATURES = {
    "pauxy_greens_lanes_c64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pauxy_greens_lanes_c128": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pauxy_inv_logdet_lanes_c64": (_P, _P, _P, _I, _I, _I, _P),
    "pauxy_inv_logdet_lanes_c128": (_P, _P, _P, _I, _I, _I, _P),
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
    Returns (path, seconds spent compiling). The compiler's report
    (registers, shared memory, spills) is kept beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES if s.endswith(".cu"))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
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
