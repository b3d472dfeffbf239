"""Native (C++) host code, loaded with ctypes: the FCIDUMP body parser.

Counterpart of ``pauxy_tpu/native``. The text parse of an FCIDUMP body
dominates the set-up of a molecular run, so it is C++ (``fcidump.cpp``,
this package's own copy), compiled with ``g++`` at first use into
``build/pauxy_tpu_torch/`` at the root of the checkout, under a name keyed
on a hash of the source and flags, through a temporary file renamed into
place so that concurrent test workers never load a half-written library.
``utils/qmcpack.read_fcidump`` keeps the Python parser as the behavioural
oracle and the fallback; ``PAUXY_TPU_NO_NATIVE`` turns the native parser
off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fcidump.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pauxy_tpu_torch"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpauxy_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the source into ``out`` through a temporary file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    """Build (unless a build of this source exists) and load the library;
    the result, or the reason there is none, is kept."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        if os.environ.get("PAUXY_TPU_NO_NATIVE"):
            _LIB_ERR = "disabled by PAUXY_TPU_NO_NATIVE"
            return None
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            fn = lib.pauxy_fcidump_fill
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            _LIB = lib
        except (OSError, subprocess.SubprocessError) as e:
            _LIB_ERR = f"{type(e).__name__}: {e}"
            return None
    return _LIB


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _LIB_ERR


def fcidump_fill(body: bytes, norb: int, cplx: bool):
    """Parse an FCIDUMP body (everything after &END) natively.

    Returns (h1e [norb, norb], eri [norb]*4, ecore), float64 or complex128,
    or None when the native library is unavailable. Raises ValueError on a
    malformed body, with its byte offset (out-of-range orbital indices
    included: the C side checks them before any store).
    """
    lib = _load()
    if lib is None:
        return None
    dtype = np.complex128 if cplx else np.float64
    h1e = np.zeros((norb, norb), dtype=dtype)
    eri = np.zeros((norb, norb, norb, norb), dtype=dtype)
    ecore = np.zeros(1, dtype=dtype)
    dptr = ctypes.POINTER(ctypes.c_double)
    n = lib.pauxy_fcidump_fill(
        body, len(body), norb, int(cplx),
        h1e.ctypes.data_as(dptr), eri.ctypes.data_as(dptr),
        ecore.ctypes.data_as(dptr),
    )
    if n < 0:
        raise ValueError(
            f"malformed FCIDUMP entry near byte {-n - 1} of the body")
    return h1e, eri, complex(ecore[0]) if cplx else float(ecore[0])
