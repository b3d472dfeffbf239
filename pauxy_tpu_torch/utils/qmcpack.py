"""QMCPACK-format Hamiltonian / FCIDUMP I/O.

Counterpart of ``pauxy_tpu/utils/qmcpack.py`` (a copy: numpy on the host;
HDF5 through ``utils.h5lite.open_file``, so it runs where h5py is missing).
Format-compatible with the reference's readers/writers
(``pauxy/utils/io.py:81-242`` sparse/dense QMCPACK HDF5,
``pauxy/utils/hamiltonian_converter.py:8-100`` FCIDUMP) so integral files
produced for pauxy (e.g. by its pyscf tooling) load directly.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from pauxy_tpu_torch.utils import h5lite


def _as_complex_view(data: np.ndarray, shape) -> np.ndarray:
    return data.view(np.complex128).ravel().reshape(shape)


def _to_qmcpack_complex(arr: np.ndarray) -> np.ndarray:
    out = arr.astype(np.complex128).view(np.float64)
    return out.reshape(arr.shape + (2,))


def read_hamiltonian(filename: str):
    """Read a QMCPACK HDF5 integral file (dense or sparse factorized).

    Returns (h1e [M, M], chol [M, M, X], ecore, (nalpha, nbeta)).
    """
    with h5lite.open_file(filename, "r") as fh5:
        enuc = float(fh5["Hamiltonian/Energies"][:][0])
        dims = fh5["Hamiltonian/dims"][:]
        nmo = int(dims[3])
        nalpha, nbeta = int(dims[4]), int(dims[5])
        nchol = int(dims[7])

        hcore_raw = fh5["Hamiltonian/hcore"][:]
        if hcore_raw.ndim == 3 and hcore_raw.shape[-1] == 2:
            hcore = _as_complex_view(hcore_raw, (nmo, nmo))
            if np.abs(hcore.imag).max() < 1e-12:
                hcore = hcore.real
        else:
            hcore = hcore_raw

        if "Hamiltonian/DenseFactorized/L" in fh5:
            lraw = fh5["Hamiltonian/DenseFactorized/L"][:]
            if lraw.ndim == 3 and lraw.shape[-1] == 2:
                chol = _as_complex_view(lraw, (nmo * nmo, -1))
                if np.abs(chol.imag).max() < 1e-12:
                    chol = chol.real
            else:
                chol = lraw
        else:
            block_sizes = fh5["Hamiltonian/Factorized/block_sizes"][:]
            nval = int(sum(block_sizes))
            rows = np.zeros(nval, np.int64)
            cols = np.zeros(nval, np.int64)
            vals_list = []
            s = 0
            for ic, bs in enumerate(block_sizes):
                ixs = fh5[f"Hamiltonian/Factorized/index_{ic}"][:]
                rows[s : s + bs] = ixs[::2]
                cols[s : s + bs] = ixs[1::2]
                vraw = fh5[f"Hamiltonian/Factorized/vals_{ic}"][:]
                if vraw.ndim == 2 and vraw.shape[-1] == 2:
                    vals_list.append(vraw.view(np.complex128).ravel())
                else:
                    vals_list.append(np.asarray(vraw).ravel())
                s += int(bs)
            vals = np.concatenate(vals_list)
            chol = scipy.sparse.csr_matrix(
                (vals, (rows, cols)), shape=(nmo * nmo, nchol)
            ).toarray()
            if np.iscomplexobj(chol) and np.abs(chol.imag).max() < 1e-12:
                chol = chol.real
    return hcore, chol.reshape(nmo, nmo, -1), enuc, (nalpha, nbeta)


def write_hamiltonian(
    h1e: np.ndarray,
    chol: np.ndarray,
    nelec,
    ecore: float = 0.0,
    filename: str = "hamiltonian.h5",
):
    """Write the dense QMCPACK format (``io.py:176-193``)."""
    nmo = h1e.shape[-1]
    chol = np.asarray(chol).reshape(nmo * nmo, -1)
    real_ints = not (np.iscomplexobj(h1e) or np.iscomplexobj(chol))
    with h5lite.open_file(filename, "w") as fh5:
        fh5["Hamiltonian/Energies"] = np.array([ecore, 0.0])
        if real_ints:
            fh5["Hamiltonian/hcore"] = np.real(h1e)
            fh5["Hamiltonian/DenseFactorized/L"] = np.real(chol)
        else:
            fh5["Hamiltonian/hcore"] = _to_qmcpack_complex(h1e)
            fh5["Hamiltonian/DenseFactorized/L"] = _to_qmcpack_complex(chol)
        fh5["Hamiltonian/dims"] = np.array(
            [0, 0, 0, nmo, nelec[0], nelec[1], 0, chol.shape[-1]]
        )


def read_fcidump(filename: str, symmetry: int = 8, verbose: bool = False):
    """Read an FCIDUMP file into (h1e, eri [M,M,M,M] in (ik|jl), ecore,
    nelec, ms2). Counterpart of ``hamiltonian_converter.py:8-100``.

    The body parse (the setup hot path — molecular files reach 1e6+ lines)
    runs in the native C++ loader (``pauxy_tpu_torch.native``) when the toolchain
    is available; this Python parse is the behavioural oracle and fallback.
    """
    import re

    with open(filename) as f:
        content = f.read()
    header, _, body = content.partition("&END")
    if not body:
        header, _, body = content.partition("/")
    norb = int(re.search(r"NORB\s*=\s*(\d+)", header).group(1))
    nelec = int(re.search(r"NELEC\s*=\s*(\d+)", header).group(1))
    ms2_m = re.search(r"MS2\s*=\s*(-?\d+)", header)
    ms2 = int(ms2_m.group(1)) if ms2_m else 0
    nalpha = (nelec + ms2) // 2
    nbeta = nelec - nalpha

    # Complex integrals are written as "(re, im)  i j k l"
    # (``hamiltonian_converter.py:295-360`` / our hubbard.fcidump).
    cplx = "(" in body

    try:
        from pauxy_tpu_torch import native

        res = native.fcidump_fill(body.encode(), norb, cplx)
    except ValueError as e:
        # Malformed for the strict native parser (which validates every
        # index and returns the byte offset). The permissive Python parser
        # below SKIPS unparseable lines, so a truncated/corrupt file can
        # load partially — warn loudly rather than hide the problem.
        import warnings

        warnings.warn(
            f"native FCIDUMP parse of {filename!r} failed ({e}); retrying "
            "with the permissive Python parser, which silently skips "
            "unparseable lines — verify the file if this is unexpected",
            stacklevel=2,
        )
        res = None
    if res is not None:
        h1e, eri, ecore = res
        return h1e, eri, ecore.real if cplx else ecore, (nalpha, nbeta), ms2
    dtype = complex if cplx else float
    h1e = np.zeros((norb, norb), dtype=dtype)
    eri = np.zeros((norb, norb, norb, norb), dtype=dtype)
    ecore = 0.0
    for line in body.strip().splitlines():
        if cplx:
            m = re.match(
                r"\s*\(\s*([^,]+)\s*,\s*([^)]+)\s*\)\s+"
                r"(\d+)\s+(\d+)\s+(\d+)\s+(\d+)", line)
            if m is None:
                continue
            v = complex(float(m.group(1)), float(m.group(2)))
            i, j, k, l = (int(m.group(x)) for x in range(3, 7))
        else:
            parts = line.split()
            if len(parts) < 5:
                continue
            v = float(parts[0])
            i, j, k, l = (int(x) for x in parts[1:5])
        if i == j == k == l == 0:
            ecore = v.real if cplx else v
        elif k == 0 and l == 0:
            h1e[i - 1, j - 1] = v
            h1e[j - 1, i - 1] = np.conj(v)
        else:
            # Chemist notation (ij|kl); store as (ik|jl)-style 4-index with
            # the full 8-fold symmetry.
            ii, jj, kk, ll = i - 1, j - 1, k - 1, l - 1
            for (a, b, c, d) in (
                (ii, jj, kk, ll), (jj, ii, kk, ll), (ii, jj, ll, kk),
                (jj, ii, ll, kk), (kk, ll, ii, jj), (ll, kk, ii, jj),
                (kk, ll, jj, ii), (ll, kk, jj, ii),
            ):
                eri[a, b, c, d] = v
    return h1e, eri, ecore, (nalpha, nbeta), ms2


def modified_cholesky(eri_mat: np.ndarray, tol: float = 1e-6,
                      cmax: int = 30, verbose: bool = False) -> np.ndarray:
    """Pivoted (modified) Cholesky of the ERI supermatrix M[(ik),(jl)].

    Returns L [M^2, nchol] with M ~= L L^T. Counterpart of
    ``pauxy/utils/linalg.py:112-161``.
    """
    n = eri_mat.shape[0]
    diag = eri_mat.diagonal().copy().astype(float)
    nmax = min(n, max(cmax * int(np.sqrt(n)), 1))
    vecs = np.empty((nmax, n))
    k = 0
    for _ in range(nmax):
        p = int(np.argmax(diag))
        dmax = diag[p]
        if dmax <= tol:
            break
        col = eri_mat[:, p].astype(float)
        # Subtract the projection onto the k factors found so far as ONE
        # GEMV (the per-vector Python loop is the conversion hot path for
        # molecular supermatrices, n = M^2 ~ 1e4).
        if k:
            col = col - vecs[:k].T @ vecs[:k, p]
        v_new = col / np.sqrt(dmax)
        vecs[k] = v_new
        k += 1
        diag -= v_new * v_new
        diag = np.maximum(diag, 0.0)
    return vecs[:k].T.copy() if k else np.zeros((n, 0))


def fcidump_to_system(filename: str, chol_tol: float = 1e-6, *,
                      device=None, dtype=None):
    """FCIDUMP -> Generic system (the ``bin/fcidump_to_afqmc.py`` path) on
    ``device`` at precision ``dtype``."""
    from pauxy_tpu_torch.models.generic import make_generic

    h1e, eri, ecore, nelec, _ = read_fcidump(filename)
    m = h1e.shape[0]
    # (ik|jl) supermatrix with rows (i,k), columns (j,l).
    mat = eri.transpose(0, 1, 2, 3).reshape(m * m, m * m)
    chol = modified_cholesky(mat, tol=chol_tol)
    return make_generic(nelec, h1e, chol.reshape(m, m, -1), ecore,
                        device=device, dtype=dtype)
