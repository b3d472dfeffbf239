"""k-point factorized Hamiltonian I/O.

The port's copy of ``pauxy_tpu/utils/hamiltonian_converter.py`` (HDF5
through ``utils.h5lite.open_file``), the counterpart of
``pauxy/utils/hamiltonian_converter.py:356-545``:
the QMCPACK KPFactorized HDF5 layout stores, per momentum transfer Q, a
Cholesky factor L^Q[k_i] of shape [nmo(k_i) * nmo(k_k), nchol(Q)] with
k_k = QKTok2[Q, k_i], such that

  (I K | J L) = sum_n L^Q[k_i][(i,k), n] * conj(L^Q[k_l][(l,j), n]).

Only +Q factors are stored for one of each (Q, -Q) pair; the -Q factor is
the conjugate of its partner (``hamiltonian_converter.py:409-419``).

``kpoint_to_supercell`` flattens the factorization into the dense
[M, M, X_tot] supercell Cholesky tensor consumed by ``models/generic.py``
(one supercell vector per (Q, n)), so k-point files run through the same
propagation and energy kernels as molecular ones.
"""

from __future__ import annotations

import numpy as np


def _to_qmcpack_complex(arr: np.ndarray) -> np.ndarray:
    """complex array -> trailing-2 real view (QMCPACK layout)."""
    arr = np.ascontiguousarray(arr.astype(np.complex128))
    return arr.view(np.float64).reshape(arr.shape + (2,))


def write_qmcpack_cholesky_kpoint(
    filename: str,
    hcore: list,
    chol: list,
    enuc: float,
    nelec: tuple,
    nmo_pk: np.ndarray,
    qk_k2: np.ndarray,
    minus_k: np.ndarray,
    nchol_pk: np.ndarray,
):
    """Write the KPFactorized layout (inverse of the reader; used for
    round-trip tests and converters). Factors for Q with
    minus_k[Q] < Q are omitted, as in files produced by pyscf converters.
    """
    from pauxy_tpu_torch.utils import h5lite

    nkp = len(nmo_pk)
    nmo_tot = int(np.sum(nmo_pk))
    with h5lite.open_file(filename, "w") as fh5:
        fh5["Hamiltonian/Energies"] = np.array([enuc, 0.0])
        fh5["Hamiltonian/dims"] = np.array(
            [0, 0, nkp, nmo_tot, nelec[0], nelec[1], 0, int(np.max(nchol_pk))]
        )
        fh5["Hamiltonian/NMOPerKP"] = np.asarray(nmo_pk, dtype=np.int32)
        fh5["Hamiltonian/NCholPerKP"] = np.asarray(nchol_pk, dtype=np.int32)
        fh5["Hamiltonian/QKTok2"] = np.asarray(qk_k2, dtype=np.int32)
        fh5["Hamiltonian/MinusK"] = np.asarray(minus_k, dtype=np.int32)
        for ik, hk in enumerate(hcore):
            fh5[f"Hamiltonian/H1_kp{ik}"] = _to_qmcpack_complex(hk)
        for iq, lq in enumerate(chol):
            if minus_k[iq] < iq:
                continue  # stored implicitly as conj of the partner
            # Layout: [nkp, nmo(ki)*nmo(kk)*nchol] flattened row-major per k
            # (the reader's view(complex)[:, :, 0] then recovers [nkp, L]).
            stacked = np.stack([np.asarray(lk).reshape(-1) for lk in lq])
            fh5[f"Hamiltonian/KPFactorized/L{iq}"] = _to_qmcpack_complex(
                stacked
            )


def get_kpoint_chol(filename: str, nchol_pk, minus_k, i: int):
    """Per-Q factor, materializing -Q as the conjugate of its partner
    (``hamiltonian_converter.py:409-419``)."""
    from pauxy_tpu_torch.utils import h5lite

    with h5lite.open_file(filename, "r") as fh5:
        try:
            lk = fh5[f"Hamiltonian/KPFactorized/L{i}"][:]
            lk = lk.view(np.complex128)[:, :, 0]
        except KeyError:
            lk = fh5[f"Hamiltonian/KPFactorized/L{minus_k[i]}"][:]
            lk = lk.view(np.complex128).conj()[:, :, 0]
    return lk


def read_qmcpack_cholesky_kpoint(filename: str, get_chol: bool = True):
    """Read the k-point factorized Hamiltonian
    (``hamiltonian_converter.py:356-407``; same return signature)."""
    from pauxy_tpu_torch.utils import h5lite

    with h5lite.open_file(filename, "r") as fh5:
        enuc = fh5["Hamiltonian/Energies"][:][0]
        dims = fh5["Hamiltonian/dims"][:]
        nmo_tot = dims[3]
        nkp = dims[2]
        nmo_pk = fh5["Hamiltonian/NMOPerKP"][:]
        nchol_pk = fh5["Hamiltonian/NCholPerKP"][:]
        qk_k2 = fh5["Hamiltonian/QKTok2"][:]
        minus_k = fh5["Hamiltonian/MinusK"][:]
        nalpha = dims[4]
        nbeta = dims[5]
        hcore = []
        for i in range(nkp):
            hk = fh5[f"Hamiltonian/H1_kp{i}"][:]
            nmo = nmo_pk[i]
            hcore.append(hk.view(np.complex128).reshape(nmo, nmo))
    if get_chol:
        chol = [
            get_kpoint_chol(filename, nchol_pk, minus_k, i)
            for i in range(nkp)
        ]
    else:
        chol = None
    return (hcore, chol, enuc, int(nmo_tot), (int(nalpha), int(nbeta)),
            nmo_pk, qk_k2, nchol_pk, minus_k)


def kpoint_to_supercell(hcore, chol, nmo_pk, qk_k2, nchol_pk):
    """Assemble the dense supercell one-body matrix [M, M] and Cholesky
    tensor [M, M, X_tot] from the k-point factors.

    Each (Q, n) contributes one supercell vector
    A^{Qn}[offset(k_i)+i, offset(k_k)+k] = L^Q[k_i][(i,k), n] so that
    (IK|JL) = sum_{Qn} A[I,K] conj(A[L,J]) reproduces the k-point ERIs
    (cf. the FCIDUMP assembly at ``hamiltonian_converter.py:500-530``).
    """
    nkp = len(nmo_pk)
    offsets = np.zeros(nkp, dtype=int)
    for i in range(1, nkp):
        offsets[i] = offsets[i - 1] + nmo_pk[i - 1]
    m = int(np.sum(nmo_pk))
    h1 = np.zeros((m, m), dtype=np.complex128)
    for ik, hk in enumerate(hcore):
        o = offsets[ik]
        h1[o : o + nmo_pk[ik], o : o + nmo_pk[ik]] = hk
    xtot = int(np.sum(nchol_pk))
    a = np.zeros((m, m, xtot), dtype=np.complex128)
    x0 = 0
    for iq in range(nkp):
        lq = chol[iq]
        nchol = nchol_pk[iq]
        for ki in range(nkp):
            kk = qk_k2[iq, ki]
            ni, nk = nmo_pk[ki], nmo_pk[kk]
            block = np.asarray(lq[ki]).reshape(-1)[: ni * nk * nchol]
            a[offsets[ki] : offsets[ki] + ni,
              offsets[kk] : offsets[kk] + nk, x0 : x0 + nchol] = (
                block.reshape(ni, nk, nchol)
            )
        x0 += nchol
    return h1, a


def kpoint_eri(chol, nmo_pk, qk_k2, nchol_pk):
    """Dense supercell ERI tensor (IK|JL) from the k-point factors —
    validation helper mirroring the FCIDUMP loop
    (``hamiltonian_converter.py:500-530``)."""
    nkp = len(nmo_pk)
    offsets = np.zeros(nkp, dtype=int)
    for i in range(1, nkp):
        offsets[i] = offsets[i - 1] + nmo_pk[i - 1]
    m = int(np.sum(nmo_pk))
    eri = np.zeros((m, m, m, m), dtype=np.complex128)
    for iq in range(nkp):
        lq = chol[iq]
        nchol = nchol_pk[iq]
        for ki in range(nkp):
            kk = qk_k2[iq, ki]
            ni, nk = nmo_pk[ki], nmo_pk[kk]
            li = np.asarray(lq[ki]).reshape(-1)[: ni * nk * nchol].reshape(
                ni, nk, nchol
            )
            for kl in range(nkp):
                kj = qk_k2[iq, kl]
                nl, nj = nmo_pk[kl], nmo_pk[kj]
                ll = np.asarray(lq[kl]).reshape(-1)[
                    : nl * nj * nchol
                ].reshape(nl, nj, nchol)
                block = np.einsum("ikn,ljn->ikjl", li, ll.conj(),
                                  optimize=True)
                eri[
                    offsets[ki] : offsets[ki] + ni,
                    offsets[kk] : offsets[kk] + nk,
                    offsets[kj] : offsets[kj] + nj,
                    offsets[kl] : offsets[kl] + nl,
                ] += block
    return eri
