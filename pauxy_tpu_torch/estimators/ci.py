"""Small full-CI for validation.

Counterpart of ``pauxy_tpu/estimators/ci.py`` (dense ERIs, the FCI
Hamiltonian by Slater-Condon rules, ``simple_fci``, ``one_rdm_from_fci``
and the Bose-Fermi FCI), copied: host-side numpy, a test oracle for tiny
systems and the PHMSD trial's CI coefficients, not a compute path. The
system's tensors are read to the host first (they may sit on the card).

Conventions: spatial integrals h1e[p, q] and chemist-notation ERIs
eri[p, q, r, s] = (pq|rs); spin orbitals ordered (spatial, spin) with
alpha=0, beta=1.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A system tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dense_eri(ham) -> np.ndarray:
    """(pq|rs) for any supported Hamiltonian (reference hijkl methods:
    hubbard.py:158-163, generic.py:168-172, ueg.py:443-470)."""
    m = ham.nbasis
    name = ham.name
    if name in ("Hubbard", "HubbardHolstein"):
        eri = np.zeros((m, m, m, m))
        for i in range(m):
            eri[i, i, i, i] = ham.U
        return eri
    if name == "Generic":
        chol = _host(ham.chol)
        return np.einsum("pqx,rsx->pqrs", chol, chol, optimize=True)
    if name == "UEG":
        basis = np.asarray(ham.basis)
        kfac = ham.kfac
        eri = np.zeros((m, m, m, m))
        for p in range(m):
            for q in range(m):
                qvec = basis[p] - basis[q]
                q2 = kfac ** 2 * float(qvec @ qvec)
                if q2 < 1e-12:
                    continue
                v = 4 * np.pi / q2 / ham.vol
                for r in range(m):
                    diff = basis[r] + qvec
                    match = np.nonzero((basis == diff).all(axis=1))[0]
                    if len(match):
                        eri[p, q, r, int(match[0])] = v
        return eri
    raise NotImplementedError(name)


def one_body(ham) -> np.ndarray:
    return _host(ham.H1[0] if hasattr(ham, "H1") else ham.T[0])


def _dets(m: int, n: int):
    return list(itertools.combinations(range(m), n))


def _excitation(da: tuple, db: tuple):
    """Orbitals removed/added going da -> db, plus the permutation sign."""
    sa, sb = set(da), set(db)
    rem = sorted(sa - sb)
    add = sorted(sb - sa)
    # Sign from aligning the common orbitals.
    perm = 0
    for o in rem:
        perm += da.index(o)
    for o in add:
        perm += db.index(o)
    return rem, add, (-1) ** perm


def fci_hamiltonian(ham, nup=None, ndown=None, basis=None):
    """Dense Hamiltonian matrix in a product-determinant basis.

    ``basis``: optional list of (occ_a, occ_b) tuples to restrict to a
    determinant subspace (Slater-Condon matrix elements, the orthogonal
    branch of ``multi_slater.py:199-205`` recompute_ci_coeffs); default is
    the full FCI space.
    """
    m = ham.nbasis
    nup = ham.nup if nup is None else nup
    ndown = ham.ndown if ndown is None else ndown
    h = one_body(ham)
    eri = dense_eri(ham)
    ecore = float(getattr(ham, "ecore", 0.0))
    if ham.name == "UEG":
        ecore = 0.0  # reference FCI checks exclude the Madelung shift

    if basis is None:
        dets_a = _dets(m, nup)
        dets_b = _dets(m, ndown)
        basis = [(a, b) for a in dets_a for b in dets_b]
    else:
        basis = [(tuple(a), tuple(b)) for a, b in basis]
    nd = len(basis)

    def coulomb(oa, ob):
        """Diagonal element for occupations oa, ob."""
        e = sum(h[p, p] for p in oa) + sum(h[p, p] for p in ob)
        # same spin: 1/2 (J - K); opposite spin: J.
        for occ in (oa, ob):
            for p, q in itertools.combinations(occ, 2):
                e += eri[p, p, q, q] - eri[p, q, q, p]
        for p in oa:
            for q in ob:
                e += eri[p, p, q, q]
        return e

    def single(occ_same, occ_other, p, q):
        """<D|H|D_p^q> for a single excitation within one spin channel."""
        e = h[p, q]
        for r in occ_same:
            if r != p:
                e += eri[p, q, r, r] - eri[p, r, r, q]
        for r in occ_other:
            e += eri[p, q, r, r]
        return e

    hmat = np.zeros((nd, nd), dtype=h.dtype)
    for i, (a1, b1) in enumerate(basis):
        for j in range(i, nd):
            a2, b2 = basis[j]
            ra, aa, sgn_a = _excitation(a1, a2)
            rb, ab, sgn_b = _excitation(b1, b2)
            na_ex, nb_ex = len(ra), len(rb)
            if na_ex + nb_ex > 2:
                continue
            if na_ex + nb_ex == 0:
                val = coulomb(a1, b1) + ecore
            elif na_ex == 1 and nb_ex == 0:
                val = sgn_a * single(a1, b1, ra[0], aa[0])
            elif nb_ex == 1 and na_ex == 0:
                val = sgn_b * single(b1, a1, rb[0], ab[0])
            elif na_ex == 2:
                p, q = ra
                r, s = aa
                val = sgn_a * (eri[p, r, q, s] - eri[p, s, q, r])
            elif nb_ex == 2:
                p, q = rb
                r, s = ab
                val = sgn_b * (eri[p, r, q, s] - eri[p, s, q, r])
            else:  # one alpha + one beta
                val = sgn_a * sgn_b * eri[ra[0], aa[0], rb[0], ab[0]]
            hmat[i, j] = val
            hmat[j, i] = np.conj(val)
    return hmat, basis


def simple_fci(ham, nup=None, ndown=None, nroots: int = 1):
    """Lowest FCI eigenvalues (and vectors) — ``ci.py:159-182``."""
    hmat, basis = fci_hamiltonian(ham, nup, ndown)
    evals, evecs = np.linalg.eigh(hmat)
    return evals[:nroots], evecs[:, :nroots], basis


def one_rdm_from_fci(vec: np.ndarray, basis, m: int) -> np.ndarray:
    """Spin-resolved 1-RDM [2, M, M] of an FCI vector, P_s[p, q] =
    <c_p^dag c_q> — the exact oracle for RDM estimators (the reference has
    no FCI RDM; signs follow the same alignment convention as
    :func:`fci_hamiltonian`'s single-excitation elements)."""
    p_out = np.zeros((2, m, m), dtype=np.complex128)
    vec = np.asarray(vec)
    for i, (a1, b1) in enumerate(basis):
        ci_ = np.conj(vec[i])
        if ci_ == 0:
            continue
        for p in a1:
            p_out[0, p, p] += ci_ * vec[i]
        for p in b1:
            p_out[1, p, p] += ci_ * vec[i]
        for j, (a2, b2) in enumerate(basis):
            if j == i or vec[j] == 0:
                continue
            ra, aa, sgn_a = _excitation(a1, a2)
            rb, ab, sgn_b = _excitation(b1, b2)
            if len(ra) == 1 and len(rb) == 0:
                p_out[0, ra[0], aa[0]] += sgn_a * ci_ * vec[j]
            elif len(rb) == 1 and len(ra) == 0:
                p_out[1, rb[0], ab[0]] += sgn_b * ci_ * vec[j]
    return p_out


# ----------------------------------------------------------------------------
# Bose-fermi FCI (Hubbard-Holstein oracle)
# ----------------------------------------------------------------------------

def _boson_basis(m: int, nboson_max: int):
    """All site-occupation tuples with total boson number <= nboson_max,
    ordered by total (the reference's 'perms', ``ci.py:13-22``)."""
    basis = []
    for ntot in range(nboson_max + 1):
        # Compositions of ntot into m nonnegative parts, lexicographic.
        def comps(total, parts):
            if parts == 1:
                yield (total,)
                return
            for first in range(total + 1):
                for rest in comps(total - first, parts - 1):
                    yield (first,) + rest

        basis.extend(comps(ntot, m))
    return basis


def simple_fci_bose_fermi(ham, nboson_max: int = 1, nroots: int = 1):
    """Exact diagonalization of the Hubbard-Holstein model in the product
    space (electron determinants) x (truncated boson Fock space).

    Counterpart of ``pauxy/estimators/ci.py:8-156``:
      H = H_el (x) 1  +  1 (x) w0 sum_i b_i^dag b_i
          + g sum_i n_i (x) (b_i + b_i^dag).
    No boson zero-point term, matching the reference (its pinned values:
    ``pauxy/estimators/tests/test_ci.py:19-52``); add M*w0/2 to compare with
    the continuous-coordinate convention of the AFQMC estimators.
    Returns (evals[:nroots], evecs, (det_basis, boson_basis)).
    """
    import scipy.sparse
    import scipy.sparse.linalg

    m = ham.nbasis
    hel, det_basis = fci_hamiltonian(ham)
    nd = hel.shape[0]
    bbasis = _boson_basis(m, nboson_max)
    nb = len(bbasis)
    index = {b: i for i, b in enumerate(bbasis)}

    hel = scipy.sparse.csr_matrix(hel)
    hb = scipy.sparse.diags(
        [ham.w0 * sum(b) for b in bbasis], format="csr"
    )
    ib = scipy.sparse.eye(nb, format="csr")
    iel = scipy.sparse.eye(nd, format="csr")

    htot = scipy.sparse.kron(ib, hel) + scipy.sparse.kron(hb, iel)
    g = float(ham.g)
    for isite in range(m):
        # x_i = b_i + b_i^dag on the truncated basis.
        rows, cols, vals = [], [], []
        for j, b in enumerate(bbasis):
            if b[isite] > 0:
                tgt = list(b)
                tgt[isite] -= 1
                rows.append(index[tuple(tgt)])
                cols.append(j)
                vals.append(np.sqrt(b[isite]))
        bi = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(nb, nb))
        xi = bi + bi.T
        # Electron density at site i (both spins), diagonal over dets.
        rho = np.zeros(nd)
        for idx, (oa, ob) in enumerate(det_basis):
            rho[idx] = (isite in oa) + (isite in ob)
        rhoi = scipy.sparse.diags(rho, format="csr")
        htot = htot + g * scipy.sparse.kron(xi, rhoi)

    k = min(max(nroots, 2), htot.shape[0] - 2)
    evals, evecs = scipy.sparse.linalg.eigsh(htot, k=k, which="SA")
    order = np.argsort(evals)
    return evals[order][:nroots], evecs[:, order][:, :nroots], (
        det_basis, bbasis
    )
