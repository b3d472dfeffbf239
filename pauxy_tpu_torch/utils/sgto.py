"""s-type contracted-Gaussian molecular integrals + SCF, pure numpy.

The port's copy of ``pauxy_tpu/utils/sgto.py``: ``molecule_afqmc`` and
``hydrogen_chain_afqmc`` return the port's ``Generic`` on ``device`` at
precision ``dtype``.

The reference generates molecular integrals through pyscf
(``pauxy/utils/from_pyscf.py:154`` ``generate_integrals``); without pyscf
its headline molecular example — the H10 chain of
``examples/generic/01-simple`` with the published anchor
E = -5.38331344 +/- 0.0014 Ha — cannot be set up. For hydrogen-like
systems every basis function is an s-type contracted Gaussian and all four
integral classes have closed forms in the Boys function F0, so this module
provides the whole chkfile-equivalent pipeline host-side:

    atoms -> S/T/V/ERI -> RHF/UHF (DIIS) -> MO-basis Hamiltonian
          -> pivoted-Cholesky factors -> ``models.generic.make_generic``
          + ``models.trial.trial_from_orbitals``.

Scope: s functions only (H, He; charged centers are arbitrary). Heavier
elements need p/d shells — out of scope; use a pyscf-generated h5 through
``from_qmcpack_file`` for those.

Everything here is setup-time host code (numpy, float64); the arrays feed
the drivers unchanged.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "STO6G_H",
    "STO6G_HE",
    "ATOM_BASES",
    "molecule",
    "SBasis",
    "hydrogen_chain",
    "rhf",
    "uhf",
    "build_integrals",
    "ortho_ao_hamiltonian",
    "hydrogen_chain_afqmc",
    "molecule_afqmc",
    "dump_afqmc",
]

# STO-6G 1s: the Hehre-Stewart-Pople zeta=1.0 least-squares fit of a
# Slater 1s; element bases are the same six primitives scaled by zeta^2
# (zeta_H = 1.24, zeta_He = 1.69 — the stored basis-set-exchange/pyscf
# convention; the H values below match the published table).
_STO6G_1S_EXP = np.array([23.10303149, 4.235915534, 1.185056519,
                          0.4070988982, 0.1580884151, 0.06510953954])
_STO6G_1S_COEF = np.array([0.00916359628, 0.04936149294, 0.16853830490,
                           0.37056279970, 0.41649152980, 0.13033408410])

STO6G_H = (_STO6G_1S_EXP * 1.24 ** 2, _STO6G_1S_COEF)
STO6G_HE = (_STO6G_1S_EXP * 1.69 ** 2, _STO6G_1S_COEF)

#: element -> (charge, (exponents, coefficients))
ATOM_BASES = {"H": (1.0, STO6G_H), "He": (2.0, STO6G_HE)}


def molecule(atoms):
    """Build (SBasis, charges, coords, enuc) from ``[(symbol, (x, y, z)),
    ...]`` with s-only STO-6G bases (H, He). Coordinates in Bohr."""
    coords, charges, exps, coefs = [], [], [], []
    for sym, xyz in atoms:
        z, (e, c) = ATOM_BASES[sym]
        coords.append(np.asarray(xyz, dtype=np.float64))
        charges.append(z)
        exps.append(e)
        coefs.append(c)
    coords = np.asarray(coords)
    charges = np.asarray(charges)
    bas = SBasis(coords, exps, coefs)
    enuc = 0.0
    for i in range(len(atoms)):
        for j in range(i):
            enuc += charges[i] * charges[j] / np.linalg.norm(
                coords[i] - coords[j])
    return bas, charges, coords, enuc


def _boys0(t: np.ndarray) -> np.ndarray:
    """F0(t) = (1/2) sqrt(pi/t) erf(sqrt(t)), series near 0."""
    from scipy.special import erf

    t = np.asarray(t, dtype=np.float64)
    small = t < 1e-12
    ts = np.where(small, 1.0, t)
    f = 0.5 * np.sqrt(np.pi / ts) * erf(np.sqrt(ts))
    return np.where(small, 1.0 - t / 3.0, f)


class SBasis:
    """Contracted s-function basis: one contracted GTO per (center, shell).

    ``centers``: [nbf, 3]; ``exps``/``coefs``: lists of per-function
    primitive arrays. Coefficients are stored primitive-normalized and the
    contraction is renormalized to <phi|phi> = 1.
    """

    def __init__(self, centers, exps, coefs):
        self.centers = np.asarray(centers, dtype=np.float64)
        self.exps = [np.asarray(e, dtype=np.float64) for e in exps]
        nrm = [(2.0 * e / np.pi) ** 0.75 for e in self.exps]
        self.coefs = [np.asarray(c, dtype=np.float64) * n
                      for c, n in zip(coefs, nrm)]
        self.nbf = len(self.exps)
        # Normalize each contraction.
        for i in range(self.nbf):
            a = self.exps[i][:, None] + self.exps[i][None, :]
            s = (np.pi / a) ** 1.5
            w = self.coefs[i][:, None] * self.coefs[i][None, :]
            self.coefs[i] = self.coefs[i] / np.sqrt((w * s).sum())

    # -- pair tables -------------------------------------------------------
    def _pairs(self, i, j):
        """Primitive-pair quantities for functions i, j: total exponent p,
        combined coefficient cc (incl. the Gaussian product prefactor),
        and product center P — each flattened [ni * nj]."""
        ai = self.exps[i][:, None]
        aj = self.exps[j][None, :]
        p = (ai + aj).ravel()
        ab2 = np.dot(self.centers[i] - self.centers[j],
                     self.centers[i] - self.centers[j])
        pref = np.exp(-(ai * aj).ravel() / p * ab2)
        cc = (self.coefs[i][:, None] * self.coefs[j][None, :]).ravel() * pref
        P = (ai[..., None] * self.centers[i] + aj[..., None] * self.centers[j])
        P = (P.reshape(-1, 3)) / p[:, None]
        return p, cc, P

    def overlap(self) -> np.ndarray:
        S = np.empty((self.nbf, self.nbf))
        for i in range(self.nbf):
            for j in range(i + 1):
                p, cc, _ = self._pairs(i, j)
                S[i, j] = S[j, i] = (cc * (np.pi / p) ** 1.5).sum()
        return S

    def kinetic(self) -> np.ndarray:
        T = np.empty((self.nbf, self.nbf))
        for i in range(self.nbf):
            for j in range(i + 1):
                ai = self.exps[i][:, None]
                aj = self.exps[j][None, :]
                p, cc, _ = self._pairs(i, j)
                mu = (ai * aj).ravel() / p
                ab2 = np.dot(self.centers[i] - self.centers[j],
                             self.centers[i] - self.centers[j])
                t = mu * (3.0 - 2.0 * mu * ab2) * (np.pi / p) ** 1.5
                T[i, j] = T[j, i] = (cc * t).sum()
        return T

    def nuclear(self, charges, coords) -> np.ndarray:
        charges = np.asarray(charges, dtype=np.float64)
        coords = np.asarray(coords, dtype=np.float64)
        V = np.zeros((self.nbf, self.nbf))
        for i in range(self.nbf):
            for j in range(i + 1):
                p, cc, P = self._pairs(i, j)
                acc = 0.0
                for z, c in zip(charges, coords):
                    pc2 = ((P - c[None, :]) ** 2).sum(axis=1)
                    acc += -z * (cc * 2.0 * np.pi / p
                                 * _boys0(p * pc2)).sum()
                V[i, j] = V[j, i] = acc
        return V

    def eri(self) -> np.ndarray:
        """(ij|kl) chemists' notation, [nbf]*4 (fine for <= ~30 functions;
        hydrogen-chain scale)."""
        n = self.nbf
        pair_p, pair_cc, pair_P = {}, {}, {}
        for i in range(n):
            for j in range(i + 1):
                p, cc, P = self._pairs(i, j)
                pair_p[i, j] = p
                pair_cc[i, j] = cc
                pair_P[i, j] = P
        eri = np.zeros((n, n, n, n))
        for i in range(n):
            for j in range(i + 1):
                pij, cij, Pij = pair_p[i, j], pair_cc[i, j], pair_P[i, j]
                for k in range(n):
                    for l in range(k + 1):
                        if (k, l, i, j) < (i, j, k, l):
                            continue
                        pkl, ckl, Pkl = (pair_p[k, l], pair_cc[k, l],
                                         pair_P[k, l])
                        pq2 = ((Pij[:, None, :] - Pkl[None, :, :]) ** 2
                               ).sum(axis=2)
                        pp = pij[:, None]
                        qq = pkl[None, :]
                        val = (cij[:, None] * ckl[None, :]
                               * 2.0 * np.pi ** 2.5
                               / (pp * qq * np.sqrt(pp + qq))
                               * _boys0(pp * qq / (pp + qq) * pq2)).sum()
                        for a, b in ((i, j), (j, i)):
                            for c, d in ((k, l), (l, k)):
                                eri[a, b, c, d] = eri[c, d, a, b] = val
        return eri


def hydrogen_chain(n: int, r: float, basis=STO6G_H):
    """n H atoms on a line with spacing r (Bohr), open boundaries —
    the reference H10 example geometry (``scf.py``: 1.6*i Bohr).

    Returns (SBasis, charges [n], coords [n, 3], enuc)."""
    coords = np.zeros((n, 3))
    coords[:, 0] = r * np.arange(n)
    charges = np.ones(n)
    exps, coefs = basis
    bas = SBasis(coords, [exps] * n, [coefs] * n)
    enuc = 0.0
    for i in range(n):
        for j in range(i):
            enuc += 1.0 / np.linalg.norm(coords[i] - coords[j])
    return bas, charges, coords, enuc


# ---------------------------------------------------------------------------
# SCF (DIIS). Host-side numpy; tiny bases.
# ---------------------------------------------------------------------------


def _diis_extrapolate(fock_list, err_list):
    m = len(fock_list)
    B = -np.ones((m + 1, m + 1))
    B[m, m] = 0.0
    for a in range(m):
        for b in range(m):
            B[a, b] = np.vdot(err_list[a], err_list[b])
    rhs = np.zeros(m + 1)
    rhs[m] = -1.0
    try:
        c = np.linalg.solve(B, rhs)[:m]
    except np.linalg.LinAlgError:
        return fock_list[-1]
    return sum(ci * f for ci, f in zip(c, fock_list))


def _scf_energy(h, focks, dms):
    e = 0.0
    for f, d in zip(focks, dms):
        e += 0.5 * np.einsum("pq,qp->", h + f, d)
    return e


def build_integrals(bas: SBasis, charges, coords):
    """(S, h = T + V, eri) — the one-shot integral build every SCF /
    transform step consumes (the O(nbf^4) ERI loop dominates setup, so
    callers compute this once and pass it around)."""
    S = bas.overlap()
    h = bas.kinetic() + bas.nuclear(charges, coords)
    return S, h, bas.eri()


def _lowdin(S: np.ndarray):
    """X = S^(-1/2) with a linear-dependence guard (reuses the converter's
    get_ortho_ao, ``from_pyscf.py:632-651``)."""
    from pauxy_tpu_torch.utils.from_pyscf import get_ortho_ao

    return get_ortho_ao(S, lindep=1e-12)


def rhf(bas: SBasis, charges, coords, na: int, enuc: float = 0.0,
        max_cycle: int = 200, tol: float = 1e-10, verbose: bool = False,
        ints=None):
    """Closed-shell RHF. Returns (e_tot, C [nbf, nbf], eps).

    ``ints``: optional precomputed ``build_integrals`` tuple."""
    S, h, eri = ints if ints is not None else build_integrals(
        bas, charges, coords)
    X = _lowdin(S)
    C = _solve_fock(h, X)
    fock_l, err_l = [], []
    e_old = 0.0
    for it in range(max_cycle):
        D = 2.0 * C[:, :na] @ C[:, :na].T
        J = np.einsum("pqrs,sr->pq", eri, D, optimize=True)
        K = np.einsum("prqs,sr->pq", eri, D, optimize=True)
        F = h + J - 0.5 * K
        err = X.T @ (F @ D @ S - S @ D @ F) @ X
        fock_l.append(F)
        err_l.append(err)
        if len(fock_l) > 8:
            fock_l.pop(0)
            err_l.pop(0)
        F = _diis_extrapolate(fock_l, err_l)
        C, eps = _solve_fock_eps(F, X)
        e = 0.5 * np.einsum("pq,qp->", h + (h + J - 0.5 * K), D) + enuc
        if verbose:
            print(f"# RHF cycle {it}: E = {e:.10f}")
        if abs(e - e_old) < tol and np.abs(err_l[-1]).max() < 1e-7:
            return e, C, eps
        e_old = e
    raise RuntimeError("RHF did not converge")


def uhf(bas: SBasis, charges, coords, nelec, enuc: float = 0.0,
        max_cycle: int = 500, tol: float = 1e-10, break_sym: float = 0.3,
        verbose: bool = False, ints=None):
    """Spin-unrestricted HF (the reference example uses ``scf.UHF``).

    ``break_sym`` mixes the initial alpha HOMO/LUMO to let the solution
    leave the RHF saddle point on stretched geometries. Returns
    (e_tot, (Ca, Cb), (epsa, epsb)). ``ints``: optional precomputed
    ``build_integrals`` tuple."""
    na, nb = nelec
    S, h, eri = ints if ints is not None else build_integrals(
        bas, charges, coords)
    X = _lowdin(S)
    Ca = _solve_fock(h, X)
    Cb = Ca.copy()
    if break_sym and na < bas.nbf:
        # Counter-rotate alpha/beta HOMO-LUMO pairs (alpha +theta, beta
        # -theta): a one-sided rotation can relax into the IONIC saddle on
        # dissociated geometries instead of the covalent UHF minimum.
        th = break_sym
        homo, lumo = Ca[:, na - 1].copy(), Ca[:, na].copy()
        Ca[:, na - 1] = np.cos(th) * homo + np.sin(th) * lumo
        Ca[:, na] = -np.sin(th) * homo + np.cos(th) * lumo
        if 0 < nb < bas.nbf:
            homo, lumo = Cb[:, nb - 1].copy(), Cb[:, nb].copy()
            Cb[:, nb - 1] = np.cos(th) * homo - np.sin(th) * lumo
            Cb[:, nb] = np.sin(th) * homo + np.cos(th) * lumo
    fock_l, err_l = [], []
    e_old = 0.0
    Fa_old = Fb_old = None
    for it in range(max_cycle):
        Da = Ca[:, :na] @ Ca[:, :na].T
        Db = Cb[:, :nb] @ Cb[:, :nb].T
        Jt = np.einsum("pqrs,sr->pq", eri, Da + Db, optimize=True)
        Ka = np.einsum("prqs,sr->pq", eri, Da, optimize=True)
        Kb = np.einsum("prqs,sr->pq", eri, Db, optimize=True)
        Fa, Fb = h + Jt - Ka, h + Jt - Kb
        e = _scf_energy(h, (Fa, Fb), (Da, Db)) + enuc
        err = np.concatenate([
            (X.T @ (Fa @ Da @ S - S @ Da @ Fa) @ X).ravel(),
            (X.T @ (Fb @ Db @ S - S @ Db @ Fb) @ X).ravel(),
        ])
        fock_l.append((Fa, Fb))
        err_l.append(err)
        if len(fock_l) > 8:
            fock_l.pop(0)
            err_l.pop(0)
        if it < 6 and Fa_old is not None:
            # Damp the first cycles: degenerate stretched geometries
            # charge-slosh under bare Roothaan steps and early DIIS
            # extrapolates garbage from them.
            Fa = 0.5 * Fa + 0.5 * Fa_old
            Fb = 0.5 * Fb + 0.5 * Fb_old
        elif len(fock_l) > 1:
            stacked = _diis_extrapolate(
                [np.stack(fs) for fs in fock_l], err_l)
            Fa, Fb = stacked[0], stacked[1]
        Fa_old, Fb_old = Fa, Fb
        Ca, epsa = _solve_fock_eps(Fa, X)
        Cb, epsb = _solve_fock_eps(Fb, X)
        if verbose:
            print(f"# UHF cycle {it}: E = {e:.10f}")
        if abs(e - e_old) < tol and np.abs(err).max() < 1e-7:
            return e, (Ca, Cb), (epsa, epsb)
        e_old = e
    raise RuntimeError("UHF did not converge")


def _solve_fock(F, X):
    return _solve_fock_eps(F, X)[0]


def _solve_fock_eps(F, X):
    eps, Cp = np.linalg.eigh(X.T @ F @ X)
    return X @ Cp, eps


# ---------------------------------------------------------------------------
# AFQMC input assembly (orthonormal single-particle basis: RHF-MO default)
# ---------------------------------------------------------------------------


def ortho_ao_hamiltonian(bas: SBasis, charges, coords, ints=None):
    """(h1e, eri, X) in the Lowdin ortho-AO basis X = S^(-1/2) — the same
    orthonormal single-particle basis option the reference converter
    exposes (``from_pyscf.py:632`` ``get_ortho_ao``). ``ints``: optional
    precomputed ``build_integrals`` tuple."""
    S, h, eri = ints if ints is not None else build_integrals(
        bas, charges, coords)
    X = _lowdin(S)
    h1e = X.T @ h @ X
    eri = np.einsum("pi,qj,pqrs,rk,sl->ijkl", X, X, eri, X, X,
                    optimize=True)
    return h1e, eri, X


def _afqmc_arrays(bas, charges, coords, enuc, nelec, chol_tol, verbose,
                  basis="mo"):
    """Shared pipeline body: one integral build -> RHF + UHF -> Hamiltonian
    + Cholesky factors + UHF trial orbitals, all in one orthonormal
    single-particle basis. Returns (h1e, chol, psi, e_uhf).

    ``basis='mo'`` (default, the reference converter's default too —
    ``dump_pauxy(ortho_ao=False)``): the RHF molecular orbitals. The basis
    choice changes the Cholesky vectors and hence the HS decomposition —
    measured on H2 at R=1.4, the localized Lowdin basis gives a phaseless
    walk with heavy-tailed local energies (sigma ~15x larger at equal
    samples) while the physics point is unchanged; the delocalized MO
    basis matches the reference run-for-run. ``basis='oao'`` keeps the
    Lowdin choice for comparison.
    """
    from pauxy_tpu_torch.utils.from_pyscf import cholesky_from_eri

    ints = build_integrals(bas, charges, coords)
    S, h, eri = ints
    e_uhf, (Ca, Cb), _ = uhf(bas, charges, coords, nelec, enuc=enuc,
                             verbose=verbose, ints=ints)
    if basis == "mo":
        _, B, _ = rhf(bas, charges, coords, max(nelec), enuc=enuc,
                      ints=ints, verbose=verbose)
    elif basis == "oao":
        B = _lowdin(S)
    else:
        raise ValueError(f"unknown basis {basis!r}")
    h1e = B.T @ h @ B
    eri_b = np.einsum("pi,qj,pqrs,rk,sl->ijkl", B, B, eri, B, B,
                      optimize=True)
    chol = cholesky_from_eri(eri_b, tol=chol_tol)
    # Determinant with AO coefficients C in the orthonormal basis B
    # (B^T S B = I): psi = B^-1 C = B^T S C.
    psi = np.concatenate([B.T @ S @ Ca[:, :nelec[0]],
                          B.T @ S @ Cb[:, :nelec[1]]], axis=1)
    return h1e, chol, psi, e_uhf


def molecule_afqmc(atoms, nelec, chol_tol: float = 1e-8,
                   verbose: bool = False, basis: str = "mo", *,
                   device=None, dtype=None):
    """(ham, trial_psi, e_uhf) for an arbitrary s-basis molecule
    (``molecule()`` geometry format) — the general form of
    :func:`hydrogen_chain_afqmc`."""
    from pauxy_tpu_torch.models.generic import make_generic

    bas, charges, coords, enuc = molecule(atoms)
    h1e, chol, psi, e_uhf = _afqmc_arrays(bas, charges, coords, enuc,
                                          nelec, chol_tol, verbose,
                                          basis=basis)
    return (make_generic(nelec, h1e, chol, ecore=enuc, device=device,
                         dtype=dtype), psi, e_uhf)


def hydrogen_chain_afqmc(n: int, r: float, nelec=None, chol_tol: float = 1e-8,
                         verbose: bool = False, *, device=None, dtype=None):
    """Full pipeline for an n-atom H chain at spacing r (Bohr):
    integrals -> RHF/UHF -> MO-basis Hamiltonian + Cholesky + UHF trial
    orbitals in the MO basis (see ``_afqmc_arrays`` for the basis choice).

    Returns (ham, trial_psi [M, na+nb], e_uhf) ready for
    ``make_generic(nelec, h1e, chol, enuc)`` consumers — see
    ``examples/generic/02-h10-chain``. Counterpart of the reference's
    chkfile -> ``dump_pauxy`` path (``from_pyscf.py:22-154``)."""
    from pauxy_tpu_torch.models.generic import make_generic

    if nelec is None:
        nelec = ((n + 1) // 2, n // 2)
    bas, charges, coords, enuc = hydrogen_chain(n, r)
    h1e, chol, psi, e_uhf = _afqmc_arrays(bas, charges, coords, enuc,
                                          nelec, chol_tol, verbose)
    return (make_generic(nelec, h1e, chol, ecore=enuc, device=device,
                         dtype=dtype), psi, e_uhf)


def dump_afqmc(n: int, r: float, nelec=None, prefix: str = ".",
               chol_tol: float = 1e-8, nwalkers: int = 100,
               dt: float = 0.005, nblocks: int = 1000,
               verbose: bool = False):
    """File-based workflow parity with the reference's converter
    (``tools/pyscf/pyscf_to_pauxy.py`` + ``from_pyscf.dump_pauxy``):
    write ``afqmc.h5`` (QMCPACK dense Hamiltonian), ``wfn.h5`` (UHF trial)
    and a ready ``input.json`` into ``prefix`` for an n-atom H chain, so

        python -m pauxy_tpu_torch <prefix>/input.json

    runs the reference H10 example end-to-end with no pyscf. Returns the
    input.json path."""
    import json
    import os

    from pauxy_tpu_torch.utils import qmcpack, wavefunction

    if nelec is None:
        nelec = ((n + 1) // 2, n // 2)
    bas, charges, coords, enuc = hydrogen_chain(n, r)
    h1e, chol, psi, e_uhf = _afqmc_arrays(bas, charges, coords, enuc,
                                          nelec, chol_tol, verbose)
    os.makedirs(prefix, exist_ok=True)
    ham_file = os.path.join(prefix, "afqmc.h5")
    wfn_file = os.path.join(prefix, "wfn.h5")
    qmcpack.write_hamiltonian(h1e, chol, nelec, ecore=enuc,
                              filename=ham_file)
    wavefunction.write_wavefunction(psi, wfn_file)
    options = {
        "system": {"name": "Generic", "nup": nelec[0], "ndown": nelec[1],
                   "integrals": ham_file},
        "qmc": {"dt": dt, "nsteps": 10, "blocks": nblocks,
                "nwalkers": nwalkers, "pop_control_freq": 5,
                "rng_seed": 8},
        "trial": {"name": "hartree_fock", "filename": wfn_file},
    }
    input_file = os.path.join(prefix, "input.json")
    with open(input_file, "w") as fh:
        json.dump(options, fh, indent=2)
    if verbose:
        print(f"# wrote {ham_file}, {wfn_file}, {input_file} "
              f"(E_UHF = {e_uhf:.8f})")
    return input_file
