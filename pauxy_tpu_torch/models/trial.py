"""Single-determinant (UHF-style) trial wavefunctions.

Counterpart of the single-determinant part of ``pauxy_tpu/models/trial.py``
for the Hubbard and Generic models. Trials are built host-side (numpy;
setup, not the hot path) and hold their orbitals, and for Generic systems
the half-rotated tensors, as module buffers.

The trial's Green's function is G_s = conj(psi) (psi^T conj(psi))^{-1} psi^T.
``spin_project_init`` moves only the walkers' initial determinant.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import local_energy as le


# Generic precomputes, None for lattice models: the half-rotated Cholesky
# tensors rchol_s [X, n_s, M], the half-rotated one-body rh1_s [n_s, M] and
# the exchange supermatrices [n_s M, n_s M] (absent past the size cap).
GENERIC_BUFFERS = ("rchola", "rcholb", "rh1a", "rh1b", "exx_supera",
                   "exx_superb")

# Elements cap of one exchange supermatrix: (n M)^2 <= 2^26, as in
# pauxy_tpu/models/trial.py:159. Past it the energy takes the exchange
# kernel (real rchol) or the chunked einsum.
EXX_SUPER_MAX_ELEMS = 2 ** 26


class SingleDetTrial(nn.Module):
    """|psi_T> = |psi_a> x |psi_b>; ``inita``/``initb`` seed the walkers.

    ``G_host`` is the trial density matrix [2, M, M] as a numpy array
    (setup-only: the propagator's mean-field shift reads it).
    """

    def __init__(self, psia, psib, *, G_host: np.ndarray, etrial: float,
                 name: str = "single_det", **generic):
        super().__init__()
        unknown = set(generic) - set(GENERIC_BUFFERS)
        if unknown:
            raise TypeError(f"unknown trial tensors {sorted(unknown)}")
        self.register_buffer("psia", psia)
        self.register_buffer("psib", psib)
        self.register_buffer("inita", psia.clone())
        self.register_buffer("initb", psib.clone())
        for key in GENERIC_BUFFERS:
            self.register_buffer(key, generic.get(key))
        self.G_host = G_host
        self.etrial = float(etrial)
        self.name = name


def trial_density_matrix(psia: np.ndarray, psib: np.ndarray) -> np.ndarray:
    """G[2, M, M] with G_s = conj(psi_s) (psi_s^T conj(psi_s))^{-1} psi_s^T."""
    out = []
    for psi in (psia, psib):
        if psi.shape[1] == 0:
            out.append(np.zeros((psi.shape[0], psi.shape[0]), dtype=psi.dtype))
            continue
        ovlp = psi.T @ psi.conj()
        out.append(psi.conj() @ np.linalg.solve(ovlp.T, psi.T))
    return np.stack(out)


def _exx_supermatrix(rc: np.ndarray) -> np.ndarray | None:
    """C[(j m), (i m')] = sum_x rchol[x, i, m] rchol[x, j, m'], so that
    exx_w = vec(Ghalf_w)^T C vec(Ghalf_w); None past the size cap."""
    x, n, m = rc.shape
    if (n * m) ** 2 > EXX_SUPER_MAX_ELEMS or n == 0:
        return None
    rcf = rc.reshape(x, n * m).astype(
        np.complex128 if np.iscomplexobj(rc) else np.float64)
    gram = rcf.T @ rcf                                    # [(i m), (j m')]
    c4 = gram.reshape(n, m, n, m).transpose(2, 1, 0, 3)
    return np.ascontiguousarray(c4.reshape(n * m, n * m))


def _half_rotate(psi: np.ndarray, chol: np.ndarray) -> np.ndarray:
    """rchol[x, a, m] = sum_p conj(psi[p, a]) L[p, m, x], as one
    [n, M] x [M, M X] product (two real ones for real L)."""
    m, _, nx = chol.shape
    flat = chol.reshape(m, -1)
    left = psi.conj().T
    if np.iscomplexobj(chol):
        out = left @ flat
    else:
        out = (left.real @ flat) + 1j * (left.imag @ flat)
    return out.reshape(-1, m, nx).transpose(2, 0, 1)


def _generic_precomputes(ham, psia, psib, prec) -> dict:
    """The half-rotated tensors of pauxy_tpu/models/trial.py:108-140, each
    stored real when it is genuinely real (molecular data)."""
    chol = ham.chol.cpu().numpy()
    h1 = ham.H1.cpu().numpy()

    def natural(arr):
        if np.iscomplexobj(arr) and np.abs(arr.imag).max(initial=0.0) == 0:
            arr = arr.real
        return arr.astype(prec.np_cplx if np.iscomplexobj(arr)
                          else prec.np_real)

    rca = natural(_half_rotate(psia, chol).astype(prec.np_cplx))
    rcb = natural(_half_rotate(psib, chol).astype(prec.np_cplx))
    host = {"rchola": rca, "rcholb": rcb,
            "rh1a": natural(psia.conj().T @ h1[0]),
            "rh1b": natural(psib.conj().T @ h1[1])}
    for key, rc in (("exx_supera", rca), ("exx_superb", rcb)):
        sup = _exx_supermatrix(rc)
        if sup is not None:
            host[key] = natural(sup)
    return host


def _finalize(ham, psia, psib, prec, name: str, device) -> SingleDetTrial:
    psia = np.asarray(psia, dtype=prec.np_cplx)
    psib = np.asarray(psib, dtype=prec.np_cplx)
    g = trial_density_matrix(psia, psib)
    etrial = float(np.real(le.local_energy_G_host(ham, g)[0]))
    generic = {}
    if ham.name == "Generic":
        generic = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in _generic_precomputes(ham, psia, psib,
                                                    prec).items()}
    return SingleDetTrial(
        torch.from_numpy(np.ascontiguousarray(psia)).to(device),
        torch.from_numpy(np.ascontiguousarray(psib)).to(device),
        G_host=g.astype(prec.np_cplx), etrial=etrial, name=name, **generic,
    )


def trial_from_orbitals(ham, psi: np.ndarray, name: str = "file", *,
                        device=None, dtype=None) -> SingleDetTrial:
    """Trial from explicit orbitals psi [M, nup + ndown] (UHF layout)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    return _finalize(ham, psi[:, : ham.nup], psi[:, ham.nup:], prec, name,
                     device)


def free_electron_trial(ham, *, device=None, dtype=None) -> SingleDetTrial:
    """Occupy the lowest eigenvectors of the one-body Hamiltonian (the
    hopping matrix T, or H1 for a Generic system)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    h1 = (ham.H1 if ham.name == "Generic" else ham.T).cpu().numpy()
    _, va = np.linalg.eigh(h1[0])
    _, vb = np.linalg.eigh(h1[1])
    return _finalize(ham, va[:, : ham.nup], vb[:, : ham.ndown], prec,
                     "free_electron", device)


def rhf_identity_trial(ham, *, device=None, dtype=None) -> SingleDetTrial:
    """Identity (MO-basis RHF) trial: occupy the first nup / ndown
    orbitals."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    eye = np.eye(ham.nbasis)
    return _finalize(ham, eye[:, : ham.nup], eye[:, : ham.ndown], prec,
                     "hartree_fock", device)


def checkerboard_guess(nbasis: int, nup: int, ndown: int, nx: int, ny: int
                       ) -> np.ndarray:
    """Antiferromagnetic checkerboard determinant [M, nup + ndown]."""
    wfn = np.zeros((nbasis, nup + ndown), dtype=np.complex128)
    na = nb = 0
    for i in range(nbasis):
        x, y = i % nx, i // nx
        if (x + y) % 2 == 0 and na < nup:
            wfn[i, na] = 1.0
            na += 1
        elif nb < ndown:
            wfn[i, nup + nb] = -1.0
            nb += 1
    return wfn


def _eigh_lowest(h: np.ndarray, n: int) -> np.ndarray:
    """Eigenvectors of the lowest n eigenvalues of a hermitian matrix."""
    return np.linalg.eigh(h)[1][:, :n]


def uhf_trial(ham, ueff: float = 0.4, ninitial: int = 10, nconv: int = 5000,
              alpha: float = 0.5, deps: float = 1e-8, seed: int | None = None,
              initial: str = "random", *, device=None, dtype=None
              ) -> SingleDetTrial:
    """Self-consistent UHF trial for the Hubbard model, host-side.

    Mean-field decoupling H^s = T + U_eff diag(<n_{-s}>), solved with density
    mixing from ``ninitial`` random starts (numpy's ``default_rng(seed)``)
    or from the checkerboard; the JAX package's ``uhf_trial`` step by step,
    so the same seed gives the same orbitals.
    """
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    t = ham.T.cpu().numpy()
    m, nup, ndown = ham.nbasis, ham.nup, ham.ndown
    if initial == "checkerboard":
        wfn = checkerboard_guess(m, nup, ndown, ham.nx, ham.ny)
        return _finalize(ham, wfn[:, :nup], wfn[:, nup:], prec, "uhf",
                         device)
    rng = np.random.default_rng(seed)
    depsn = deps ** 0.5

    def density(v):
        return np.einsum("mi,mi->m", v, v.conj()).real

    def energy(va, vb):
        g = trial_density_matrix(va.astype(np.complex128),
                                 vb.astype(np.complex128))
        ke = np.sum(t[0] * g[0] + t[1] * g[1])
        pe = ham.U * np.dot(np.diagonal(g[0]), np.diagonal(g[1]))
        return (ke + pe).real

    best_e, best = np.inf, None
    for _ in range(ninitial):
        ra = rng.random((m, m))
        rb = rng.random((m, m))
        va = _eigh_lowest(0.5 * (ra + ra.T), nup)
        vb = _eigh_lowest(0.5 * (rb + rb.T), ndown)
        niup, nidown = density(va), density(vb)
        niup_old, nidown_old = niup.copy(), nidown.copy()
        eold = np.inf
        for _it in range(nconv):
            va = _eigh_lowest(t[0] + np.diag(ueff * nidown), nup)
            vb = _eigh_lowest(t[1] + np.diag(ueff * niup), ndown)
            niup, nidown = density(va), density(vb)
            enew = energy(va, vb)
            if (abs(enew - eold) < deps
                    and np.abs(niup - niup_old).sum() / m < depsn
                    and np.abs(nidown - nidown_old).sum() / m < depsn):
                break
            niup_mixed = (1 - alpha) * niup + alpha * niup_old
            nidown_mixed = (1 - alpha) * nidown + alpha * nidown_old
            niup_old, nidown_old = niup, nidown
            niup, nidown = niup_mixed, nidown_mixed
            eold = enew
        if enew < best_e - deps:
            best_e, best = enew, (va, vb)
    va, vb = best
    return _finalize(ham, va, vb, prec, "uhf", device)


def spin_project_init(ham, trial: SingleDetTrial,
                      init_walker: str | None = None):
    """A copy of ``trial`` whose walkers start from spin-symmetric
    orbitals: the natural orbitals of the spin-summed trial 1-RDM, or with
    ``init_walker='free_electron'`` the one-body Hamiltonian's eigenvectors
    (H1, or the hopping matrix T of a lattice model). Only ``inita`` /
    ``initb`` change. Returns (trial, natural-orbital occupations in
    descending order, or None for the free-electron variant)."""
    na, nb = ham.nup, ham.ndown
    noons = None
    if init_walker == "free_electron":
        h1 = getattr(ham, "H1", None)
        if h1 is None:
            h1 = ham.T
        _, eigv = np.linalg.eigh(h1.cpu().numpy()[0])
    else:
        psia = trial.psia.cpu().numpy()
        psib = trial.psib.cpu().numpy()

        def proj(p):
            return p @ np.linalg.inv(p.conj().T @ p) @ p.conj().T

        eigs, eigv = np.linalg.eigh(proj(psia) + proj(psib))
        ix = np.argsort(eigs)[::-1]
        noons = eigs[ix].real
        eigv = eigv[:, ix]
    new = copy.deepcopy(trial)
    cdtype, dev = trial.inita.dtype, trial.inita.device
    new.inita = torch.from_numpy(np.ascontiguousarray(eigv[:, :na])).to(
        dev, cdtype)
    new.initb = torch.from_numpy(np.ascontiguousarray(eigv[:, :nb])).to(
        dev, cdtype)
    return new, noons
