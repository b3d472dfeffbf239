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
# the exchange supermatrices [n_s M, n_s M] (absent past the size cap). The
# local-energy variants add the half-rotated ERIs eri_ss' [n_s, M, n_s', M]
# (exact_eri) and the trial's own Ghalf0_s [n_s, M] (pno, and stochastic RI
# with its control variate).
GENERIC_BUFFERS = ("rchola", "rcholb", "rh1a", "rh1b", "exx_supera",
                   "exx_superb", "eri_aa", "eri_bb", "eri_ab", "ghalf0a",
                   "ghalf0b")

# A PNO channel: pair indices idx_i, idx_j [n], coefficients [n] and the
# pairs' truncated SVD factors U [n, M, k], VT [n, k, M], zero-padded to the
# largest kept rank k.
PNO_FIELDS = ("i", "j", "coeff", "u", "vt")
PNO_CHANNELS = ("pno_aa", "pno_bb", "pno_ab")

# Elements cap of one exchange supermatrix: (n M)^2 <= 2^26, as in
# pauxy_tpu/models/trial.py:159. Past it the energy takes the exchange
# kernel (real rchol) or the chunked einsum.
EXX_SUPER_MAX_ELEMS = 2 ** 26


class SingleDetTrial(nn.Module):
    """|psi_T> = |psi_a> x |psi_b>; ``inita``/``initb`` seed the walkers.

    ``G_host`` is the trial density matrix [2, M, M] as a numpy array
    (setup-only: the propagator's mean-field shift reads it). ``shift``
    [M], real, is a Hubbard-Holstein trial's coherent-state phonon
    displacement (None otherwise). A Generic trial for the PNO energy
    carries its channels (``pno_aa``, ``pno_bb``, ``pno_ab``, each a tuple
    of the ``PNO_FIELDS`` tensors, held as buffers ``pno_aa_i``, ...) and,
    for PNO or the control variate, ``e0_terms`` = (ecoul0, exxa0, exxb0),
    the trial's own energy terms (host numbers).
    """

    def __init__(self, psia, psib, *, G_host: np.ndarray, etrial: float,
                 name: str = "single_det", shift=None, e0_terms=None,
                 **generic):
        super().__init__()
        unknown = set(generic) - set(GENERIC_BUFFERS) - set(PNO_CHANNELS)
        if unknown:
            raise TypeError(f"unknown trial tensors {sorted(unknown)}")
        self.register_buffer("psia", psia)
        self.register_buffer("psib", psib)
        self.register_buffer("inita", psia.clone())
        self.register_buffer("initb", psib.clone())
        self.register_buffer("shift", shift)
        for key in GENERIC_BUFFERS:
            self.register_buffer(key, generic.get(key))
        for ch in PNO_CHANNELS:
            parts = generic.get(ch)
            for k, f in enumerate(PNO_FIELDS):
                self.register_buffer(f"{ch}_{f}",
                                     None if parts is None else parts[k])
        self.e0_terms = None if e0_terms is None else tuple(
            complex(x) for x in e0_terms)
        self.G_host = G_host
        self.etrial = float(etrial)
        self.name = name

    def _pno(self, ch: str):
        parts = tuple(getattr(self, f"{ch}_{f}") for f in PNO_FIELDS)
        return None if parts[0] is None else parts

    @property
    def pno_aa(self):
        return self._pno("pno_aa")

    @property
    def pno_bb(self):
        return self._pno("pno_bb")

    @property
    def pno_ab(self):
        return self._pno("pno_ab")


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


def _generic_precomputes(ham, psia, psib, prec):
    """The half-rotated tensors of pauxy_tpu/models/trial.py:108-140, each
    stored real when it is genuinely real (molecular data), and the
    local-energy variants' (``_generic_variant_precomputes``, from the
    complex half-rotated tensors as in JAX). Returns (arrays, channels,
    e0_terms)."""
    chol = ham.chol.cpu().numpy()
    h1 = ham.H1.cpu().numpy()

    def natural(arr):
        if np.iscomplexobj(arr) and np.abs(arr.imag).max(initial=0.0) == 0:
            arr = arr.real
        return arr.astype(prec.np_cplx if np.iscomplexobj(arr)
                          else prec.np_real)

    rca_c = _half_rotate(psia, chol).astype(prec.np_cplx)
    rcb_c = _half_rotate(psib, chol).astype(prec.np_cplx)
    rca, rcb = natural(rca_c), natural(rcb_c)
    host = {"rchola": rca, "rcholb": rcb,
            "rh1a": natural(psia.conj().T @ h1[0]),
            "rh1b": natural(psib.conj().T @ h1[1])}
    for key, rc in (("exx_supera", rca), ("exx_superb", rcb)):
        sup = _exx_supermatrix(rc)
        if sup is not None:
            host[key] = natural(sup)
    arrays, channels, e0_terms = _generic_variant_precomputes(
        ham, psia, psib, rca_c, rcb_c, prec)
    host.update(arrays)
    return host, channels, e0_terms


def _pno_channel(eri: np.ndarray, ni: int, nj: int, symmetric: bool,
                 thresh: float) -> tuple:
    """One PNO channel: for each pair (i, j) (i <= j when ``symmetric``)
    the SVD of eri[i, :, j, :] kept above ``thresh``, U sqrt(s) and
    sqrt(s) VT zero-padded to the largest kept rank."""
    idx_i, idx_j, coeff, us, vts = [], [], [], [], []
    for i in range(ni):
        for j in range(i if symmetric else 0, nj):
            u, s, vt = np.linalg.svd(eri[i, :, j, :])
            keep = s > thresh
            idx_i.append(i)
            idx_j.append(j)
            coeff.append(0.5 if (symmetric and i == j) else 1.0)
            us.append(u[:, keep] * np.sqrt(s[keep])[None, :])
            vts.append(np.sqrt(s[keep])[:, None] * vt[keep, :])
    kmax = max(max(u.shape[1] for u in us), 1)
    n, m = len(idx_i), eri.shape[1]
    upad = np.zeros((n, m, kmax), dtype=eri.dtype)
    vpad = np.zeros((n, kmax, m), dtype=eri.dtype)
    for t, (u, vt) in enumerate(zip(us, vts)):
        upad[t, :, :u.shape[1]] = u
        vpad[t, :vt.shape[0], :] = vt
    return (np.asarray(idx_i, np.int64), np.asarray(idx_j, np.int64),
            np.asarray(coeff).astype(eri.dtype), upad, vpad)


def _generic_variant_precomputes(ham, psia, psib, rca, rcb, prec):
    """The local-energy variants' host tensors, as in
    pauxy_tpu/models/trial.py:182: the half-rotated ERIs
    v_ipjq = sum_x rchol[x, i, p] rchol'[x, j, q] (exact_eri, and the PNO
    channels' source), the trial's Ghalf0 = (psi^H psi)^-1 psi^H and its
    energy terms (ecoul0, exxa0, exxb0) (pno, or stochastic RI with the
    control variate), and the padded PNO channels. Returns (arrays,
    channels, e0_terms)."""
    arrays, channels, e0_terms = {}, {}, None
    pno = getattr(ham, "pno", False)
    need_g0 = pno or (getattr(ham, "stochastic_ri", False)
                      and getattr(ham, "control_variate", False))
    cdtype = prec.np_cplx
    if getattr(ham, "exact_eri", False) or pno:
        eri = {key: np.einsum("xip,xjq->ipjq", a, b, optimize=True)
               for key, a, b in (("eri_aa", rca, rca), ("eri_bb", rcb, rcb),
                                 ("eri_ab", rca, rcb))}
        if getattr(ham, "exact_eri", False):
            arrays.update({k: v.astype(cdtype) for k, v in eri.items()})
    if need_g0:
        g0a = np.linalg.solve(psia.conj().T @ psia, psia.conj().T)
        g0b = (np.linalg.solve(psib.conj().T @ psib, psib.conj().T)
               if psib.shape[1] else np.zeros((0, psib.shape[0]), cdtype))
        x = (np.einsum("xam,am->x", rca, g0a, optimize=True)
             + np.einsum("xam,am->x", rcb, g0b, optimize=True))
        ta = np.einsum("xim,jm->xij", rca, g0a, optimize=True)
        tb = np.einsum("xim,jm->xij", rcb, g0b, optimize=True)
        e0_terms = (complex(np.dot(x, x)),
                    complex(np.einsum("xij,xji->", ta, ta, optimize=True)),
                    complex(np.einsum("xij,xji->", tb, tb, optimize=True)))
        arrays.update(ghalf0a=g0a.astype(cdtype), ghalf0b=g0b.astype(cdtype))
    if pno:
        na, nb = psia.shape[1], psib.shape[1]
        for key, ni, nj, sym in (("aa", na, na, True), ("bb", nb, nb, True),
                                 ("ab", na, nb, False)):
            ch = _pno_channel(eri[f"eri_{key}"], ni, nj, sym, ham.thresh_pno)
            channels[f"pno_{key}"] = (ch[0], ch[1],
                                      *(a.astype(cdtype) for a in ch[2:]))
    return arrays, channels, e0_terms


def _finalize(ham, psia, psib, prec, name: str, device) -> SingleDetTrial:
    psia = np.asarray(psia, dtype=prec.np_cplx)
    psib = np.asarray(psib, dtype=prec.np_cplx)
    g = trial_density_matrix(psia, psib)
    etrial = float(np.real(le.local_energy_G_host(ham, g)[0]))
    generic, e0_terms = {}, None

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if ham.name == "Generic":
        arrays, channels, e0_terms = _generic_precomputes(ham, psia, psib,
                                                          prec)
        generic = {k: dev(v) for k, v in arrays.items()}
        generic.update({k: tuple(dev(a) for a in v)
                        for k, v in channels.items()})
    return SingleDetTrial(dev(psia), dev(psib),
                          G_host=g.astype(prec.np_cplx), etrial=etrial,
                          name=name, e0_terms=e0_terms, **generic)


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
