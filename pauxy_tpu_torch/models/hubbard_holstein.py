"""Hubbard-Holstein model: electrons and local (Holstein) phonons.

Counterpart of ``pauxy_tpu/models/hubbard_holstein.py``:

  H = -t sum c^dag c + U sum n_up n_dn + sum_i [ p_i^2/2m + m w0^2 X_i^2/2 ]
      - g sqrt(2 m w0) sum_i rho_i X_i

``HubbardHolstein`` holds the lattice tensors as buffers; the
harmonic-oscillator helpers are batched torch functions over walkers
[w, M]; the coherent-state and Lang-Firsov trials are built host-side
(numpy / scipy; setup) and return a ``SingleDetTrial`` carrying the phonon
``shift``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models.hubbard import band_energies, kinetic_matrix
from pauxy_tpu_torch.models.trial import SingleDetTrial, trial_density_matrix


class HubbardHolstein(nn.Module):
    """Buffers: hopping ``T`` [2, M, M], ``h1e_mod`` = T - U/2 [2, M, M]
    and band energies ``eks`` [M]; g, w0, m and lambda as numbers."""

    name = "HubbardHolstein"
    symmetric = False

    def __init__(self, T, h1e_mod, eks, *, U: float, t: float, g: float,
                 w0: float, m: float, lmbda: float, nx: int, ny: int,
                 nup: int, ndown: int):
        super().__init__()
        self.register_buffer("T", T)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("eks", eks)
        self.U = float(U)
        self.t = float(t)
        self.g = float(g)
        self.w0 = float(w0)
        self.m = float(m)
        self.lmbda = float(lmbda)
        self.nx = int(nx)
        self.ny = int(ny)
        self.nup = int(nup)
        self.ndown = int(ndown)

    @property
    def nbasis(self) -> int:
        return self.nx * self.ny

    @property
    def nfields(self) -> int:
        return self.nbasis

    @property
    def gsq2mw(self) -> float:
        """g sqrt(2 m w0): the electron-phonon coupling prefactor."""
        return self.g * np.sqrt(2.0 * self.m * self.w0)


def make_hubbard_holstein(nup: int, ndown: int, U: float, nx: int,
                          ny: int = 1, t: float = 1.0, w0: float = 1.0,
                          lmbda: float = 1.0, g: float | None = None,
                          m: float | None = None, xpbc: bool = True,
                          ypbc: bool = True, *, device=None,
                          dtype=None) -> HubbardHolstein:
    """Build the system on ``device`` at precision ``dtype``. g defaults to
    sqrt(d 2 lambda t w0), d the lattice's dimension; m to 1/w0."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    if m is None:
        m = 1.0 / w0
    if g is None:
        d = 1 if ny == 1 else 2
        g = np.sqrt(d * 2.0 * lmbda * t * w0)
    tmat = kinetic_matrix(t, nx, ny, ktwist=None, xpbc=xpbc, ypbc=ypbc)
    v0 = 0.5 * U * np.eye(nx * ny)

    def buf(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(prec.np_real))).to(device)

    return HubbardHolstein(
        buf(np.stack([tmat, tmat])), buf(np.stack([tmat - v0, tmat - v0])),
        buf(band_energies(t, nx, ny)), U=U, t=t, g=g, w0=w0, m=m,
        lmbda=lmbda, nx=nx, ny=ny, nup=nup, ndown=ndown)


def carries_phonons(trial) -> bool:
    """Whether the walkers carry phonon coordinates X: the trial has a
    phonon shift (coherent-state, Lang-Firsov or multi-coherent)."""
    return getattr(trial, "shift", None) is not None


# ---- harmonic-oscillator phonon trial, batched over walkers [w, M] ----

def ho_log_value(x, m: float, w0: float, shift):
    """log prod_i exp(-m w0 (x_i - shift_i)^2 / 2), unnormalised."""
    d = x - shift
    return -0.5 * m * w0 * torch.sum(d * d, dim=-1)


def ho_gradient(x, m: float, w0: float, shift):
    return -m * w0 * (x - shift)


def ho_laplacian(x, m: float, w0: float, shift):
    d = x - shift
    return (m * w0) ** 2 * d * d - m * w0


def ho_local_energy(x, m: float, w0: float, shift):
    """The phonon local energy, with the zero-point energy w0 M / 2
    subtracted."""
    nsites = x.shape[-1]
    ke = -0.5 * torch.sum(ho_laplacian(x, m, w0, shift), dim=-1) / m
    pot = 0.5 * m * w0 * w0 * torch.sum(x * x, dim=-1)
    return ke + pot - 0.5 * w0 * nsites


# ---- trials (host-side) --------------------------------------------------

def _trial(psia, psib, shift, etrial: float, name: str, prec,
           device) -> SingleDetTrial:
    psia = np.asarray(psia).astype(prec.np_cplx)
    psib = np.asarray(psib).astype(prec.np_cplx)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return SingleDetTrial(dev(psia), dev(psib),
                          G_host=trial_density_matrix(psia, psib),
                          etrial=etrial, name=name,
                          shift=dev(np.asarray(shift).astype(prec.np_real)))


def coherent_state_trial(ham: HubbardHolstein, max_scf: int = 200,
                         tol: float = 1e-8, *, device=None,
                         dtype=None) -> SingleDetTrial:
    """Self-consistent coherent-state trial: alternate the electron mean
    field at fixed shift X (H_eff = T + U n_{-s} - g sqrt(2 m w0) diag X)
    and the shift at fixed density, X_i = g sqrt(2 m w0) n_i / (m w0^2),
    until the variational energy moves by less than ``tol``."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    mlat = ham.nbasis
    t0 = ham.T[0].cpu().numpy().astype(np.float64)
    cpl = ham.gsq2mw
    shift = np.zeros(mlat)
    niup = np.full(mlat, ham.nup / mlat)
    nidown = np.full(mlat, ham.ndown / mlat)
    e_old = np.inf
    for _ in range(max_scf):
        ha = t0 + ham.U * np.diag(nidown) - cpl * np.diag(shift)
        hb = t0 + ham.U * np.diag(niup) - cpl * np.diag(shift)
        _, va = np.linalg.eigh(ha)
        _, vb = np.linalg.eigh(hb)
        psia = va[:, :ham.nup]
        psib = vb[:, :ham.ndown]
        niup = np.einsum("mi,mi->m", psia, psia.conj()).real
        nidown = np.einsum("mi,mi->m", psib, psib.conj()).real
        rho = niup + nidown
        shift = cpl * rho / (ham.m * ham.w0 ** 2)
        ke = np.sum(t0 * (psia @ psia.conj().T + psib @ psib.conj().T).T)
        pe = ham.U * np.dot(niup, nidown)
        eph = (0.5 * ham.m * ham.w0 ** 2 * np.dot(shift, shift)
               - cpl * np.dot(rho, shift))
        e_new = ke + pe + eph
        if abs(e_new - e_old) < tol:
            break
        e_old = e_new
    return _trial(psia, psib, shift, float(np.real(e_new)),
                  "coherent_state", prec, device)


def _lf_params(ham: HubbardHolstein):
    """The standard Lang-Firsov dressing gamma = g sqrt(2 / (m w0^3)) and
    the effective Hubbard U it leaves."""
    gamma = ham.g * np.sqrt(2.0 / (ham.m * ham.w0 ** 3))
    ueff = (ham.U + gamma ** 2 * ham.m * ham.w0 ** 2
            - 2.0 * ham.g * gamma * np.sqrt(2.0 * ham.m * ham.w0))
    return gamma, ueff


def lang_firsov_energy(ham: HubbardHolstein, psia, psib, gamma) -> float:
    """Variational energy of the Lang-Firsov-transformed Hamiltonian at
    zero shift:

      E = sum_i (gamma_i^2 m w0^2/2 - g gamma_i sqrt(2 m w0)) n_i
        + sum_i (U + gamma_i^2 m w0^2 - 2 g gamma_i sqrt(2 m w0)) n_ia n_ib
        + sum_ij e^{-(a_i^2+a_j^2)/2} T_ij G_ij,  a = gamma sqrt(m w0/2).
    """
    ga = (psia @ np.linalg.inv(psia.conj().T @ psia) @ psia.conj().T).T
    if psib.shape[1] > 0:
        gb = (psib @ np.linalg.inv(psib.conj().T @ psib) @ psib.conj().T).T
    else:
        gb = np.zeros_like(ga)
    nia, nib = np.diag(ga).real, np.diag(gb).real
    ni = nia + nib
    sq2mw = np.sqrt(2.0 * ham.m * ham.w0)
    gamma = np.asarray(gamma) * np.ones(ham.nbasis)
    eeph = np.sum((gamma ** 2 * ham.m * ham.w0 ** 2 / 2.0
                   - ham.g * gamma * sq2mw) * ni)
    eee = np.sum((ham.U + gamma ** 2 * ham.m * ham.w0 ** 2
                  - 2.0 * ham.g * gamma * sq2mw) * nia * nib)
    alpha = gamma * np.sqrt(ham.m * ham.w0 / 2.0)
    const = np.exp(-0.5 * alpha ** 2)
    cmat = np.outer(const, const)
    t = ham.T.cpu().numpy().astype(np.float64)
    ekin = np.sum(cmat * t[0] * ga + cmat * t[1] * gb).real
    return float(eeph + eee + ekin)


def lang_firsov_trial(ham: HubbardHolstein, relax_gamma: bool = False,
                      restricted: bool = False, nrestart: int = 5, *,
                      device=None, dtype=None):
    """Variationally optimised Lang-Firsov trial: orbital rotations
    C_s = C0_s expm(theta_s), theta_s antisymmetric from the
    occupied-virtual block, minimise ``lang_firsov_energy`` by L-BFGS-B
    with restarts perturbed from numpy's ``default_rng(7)``; gamma stays
    the standard polaron value unless ``relax_gamma``. The shift is zero
    in the Lang-Firsov frame. Returns (trial, gamma [M])."""
    import scipy.linalg
    import scipy.optimize

    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    m = ham.nbasis
    na, nb = ham.nup, ham.ndown
    nva, nvb = m - na, m - nb
    t = ham.T.cpu().numpy().astype(np.float64)
    _, c0a = np.linalg.eigh(t[0])
    _, c0b = np.linalg.eigh(t[1])
    gamma0, _ = _lf_params(ham)

    def unpack(x):
        daia = x[:nva * na].reshape(nva, na)
        daib = x[nva * na:nva * na + nvb * nb].reshape(nvb, nb)
        if restricted:
            daib = daia
        gamma = x[nva * na + nvb * nb:] if relax_gamma else gamma0 * np.ones(m)
        return daia, daib, gamma

    def orbitals(daia, daib):
        tha = np.zeros((m, m))
        tha[na:, :na] = daia
        tha[:na, na:] = -daia.T
        thb = np.zeros((m, m))
        thb[nb:, :nb] = daib
        thb[:nb, nb:] = -daib.T
        ca = c0a @ scipy.linalg.expm(tha)
        cb = c0b @ scipy.linalg.expm(thb)
        return ca[:, :na], cb[:, :nb]

    def objective(x):
        daia, daib, gamma = unpack(x)
        psia, psib = orbitals(daia, daib)
        return lang_firsov_energy(ham, psia, psib, gamma)

    nparam = nva * na + nvb * nb + (m if relax_gamma else 0)
    rng = np.random.default_rng(7)
    best_e, best_x = np.inf, np.zeros(nparam)
    x = np.zeros(nparam)
    if relax_gamma:
        x[nva * na + nvb * nb:] = gamma0
    for _ in range(nrestart):
        res = scipy.optimize.minimize(objective, x, method="L-BFGS-B")
        if res.fun < best_e - 1e-6:
            best_e, best_x = res.fun, res.x.copy()
        else:
            break
        x = best_x + 0.01 * rng.standard_normal(nparam)
        if relax_gamma:
            x[nva * na + nvb * nb:] = np.abs(x[nva * na + nvb * nb:])
    daia, daib, gamma = unpack(best_x)
    psia, psib = orbitals(daia, daib)
    return (_trial(psia, psib, np.zeros(m), float(best_e), "lang_firsov",
                   prec, device), np.asarray(gamma))
