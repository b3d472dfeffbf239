"""Finite-temperature trial density matrices.

Counterpart of ``pauxy_tpu/models/thermal_trial.py``: the one-body trial,
the chemical-potential bisection, the Fock matrices and the thermal
Hartree-Fock (mean-field) trial. The set-up is host-side numpy and scipy,
as in JAX; what reaches the device is the slice propagator B_T (including
e^{dt mu}), its inverse, the within-bin left partial products and a full
bin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.estimators.thermal import (entropy, one_rdm_stable_host,
                                                particle_number_host)


@dataclasses.dataclass
class OneBodyTrial:
    """rho_T = prod exp(-dt (H1 - mu N)) trial density matrix."""

    dmat: torch.Tensor         # [2, M, M] B_T of one slice (with mu)
    dmat_inv: torch.Tensor     # [2, M, M]
    # left_table[c] = B_T^{stack_size - 1 - c}: the trial part of the
    # active bin after c + 1 propagator applications.
    left_table: torch.Tensor   # [stack_size, 2, M, M]
    bin_full: torch.Tensor     # [2, M, M] = B_T^{stack_size}
    mu: float
    beta: float
    dt: float
    num_slices: int
    stack_size: int
    nav: float
    P_host: np.ndarray | None = None
    G_host: np.ndarray | None = None
    name: str = "one_body"

    @property
    def nbins(self) -> int:
        return self.num_slices // self.stack_size

    @property
    def nbasis(self) -> int:
        return self.dmat.shape[-1]

    def to(self, device) -> "OneBodyTrial":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def find_chemical_potential(rho_dtau: np.ndarray, dtau: float, num_bins: int,
                            target: float, deps: float = 1e-6,
                            max_it: int = 1000, sign: int = 1) -> float:
    """Bracket and bisect mu so that <N>(mu) = target."""

    def nav(mu):
        rho_mu = rho_dtau * np.exp(sign * dtau * mu)
        return particle_number_host(one_rdm_stable_host(rho_mu, num_bins))

    mu1, mu2 = -1.0, 1.0
    d1, d2 = nav(mu1) - target, nav(mu2) - target
    while np.sign(d1) * np.sign(d2) > 0:
        mu1 -= 2
        mu2 += 2
        d1, d2 = nav(mu1) - target, nav(mu2) - target
        if mu2 > 200:
            raise RuntimeError("chemical potential bracket not found")
    for _ in range(max_it):
        mu = 0.5 * (mu1 + mu2)
        d = nav(mu) - target
        if abs(d) < deps:
            return mu
        if d * d1 > 0:
            mu1, d1 = mu, d
        else:
            mu2, d2 = mu, d
    raise RuntimeError("chemical potential bisection did not converge")


def make_one_body_trial(ham, beta: float, dt: float, mu: float | None = None,
                        nav: float | None = None,
                        stack_size: int | None = None, deps: float = 1e-6,
                        alt_convention: bool = False, *, device=None,
                        dtype=None) -> OneBodyTrial:
    """Build the one-body trial of ``ham`` (its ``H1``, or the Hubbard
    hopping ``T``) on ``device`` at precision ``dtype``. The stack size
    follows JAX's heuristic cond(B_T)^stack <= 1e3, reduced until it
    divides the number of slices; mu is bisected to the electron count
    unless given."""
    device = config.resolve_device(device)
    h1 = (ham.H1 if hasattr(ham, "H1") else ham.T).cpu().numpy()
    m = h1.shape[-1]
    dmat = np.stack([scipy.linalg.expm(-dt * h1[0]),
                     scipy.linalg.expm(-dt * h1[1])])
    num_slices = int(round(beta / dt))
    if stack_size is None:
        cond = np.linalg.cond(dmat[0])
        stack_size = max(1, min(num_slices, int(3.0 / np.log10(cond))))
    while num_slices % stack_size != 0:
        stack_size -= 1
    num_bins = num_slices // stack_size
    dtau = stack_size * dt
    sign = -1 if alt_convention else 1

    rho = np.stack([scipy.linalg.expm(-dtau * h1[0]),
                    scipy.linalg.expm(-dtau * h1[1])])
    if mu is None:
        target = nav if nav is not None else (ham.nup + ham.ndown)
        mu = find_chemical_potential(rho, dtau, num_bins, target, deps=deps,
                                     sign=sign)

    rho_mu = rho * np.exp(sign * dtau * mu)
    return _trial(dmat * np.exp(sign * dt * mu),
                  one_rdm_stable_host(rho_mu, num_bins), mu=mu, beta=beta,
                  dt=dt, stack_size=stack_size, name="one_body",
                  device=device, dtype=dtype)


def _trial(dmat_mu: np.ndarray, p: np.ndarray, *, mu: float, beta: float,
           dt: float, stack_size: int, name: str, device,
           dtype) -> OneBodyTrial:
    """The trial of the slice propagator ``dmat_mu`` [2, M, M] (with mu)
    and its 1-RDM ``p``: B_T^-1, the B_T powers of the within-bin left
    factors and a full bin, on ``device``."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    m = dmat_mu.shape[-1]
    g = np.stack([np.eye(m) - p[0].T, np.eye(m) - p[1].T])
    dmat_inv = np.stack([scipy.linalg.inv(dmat_mu[0]),
                         scipy.linalg.inv(dmat_mu[1])])
    powers = [np.stack([np.eye(m)] * 2)]
    for _ in range(stack_size):
        powers.append(np.stack([dmat_mu[0] @ powers[-1][0],
                                dmat_mu[1] @ powers[-1][1]]))
    left_table = np.stack([powers[stack_size - 1 - c]
                           for c in range(stack_size)])

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.astype(prec.np_cplx))).to(device)

    return OneBodyTrial(
        dmat=dev(dmat_mu), dmat_inv=dev(dmat_inv),
        left_table=dev(left_table), bin_full=dev(powers[stack_size]),
        mu=float(mu), beta=float(beta), dt=float(dt),
        num_slices=int(round(beta / dt)), stack_size=int(stack_size),
        nav=float(np.real(particle_number_host(p))), P_host=p, G_host=g,
        name=name,
    )


def fock_matrix(ham, p: np.ndarray) -> np.ndarray:
    """F per spin from the 1-RDM p [2, M, M]: Hubbard T + U diag(n of the
    other spin); Generic H1 + J - K from the Cholesky vectors; the UEG its
    one-body part (a THF seed)."""
    if ham.name == "Hubbard":
        t = ham.T.cpu().numpy()
        niu = np.diag(np.diagonal(p[0]))
        nid = np.diag(np.diagonal(p[1]))
        return t + ham.U * np.stack([nid, niu])
    if ham.name == "Generic":
        chol = ham.chol.cpu().numpy()
        h1 = ham.H1.cpu().numpy()
        xv = np.einsum("pqx,pq->x", chol, p[0] + p[1], optimize=True)
        j = np.einsum("pqx,x->pq", chol, xv, optimize=True)
        return np.stack([
            h1[s] + j - np.einsum("prx,rs,sqx->pq", chol, p[s], chol,
                                  optimize=True)
            for s in (0, 1)])
    if ham.name == "UEG":
        return ham.H1.cpu().numpy()
    raise NotImplementedError(f"no Fock matrix for {ham.name!r}")


def make_mean_field_trial(ham, beta: float, dt: float,
                          nav: float | None = None, mu: float | None = None,
                          find_mu: bool = True,
                          stack_size: int | None = None, alpha: float = 0.75,
                          max_macro_it: int = 100, max_scf_it: int = 100,
                          deps: float = 1e-6, verbose: bool = False, *,
                          device=None, dtype=None) -> OneBodyTrial:
    """Thermal Hartree-Fock trial on ``device``: macro-iterate the chemical
    potential around an inner SCF on the Fock matrix at fixed mu (density
    mixing ``alpha``); the converged mean-field Hamiltonian defines the
    slice propagator. ``find_mu=False`` keeps the given mu (or the seed's)
    fixed. With ``verbose``, logs the grand potential
    Omega = E - mu N - S/beta of each macro iteration."""
    device = config.resolve_device(device)
    num_slices = int(round(beta / dt))
    target = nav if nav is not None else (ham.nup + ham.ndown)
    m = ham.nbasis
    # Seed from the one-body trial (it also fixes the binning); only its
    # host 1-RDM and mu are used.
    seed = make_one_body_trial(ham, beta, dt, mu=mu, nav=nav,
                               stack_size=stack_size, deps=deps,
                               device="cpu", dtype="double")
    stack_size = seed.stack_size
    num_bins = num_slices // stack_size
    dtau = stack_size * dt
    p = seed.P_host
    mu_old = seed.mu
    mu_fixed = None if find_mu else (mu if mu is not None else seed.mu)
    eye = np.eye(m)
    hmf = fock_matrix(ham, p)
    for _ in range(max_macro_it):
        p_old = p
        for _ in range(max_scf_it):
            hmf = fock_matrix(ham, p_old)
            rho = np.stack([scipy.linalg.expm(-dtau * (hmf[s] - mu_old * eye))
                            for s in (0, 1)])
            p_new = ((1 - alpha) * one_rdm_stable_host(rho, num_bins)
                     + alpha * p_old)
            converged = np.linalg.norm(p_new - p_old) < deps
            p_old = p_new
            if converged:
                break
        p = p_old
        rho0 = np.stack([scipy.linalg.expm(-dtau * hmf[s]) for s in (0, 1)])
        if mu_fixed is not None:
            mu = mu_fixed
        else:
            mu = find_chemical_potential(rho0, dtau, num_bins, target,
                                         deps=deps)
        if verbose:
            n_cur = float(np.real(particle_number_host(p)))
            e_cur = float(np.real(le.local_energy_G_host(
                ham, eye[None] - p.transpose(0, 2, 1))[0]))
            omega = e_cur - mu * n_cur - entropy(beta, mu, hmf) / beta
            print(f" # THF macro-iteration: mu = {mu:13.8e} "
                  f"Omega = {omega:13.8e}")
        done = abs(mu - mu_old) < deps
        mu_old = mu
        if done:
            break
    dmat = np.stack([scipy.linalg.expm(-dt * (hmf[s] - mu_old * eye))
                     for s in (0, 1)])
    rho_mu = np.stack([scipy.linalg.expm(-dtau * (hmf[s] - mu_old * eye))
                       for s in (0, 1)])
    return _trial(dmat, one_rdm_stable_host(rho_mu, num_bins), mu=mu_old,
                  beta=beta, dt=dt, stack_size=stack_size, name="mean_field",
                  device=device, dtype=dtype)
