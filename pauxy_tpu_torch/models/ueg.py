"""Uniform electron gas (3D, plane waves).

Counterpart of ``pauxy_tpu/models/ueg.py`` (its host construction copied,
so that the port imports nothing of the JAX package). The system carries
the integer gather maps of the momentum-transfer density operators rho_q
([nq, M] index of k_i + q and k_i - q, with masks) and the Coulomb kernel
4 pi / q^2 as tensors; rho_q itself is never stored dense (see
``ops/ueg_sparse.py``). Units and conventions follow the reference: kfac =
2 pi / L, energies in Hartree, ecut in scaled units, the q grid the 4 ecut
sphere minus q = 0, the Madelung core energy. The FFT-cube maps ``gmap``
[M] and ``qmap`` [nq] place the basis and the q vectors on the
(4 nmax + 1)^3 cube ``qmesh`` in FFT frequency order, for the
pseudo-spectral energies and force bias: the cube holds every k +/- q
without circular aliasing (|k|_inf <= nmax, |q|_inf <= 2 nmax).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config


class UEG(nn.Module):
    """UEG Hamiltonian. Buffers: ``H1`` [2, M, M] diagonal kinetic energy,
    ``h1e_mod`` [2, M, M] with the exchange-Fock diagonal shift,
    ``kpq_idx``/``pmq_idx`` [nq, M] long (index of k_i +/- q, 0 where
    invalid), ``kpq_mask``/``pmq_mask`` [nq, M] bool, ``vqvec`` [nq], and
    the FFT-cube maps ``gmap`` [M] and ``qmap`` [nq] long on the cube
    ``qmesh`` (None without them: the energies then take the gather
    kernels)."""

    name = "UEG"

    def __init__(self, H1, h1e_mod, kpq_idx, kpq_mask, pmq_idx, pmq_mask,
                 vqvec, *, basis: np.ndarray, qvecs: np.ndarray, rs: float,
                 ecut: float, vol: float, kfac: float, ecore: float,
                 nup: int, ndown: int, gmap=None, qmap=None,
                 qmesh: tuple | None = None):
        super().__init__()
        self.register_buffer("H1", H1)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("kpq_idx", kpq_idx)
        self.register_buffer("kpq_mask", kpq_mask)
        self.register_buffer("pmq_idx", pmq_idx)
        self.register_buffer("pmq_mask", pmq_mask)
        self.register_buffer("vqvec", vqvec)
        self.register_buffer("gmap", gmap)
        self.register_buffer("qmap", qmap)
        self.qmesh = None if qmesh is None else tuple(qmesh)
        self.basis = np.asarray(basis)
        self.qvecs = np.asarray(qvecs)
        self.rs = float(rs)
        self.ecut = float(ecut)
        self.vol = float(vol)
        self.kfac = float(kfac)
        self.ecore = float(ecore)
        self.nup = int(nup)
        self.ndown = int(ndown)

    @property
    def ne(self) -> int:
        return self.nup + self.ndown

    @property
    def kf(self) -> float:
        """Fermi wavevector of the infinite system; zeta = 1 when fully
        polarised (ndown == 0)."""
        zeta = 1 if self.ndown == 0 else 0
        return (3 * (zeta + 1) * math.pi ** 2 * self.ne / self.vol) ** (1 / 3)

    @property
    def ef(self) -> float:
        """Fermi energy, the unit of theta = T/T_F reduced temperatures."""
        return 0.5 * self.kf ** 2

    @property
    def nbasis(self) -> int:
        return self.H1.shape[-1]

    @property
    def nq(self) -> int:
        return self.vqvec.shape[0]

    @property
    def nfields(self) -> int:
        # x_+ (for iA) and x_- (for iB) per q.
        return 2 * self.nq

    @property
    def nelec(self) -> tuple[int, int]:
        return (self.nup, self.ndown)


def plane_wave_basis(ecut: float, ktwist=None):
    """All integer k-vectors with |n|^2/2 <= ecut, sorted by twist-shifted
    kinetic energy (stable sort over the x-outermost enumeration, the
    reference's tie-breaking). Returns (eigs in units of kfac^2, nvecs
    [M, 3], nmax)."""
    nmax = int(np.ceil(np.sqrt(2 * ecut)))
    grid = np.arange(-nmax, nmax + 1)
    n = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    spe = 0.5 * np.sum(n * n, axis=1)
    n = n[spe <= ecut]
    ks = np.zeros(3) if ktwist is None else np.asarray(ktwist, dtype=float)
    ek = 0.5 * np.sum((n + ks) ** 2, axis=1)
    order = np.argsort(ek, kind="stable")
    return ek[order], n[order], nmax


def _index_map(basis: np.ndarray, nmax: int):
    """Linear-index lookup: k-vectors [N, 3] -> (basis index [N], valid
    [N])."""
    shifted = 2 * nmax
    lin = ((basis[:, 0] + nmax) + shifted * (basis[:, 1] + nmax)
           + shifted ** 2 * (basis[:, 2] + nmax))
    lookup = -np.ones(lin.max() + 1, dtype=np.int64)
    lookup[lin] = np.arange(len(basis))
    imax_sq = int(np.dot(basis[-1], basis[-1]))

    def lookup_vec(vecs: np.ndarray):
        inside = np.sum(vecs * vecs, axis=1) <= imax_sq
        lv = ((vecs[:, 0] + nmax) + shifted * (vecs[:, 1] + nmax)
              + shifted ** 2 * (vecs[:, 2] + nmax))
        in_table = inside & (lv >= 0) & (lv < len(lookup))
        idx = np.where(in_table, lookup[np.clip(lv, 0, len(lookup) - 1)],
                       -1)
        valid = idx >= 0
        return np.where(valid, idx, 0), valid

    return lookup_vec


def fft_maps(basis: np.ndarray, qvecs: np.ndarray, nmax: int):
    """(gmap [M], qmap [nq], qmesh): flat indices of the basis and q
    vectors on the (4 nmax + 1)^3 cube in FFT frequency order."""
    ngrid = 4 * nmax + 1

    def fft_index(vecs):
        w = np.mod(vecs, ngrid)
        return ((w[:, 0] * ngrid + w[:, 1]) * ngrid + w[:, 2]).astype(
            np.int64)

    return fft_index(basis), fft_index(qvecs), (ngrid, ngrid, ngrid)


def madelung(rs: float, ne: int) -> float:
    """Schoof et al.'s fit for the Madelung constant."""
    c1 = -2.837297
    c2 = (3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    return c1 * c2 / (ne ** (1.0 / 3.0) * rs)


def make_ueg(nup: int, ndown: int, rs: float, ecut: float, ktwist=None, *,
             device=None, dtype=None) -> UEG:
    """Build the UEG system on ``device`` at precision ``dtype`` (host-side
    numpy construction, then tensors)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    ne = nup + ndown
    L = rs * (4.0 * ne * np.pi / 3.0) ** (1.0 / 3.0)
    vol = L ** 3
    kfac = 2 * np.pi / L

    eigs, basis, nmax = plane_wave_basis(ecut, ktwist)
    m = len(basis)
    sp_eigv = kfac ** 2 * eigs
    lookup = _index_map(basis, nmax)

    # Momentum transfers: the 4 ecut sphere, q = 0 dropped.
    _, qvecs, _ = plane_wave_basis(ecut * 4.0, None)
    qvecs = (qvecs[1:] if np.all(qvecs[0] == 0)
             else qvecs[~np.all(qvecs == 0, 1)])
    nq = len(qvecs)
    qsq = kfac ** 2 * np.sum(qvecs * qvecs, axis=1)
    vqvec = 4 * np.pi / qsq

    kpq = basis[None, :, :] + qvecs[:, None, :]           # [nq, M, 3]
    pmq = basis[None, :, :] - qvecs[:, None, :]
    kpq_idx, kpq_mask = lookup(kpq.reshape(-1, 3))
    pmq_idx, pmq_mask = lookup(pmq.reshape(-1, 3))

    # One-body: T = diag(sp_eigv); h1e_mod subtracts the q-summed Coulomb
    # diagonal 1/(2 vol) sum_{j != i} 4 pi / |k_i - k_j|^2.
    t = np.diag(sp_eigv)
    diff = kfac * (basis[:, None, :] - basis[None, :, :])
    dsq = np.sum(diff * diff, axis=-1)
    with np.errstate(divide="ignore"):
        vq_pair = np.where(dsq > 1e-12,
                           4 * np.pi / np.where(dsq > 0, dsq, 1.0), 0.0)
    fock_diag = np.sum(vq_pair, axis=1) / (2.0 * vol)
    h1e_mod = t - np.diag(fock_diag)

    def tens(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(
            x if dt is None else x.astype(dt))).to(device)

    rdt = prec.np_real
    gmap, qmap, qmesh = fft_maps(basis, qvecs, nmax)
    return UEG(
        tens(np.stack([t, t]), rdt), tens(np.stack([h1e_mod, h1e_mod]), rdt),
        tens(kpq_idx.reshape(nq, m), np.int64), tens(kpq_mask.reshape(nq, m)),
        tens(pmq_idx.reshape(nq, m), np.int64), tens(pmq_mask.reshape(nq, m)),
        tens(vqvec, rdt),
        basis=basis, qvecs=qvecs, rs=rs, ecut=ecut, vol=vol, kfac=kfac,
        ecore=0.5 * ne * madelung(rs, ne), nup=nup, ndown=ndown,
        gmap=tens(gmap), qmap=tens(qmap), qmesh=qmesh,
    )
