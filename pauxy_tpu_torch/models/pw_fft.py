"""FFT-grid plane-wave UEG (PW_FFT).

Counterpart of ``pauxy_tpu/models/pw_fft.py`` (its host construction
copied, so that the port imports nothing of the JAX package): the physics
of ``models/ueg.py`` with the basis laid out on a 3D FFT mesh, so that the
two-body propagator, the force bias and the local energy are convolutions,
batched ``torch.fft`` calls instead of [nq, M, M] density matrices.

Grid conventions: k-space cubes are stored in FFT frequency order (index =
n mod N per axis), so circular convolution indices line up with momentum
sums and no shifts are needed. The basis sphere (the 2 ecut ball) and the
momentum transfers (the 4 ecut ball, q = 0 kept with v_q = 0) sit in the
(4 nmax + 1)^3 cube ``qmesh``; aliased convolution components land at
|n| >= nmax + 1, outside the kept sphere, so the circular FFT convolution
equals the reference's zero-padded linear one on every kept component.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models.ueg import madelung


class PWFFT(nn.Module):
    """Plane-wave UEG on an FFT mesh. Buffers: ``sp_eigv`` [M]
    single-particle energies, ``h1e_mod`` [M] the diagonal modified
    one-body term, ``vqvec`` [nq] 4 pi / q^2 (0 at q = 0), ``gmap`` [M] and
    ``qmap`` [nq] long, the basis and the q vectors on the flat cube."""

    name = "PW_FFT"

    def __init__(self, sp_eigv, h1e_mod, vqvec, gmap, qmap, *,
                 basis: np.ndarray, qvecs: np.ndarray, qmesh: tuple,
                 rs: float, ecut: float, vol: float, kfac: float,
                 ecore: float, nup: int, ndown: int, nmax: int):
        super().__init__()
        self.register_buffer("sp_eigv", sp_eigv)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("vqvec", vqvec)
        self.register_buffer("gmap", gmap)
        self.register_buffer("qmap", qmap)
        self.basis = np.asarray(basis)
        self.qvecs = np.asarray(qvecs)
        self.qmesh = tuple(qmesh)
        self.rs = float(rs)
        self.ecut = float(ecut)
        self.vol = float(vol)
        self.kfac = float(kfac)
        self.ecore = float(ecore)
        self.nup = int(nup)
        self.ndown = int(ndown)
        self.nmax = int(nmax)

    @property
    def nbasis(self) -> int:
        return self.basis.shape[0]

    @property
    def nq(self) -> int:
        return self.qvecs.shape[0]

    @property
    def nfields(self) -> int:
        return 2 * self.nq

    @property
    def nelec(self) -> tuple[int, int]:
        return (self.nup, self.ndown)

    @property
    def ne(self) -> int:
        return self.nup + self.ndown

    @property
    def T(self) -> torch.Tensor:
        """The one-body matrix [2, M, M], diagonal."""
        return torch.diag_embed(self.sp_eigv)[None].expand(2, -1, -1)

    @property
    def kf(self) -> float:
        zeta = 1 if self.ndown == 0 else 0
        return (3 * (zeta + 1) * math.pi ** 2 * self.ne / self.vol) ** (1 / 3)

    @property
    def ef(self) -> float:
        return 0.5 * self.kf ** 2


def _sphere(ecut: float, nmax: int) -> np.ndarray:
    """All integer k with |k|^2 / 2 <= ecut, in grid (itertools.product)
    order, the reference's enumeration."""
    rng = np.arange(-nmax, nmax + 1)
    kall = np.array(list(itertools.product(rng, rng, rng)), dtype=np.int64)
    keep = 0.5 * np.sum(kall * kall, axis=1) <= ecut
    return kall[keep]


def fft_index(vecs: np.ndarray, n: int) -> np.ndarray:
    """Flat index of integer k-vectors in an n^3 cube, FFT order."""
    w = np.mod(vecs, n)
    return (w[:, 0] * n + w[:, 1]) * n + w[:, 2]


def gather_maps(ham):
    """The UEG-style gather maps of a PW_FFT system (host numpy): for each
    q and basis index i, the index of k_i + q and of k_i - q in the basis
    (0 where outside) and their masks, each [nq, M]. A k +/- q lands on a
    basis vector's cube index only if it is that vector (|k +/- q|_inf <=
    3 nmax < 4 nmax + 1 - nmax), so the cube is the lookup table."""
    n = ham.qmesh[0]
    lut = -np.ones(n ** 3, dtype=np.int64)
    lut[fft_index(ham.basis, n)] = np.arange(ham.nbasis)
    maps = []
    for sign in (1, -1):
        v = ham.basis[None, :, :] + sign * ham.qvecs[:, None, :]
        idx = lut[fft_index(v.reshape(-1, 3), n)].reshape(ham.nq,
                                                           ham.nbasis)
        maps += [np.where(idx >= 0, idx, 0), idx >= 0]
    return tuple(maps)


def make_pw_fft(nup: int, ndown: int, rs: float, ecut: float, ktwist=None,
                *, device=None, dtype=None) -> PWFFT:
    """Build the PW_FFT system on ``device`` at precision ``dtype``
    (host-side numpy construction, then tensors)."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    ne = nup + ndown
    L = rs * (4.0 * ne * np.pi / 3.0) ** (1.0 / 3.0)
    vol = L ** 3
    kfac = 2 * np.pi / L
    tw = np.zeros(3) if ktwist is None else np.asarray(ktwist, float)

    nmax = int(math.ceil(math.sqrt(2 * ecut)))
    basis = _sphere(ecut, nmax)
    ks = basis + tw[None, :]
    sp_eigv = 0.5 * kfac ** 2 * np.sum(ks * ks, axis=1)

    qvecs = _sphere(4.0 * ecut, 2 * nmax)
    qsq = kfac ** 2 * np.sum(qvecs * qvecs, axis=1).astype(float)
    vqvec = np.where(qsq > 1e-10, 4.0 * np.pi / np.where(qsq > 0, qsq, 1.0),
                     0.0)

    ngrid = 4 * nmax + 1
    # Diagonal exchange shift: subtract (1/2V) sum_{j != i} v(k_i - k_j)
    # from each diagonal element.
    diff = basis[:, None, :] - basis[None, :, :]
    dsq = kfac ** 2 * np.sum(diff * diff, axis=-1).astype(float)
    vdiff = np.where(dsq > 1e-10, 4.0 * np.pi / np.where(dsq > 0, dsq, 1.0),
                     0.0)
    h1e_mod = sp_eigv - vdiff.sum(axis=1) / (2.0 * vol)

    def tens(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(
            x if dt is None else x.astype(dt))).to(device)

    return PWFFT(
        tens(sp_eigv, prec.np_real), tens(h1e_mod, prec.np_real),
        tens(vqvec, prec.np_real), tens(fft_index(basis, ngrid), np.int64),
        tens(fft_index(qvecs, ngrid), np.int64), basis=basis, qvecs=qvecs,
        qmesh=(ngrid, ngrid, ngrid), rs=rs, ecut=ecut, vol=vol, kfac=kfac,
        ecore=float(0.5 * ne * madelung(rs, ne)), nup=nup, ndown=ndown,
        nmax=nmax)
