"""Hubbard model Hamiltonian (1D / 2D square lattice).

Counterpart of ``pauxy_tpu/models/hubbard.py``. The lattice one-body matrix
is built host-side with numpy (setup, not the hot path) and held as module
buffers, so ``.to(device)`` moves it. Pinning fields are not ported yet.

Site ordering: i = ix + nx*iy. Twist: boundary-wrap hops pick up a phase
exp(i pi k.e).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config


class Hubbard(nn.Module):
    """Hubbard Hamiltonian: hopping ``T`` [2, M, M], ``h1e_mod`` = T - U/2
    (unless symmetric) and band energies ``eks`` [M], as buffers."""

    name = "Hubbard"

    def __init__(self, T, h1e_mod, eks, *, U: float, t: float, nx: int,
                 ny: int, nup: int, ndown: int, symmetric: bool):
        super().__init__()
        self.register_buffer("T", T)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("eks", eks)
        self.U = float(U)
        self.t = float(t)
        self.nx = int(nx)
        self.ny = int(ny)
        self.nup = int(nup)
        self.ndown = int(ndown)
        self.symmetric = bool(symmetric)

    @property
    def nbasis(self) -> int:
        return self.nx * self.ny


def _lattice_coords(nx: int, ny: int) -> np.ndarray:
    """[M, 2] cartesian coordinates, i = ix + nx*iy."""
    i = np.arange(nx * ny)
    return np.stack([i % nx, i // nx], axis=1)


def kinetic_matrix(t: float, nx: int, ny: int, ktwist=None,
                   xpbc: bool = True, ypbc: bool = True) -> np.ndarray:
    """Nearest-neighbour hopping matrix [M, M] with periodic/twisted
    boundaries; complex iff a twist is given. For nx == 2 (or ny == 2) the
    wrap bond coincides with the direct bond and both contributions add."""
    m = nx * ny
    coords = _lattice_coords(nx, ny)
    d = np.abs(coords[None, :, :] - coords[:, None, :])     # [M, M, 2]
    upper = np.triu(np.ones((m, m), dtype=bool), k=1)
    if ktwist is not None:
        ktwist = np.asarray(ktwist, dtype=np.float64)
        phase_x = np.exp(1j * np.pi * ktwist[0])
        phase_y = np.exp(1j * np.pi * ktwist[1]) if ny > 1 else 1.0
        tmat = np.zeros((m, m), dtype=np.complex128)
    else:
        phase_x = phase_y = 1.0
        tmat = np.zeros((m, m), dtype=np.float64)
    direct = (d.sum(axis=2) == 1) & upper
    tmat[direct] += -t
    if xpbc and nx > 1:
        wrap_x = (d[:, :, 0] == nx - 1) & (d[:, :, 1] == 0) & upper
        tmat[wrap_x] += -t * phase_x
    if ypbc and ny > 1:
        wrap_y = (d[:, :, 0] == 0) & (d[:, :, 1] == ny - 1) & upper
        tmat[wrap_y] += -t * phase_y
    return tmat + tmat.conj().T


def band_energies(t: float, nx: int, ny: int) -> np.ndarray:
    """e(k) = -2t (cos kx + cos ky), FFT k-ordering."""
    kx = 2.0 * np.pi * np.arange(nx) / nx
    if ny == 1:
        return -2.0 * t * np.cos(kx)
    ky = 2.0 * np.pi * np.arange(ny) / ny
    return (-2.0 * t * (np.cos(kx)[:, None] + np.cos(ky)[None, :])).reshape(-1)


def make_hubbard(nup: int, ndown: int, U: float, nx: int, ny: int = 1,
                 t: float = 1.0, ktwist=None, xpbc: bool = True,
                 ypbc: bool = True, symmetric: bool = False, *,
                 device=None, dtype=None) -> Hubbard:
    """Build a Hubbard system on ``device`` at precision ``dtype``."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    m = nx * ny
    tmat = kinetic_matrix(t, nx, ny, ktwist=ktwist, xpbc=xpbc, ypbc=ypbc)
    np_dtype = prec.np_cplx if np.iscomplexobj(tmat) else prec.np_real
    h1 = np.stack([tmat, tmat]).astype(np_dtype)
    if symmetric:
        h1e_mod = h1
    else:
        h1e_mod = (h1 - 0.5 * U * np.eye(m)[None]).astype(np_dtype)
    return Hubbard(
        torch.from_numpy(h1).to(device),
        torch.from_numpy(np.ascontiguousarray(h1e_mod)).to(device),
        torch.from_numpy(band_energies(t, nx, ny).astype(prec.np_real)
                         ).to(device),
        U=U, t=t, nx=nx, ny=ny, nup=nup, ndown=ndown, symmetric=symmetric,
    )
