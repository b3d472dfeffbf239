"""Hubbard model Hamiltonian (1D / 2D square lattice).

Counterpart of ``pauxy_tpu/models/hubbard.py``. The lattice one-body matrix
is built host-side with numpy (setup, not the hot path) and held as module
buffers, so ``.to(device)`` moves it. ``pinning_fields`` gives the
staggered-pinning lattice (open x, periodic y, spin-dependent fields on the
ix = 0 column).

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

    @property
    def nfields(self) -> int:
        """One auxiliary field per site."""
        return self.nbasis


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


def pinned_kinetic(t: float, nx: int, ny: int) -> np.ndarray:
    """Hopping matrices [2, M, M] with staggered pinning fields on the
    ix = 0 column: open x / periodic y boundaries, diagonal fields
    +/- 0.1 t (-1)^iy, of opposite sign for the two spins."""
    base = kinetic_matrix(t, nx, ny, ktwist=None, xpbc=False, ypbc=True)
    coords = _lattice_coords(nx, ny)
    field = np.where(coords[:, 0] == 0, (-1.0) ** coords[:, 1] * 0.1 * t,
                     0.0)
    return np.stack([base + np.diag(field), base - np.diag(field)])


def band_energies(t: float, nx: int, ny: int) -> np.ndarray:
    """e(k) = -2t (cos kx + cos ky), FFT k-ordering."""
    kx = 2.0 * np.pi * np.arange(nx) / nx
    if ny == 1:
        return -2.0 * t * np.cos(kx)
    ky = 2.0 * np.pi * np.arange(ny) / ny
    return (-2.0 * t * (np.cos(kx)[:, None] + np.cos(ky)[None, :])).reshape(-1)


def make_hubbard(nup: int, ndown: int, U: float, nx: int, ny: int = 1,
                 t: float = 1.0, ktwist=None, xpbc: bool = True,
                 ypbc: bool = True, symmetric: bool = False,
                 pinning_fields: bool = False, *, device=None, dtype=None
                 ) -> Hubbard:
    """Build a Hubbard system on ``device`` at precision ``dtype``."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    m = nx * ny
    if pinning_fields:
        h1 = pinned_kinetic(t, nx, ny).astype(prec.np_real)
    else:
        tmat = kinetic_matrix(t, nx, ny, ktwist=ktwist, xpbc=xpbc,
                              ypbc=ypbc)
        h1 = np.stack([tmat, tmat]).astype(
            prec.np_cplx if np.iscomplexobj(tmat) else prec.np_real)
    if symmetric:
        h1e_mod = h1
    else:
        h1e_mod = (h1 - 0.5 * U * np.eye(m)[None]).astype(h1.dtype)
    return Hubbard(
        torch.from_numpy(h1).to(device),
        torch.from_numpy(np.ascontiguousarray(h1e_mod)).to(device),
        torch.from_numpy(band_energies(t, nx, ny).astype(prec.np_real)
                         ).to(device),
        U=U, t=t, nx=nx, ny=ny, nup=nup, ndown=ndown, symmetric=symmetric,
    )


def fcidump_header(nel: int, norb: int, spin: int) -> str:
    """&FCI namelist header (``pauxy/utils/io.py:32-43``)."""
    orbsym = ",".join(["1"] * norb)
    return (
        "&FCI\n"
        f"NORB={int(norb)},\n"
        f"NELEC={int(nel)},\n"
        f"MS2={int(spin)},\n"
        "UHF=.FALSE.,\n"
        f"ORBSYM={orbsym},\n"
        "&END\n"
    )


def fcidump(ham: Hubbard, to_string: bool = False):
    """FCIDUMP of the Hubbard integrals in the site basis.

    Counterpart of ``pauxy/systems/hubbard.py:106-148``: on-site U as
    (ii|ii), hoppings as one-body integrals, core energy 0. Complex
    hoppings (twisted boundaries) use the "(re, im)" format. The string
    equals the JAX package's for the same lattice and precision.
    """
    t = ham.T.detach().cpu().numpy()
    m = ham.nbasis
    cplx = np.iscomplexobj(t) and np.abs(t.imag).max() > 1e-12
    out = fcidump_header(ham.nup + ham.ndown, m, ham.nup - ham.ndown)
    if cplx:
        fmt = "({: 10.8e}, {: 10.8e}) {:>3d} {:>3d} {:>3d} {:>3d}\n"
        for i in range(1, m + 1):
            out += fmt.format(ham.U, 0.0, i, i, i, i)
        for i in range(m):
            for j in range(i + 1, m):
                v = t[0][i, j]
                if abs(v) > 1e-8:
                    out += fmt.format(v.real, v.imag, i + 1, j + 1, 0, 0)
        out += fmt.format(0.0, 0.0, 0, 0, 0, 0)
    else:
        fmt = "{: 10.8e} {:>3d} {:>3d} {:>3d} {:>3d}\n"
        for i in range(1, m + 1):
            out += fmt.format(ham.U, i, i, i, i)
        for i in range(m):
            for j in range(i + 1, m):
                v = t[0][i, j].real
                if abs(v) > 1e-8:
                    out += fmt.format(v, i + 1, j + 1, 0, 0)
        out += fmt.format(0.0, 0, 0, 0, 0)
    if to_string:
        return out
    print(out)
    return None
