"""Generic ab-initio Hamiltonian from Cholesky-factorised ERIs.

Counterpart of ``pauxy_tpu/models/generic.py``. The two-electron integrals
enter as Cholesky vectors L with (ik|jl) = sum_x L[i,k,x] L[j,l,x], one
auxiliary field per vector. Built host-side with numpy (setup) and held as
module buffers: ``H1`` and ``h1e_mod`` [2, M, M], ``chol`` [M, M, X] at
their natural type (real for molecular data). The exact-ERI, PNO and
stochastic-RI energy variants are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config


class Generic(nn.Module):
    """Ab-initio Hamiltonian: ``H1``, ``h1e_mod`` = H1 - v0 and ``chol``."""

    name = "Generic"

    def __init__(self, H1, h1e_mod, chol, *, ecore: float, nup: int,
                 ndown: int):
        super().__init__()
        self.register_buffer("H1", H1)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("chol", chol)
        self.ecore = float(ecore)
        self.nup = int(nup)
        self.ndown = int(ndown)

    @property
    def nbasis(self) -> int:
        return self.H1.shape[-1]

    @property
    def nchol(self) -> int:
        return self.chol.shape[-1]

    @property
    def nfields(self) -> int:
        return self.chol.shape[-1]


def construct_h1e_mod(h1e: np.ndarray, chol: np.ndarray) -> np.ndarray:
    """h1e_mod = H1 - v0, v0_ij = 0.5 sum_{k x} L[i,k,x] L[j,k,x], as one
    [M, M X] x [M X, M] product."""
    m = chol.shape[0]
    flat = chol.reshape(m, -1)
    v0 = 0.5 * (flat @ flat.T)
    return np.stack([h1e[0] - v0, h1e[1] - v0])


def make_generic(nelec: tuple[int, int], h1e: np.ndarray, chol: np.ndarray,
                 ecore: float = 0.0, *, exact_eri: bool = False,
                 stochastic_ri: bool = False, pno: bool = False,
                 device=None, dtype=None) -> Generic:
    """Build a Generic system on ``device`` at precision ``dtype``.

    ``h1e``: [M, M] (spin-restricted) or [2, M, M]; ``chol``: [M, M, X] or
    flat [M*M, X] (the reference's layout). Real data stays real.
    """
    variants = {"exact_eri": exact_eri, "stochastic_ri": stochastic_ri,
                "pno": pno}
    if any(variants.values()):
        raise NotImplementedError(
            "not ported yet for Generic: "
            + ", ".join(k for k, v in variants.items() if v))
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    h1e = np.asarray(h1e)
    if h1e.ndim == 2:
        h1e = np.stack([h1e, h1e])
    m = h1e.shape[-1]
    chol = np.asarray(chol)
    if chol.ndim == 2:
        chol = chol.reshape(m, m, -1)
    np_dtype = (prec.np_cplx if np.iscomplexobj(h1e) or np.iscomplexobj(chol)
                else prec.np_real)
    h1e = np.ascontiguousarray(h1e.astype(np_dtype))
    chol = np.ascontiguousarray(chol.astype(np_dtype))
    h1e_mod = construct_h1e_mod(h1e, chol).astype(np_dtype)
    return Generic(torch.from_numpy(h1e).to(device),
                   torch.from_numpy(h1e_mod).to(device),
                   torch.from_numpy(chol).to(device),
                   ecore=ecore, nup=nelec[0], ndown=nelec[1])
