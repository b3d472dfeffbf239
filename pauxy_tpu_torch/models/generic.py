"""Generic ab-initio Hamiltonian from Cholesky-factorised ERIs.

Counterpart of ``pauxy_tpu/models/generic.py``. The two-electron integrals
enter as Cholesky vectors L with (ik|jl) = sum_x L[i,k,x] L[j,l,x], one
auxiliary field per vector. Built host-side with numpy (setup) and held as
module buffers: ``H1`` and ``h1e_mod`` [2, M, M], ``chol`` [M, M, X] at
their natural type (real for molecular data). The local-energy variant
flags are JAX's: ``exact_eri`` (the half-rotated four-index ERIs),
``stochastic_ri`` with ``nsamples`` Rademacher probes and an optional
``control_variate`` (the exchange estimated), ``pno`` with ``thresh_pno``
(the pair ERIs truncated by SVD); the trial builds their tensors.
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
                 ndown: int, exact_eri: bool = False,
                 stochastic_ri: bool = False, nsamples: int = 0,
                 control_variate: bool = False, pno: bool = False,
                 thresh_pno: float = 0.0):
        super().__init__()
        self.register_buffer("H1", H1)
        self.register_buffer("h1e_mod", h1e_mod)
        self.register_buffer("chol", chol)
        self.ecore = float(ecore)
        self.nup = int(nup)
        self.ndown = int(ndown)
        self.exact_eri = bool(exact_eri)
        self.stochastic_ri = bool(stochastic_ri)
        self.nsamples = int(nsamples)
        self.control_variate = bool(control_variate)
        self.pno = bool(pno)
        self.thresh_pno = float(thresh_pno or 0.0)

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
                 stochastic_ri: bool = False, nsamples: int = 0,
                 control_variate: bool = False, pno: bool = False,
                 thresh_pno: float = 0.0, device=None,
                 dtype=None) -> Generic:
    """Build a Generic system on ``device`` at precision ``dtype``.

    ``h1e``: [M, M] (spin-restricted) or [2, M, M]; ``chol``: [M, M, X] or
    flat [M*M, X] (the reference's layout). Real data stays real.
    Stochastic RI needs ``nsamples`` > 0, PNO ``thresh_pno`` > 0.
    """
    if stochastic_ri and nsamples <= 0:
        raise ValueError("stochastic_ri needs nsamples > 0")
    if pno and not thresh_pno:
        raise ValueError("pno needs thresh_pno > 0")
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
                   ecore=ecore, nup=nelec[0], ndown=nelec[1],
                   exact_eri=exact_eri, stochastic_ri=stochastic_ri,
                   nsamples=nsamples, control_variate=control_variate,
                   pno=pno, thresh_pno=thresh_pno)


def from_qmcpack_file(filename: str, nelec=None, *, device=None,
                      dtype=None, **variant) -> Generic:
    """Load a Generic system from a QMCPACK-format HDF5 integral file
    (dense or sparse factorised) onto ``device`` at precision ``dtype``;
    ``nelec`` overrides the file's electron counts, ``variant`` takes
    ``make_generic``'s local-energy variant flags."""
    from pauxy_tpu_torch.utils import qmcpack

    h1e, chol, ecore, nelec_file = qmcpack.read_hamiltonian(filename)
    if nelec is None:
        nelec = nelec_file
    if nelec is None:
        raise ValueError("electron count not in file; pass nelec=")
    return make_generic(nelec, h1e, chol, ecore, device=device, dtype=dtype,
                        **variant)
