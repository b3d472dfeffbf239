"""Build the port's objects from the JAX package's, given as numpy arrays.

The parity tests hand both packages identical inputs: they read the JAX
objects' fields with ``np.asarray`` and pass them here. Nothing here
imports jax. Like every constructor of the port, ``device=None`` means the
CUDA card (``config.resolve_device``); the CPU must be asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models.generic import Generic
from pauxy_tpu_torch.models.hubbard import Hubbard, band_energies
from pauxy_tpu_torch.models.thermal_trial import OneBodyTrial
from pauxy_tpu_torch.models.trial import SingleDetTrial, trial_density_matrix
from pauxy_tpu_torch.models.ueg import UEG
from pauxy_tpu_torch.ops import ueg_sparse
from pauxy_tpu_torch.propagation.generic import GenericContinuous
from pauxy_tpu_torch.propagation.hirsch import Hirsch
from pauxy_tpu_torch.propagation.hubbard import HubbardContinuous
from pauxy_tpu_torch.propagation.thermal import (ThermalContinuous,
                                                 ThermalHubbardInner,
                                                 ThermalUEGInner)
from pauxy_tpu_torch.walkers.state import WalkerState
from pauxy_tpu_torch.walkers.thermal_state import ThermalWalkerState


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def hubbard(T, U: float, symmetric: bool, *, nx: int, ny: int, nup: int,
            ndown: int, t: float = 1.0, device=None) -> Hubbard:
    """Hubbard from its hopping matrix T [2, M, M]; h1e_mod = T - U/2
    unless symmetric, as in ``make_hubbard``."""
    device = config.resolve_device(device)
    T = np.asarray(T)
    h1e_mod = T if symmetric else (T - 0.5 * U * np.eye(T.shape[-1])[None]
                                   ).astype(T.dtype)
    eks = band_energies(t, nx, ny).astype(np.real(T).dtype)
    return Hubbard(_t(T, device), _t(h1e_mod, device), _t(eks, device),
                   U=U, t=t, nx=nx, ny=ny, nup=nup, ndown=ndown,
                   symmetric=symmetric)


def generic(H1, h1e_mod, chol, *, ecore: float, nup: int, ndown: int,
            device=None) -> Generic:
    """Generic Hamiltonian from H1, h1e_mod [2, M, M] and chol [M, M, X]."""
    device = config.resolve_device(device)
    return Generic(_t(H1, device), _t(h1e_mod, device), _t(chol, device),
                   ecore=ecore, nup=nup, ndown=ndown)


def trial(psia, psib, etrial: float, *, name: str = "single_det",
          device=None, **generic) -> SingleDetTrial:
    """Single-determinant trial from orbitals psia [M, na], psib [M, nb];
    for a Generic system also its half-rotated tensors (``rchola``,
    ``rcholb``, ``rh1a``, ``rh1b`` and, when the trial has them,
    ``exx_supera``/``exx_superb``; None entries are skipped)."""
    device = config.resolve_device(device)
    psia = np.asarray(psia)
    psib = np.asarray(psib)
    tensors = {k: _t(v, device) for k, v in generic.items()
               if v is not None}
    return SingleDetTrial(_t(psia, device), _t(psib, device),
                          G_host=trial_density_matrix(psia, psib),
                          etrial=etrial, name=name, **tensors)


def generic_continuous(BH1, mf_shift, chol, *, dt: float, exp_order: int = 6,
                       taylor_impl: str | None = None,
                       device=None) -> GenericContinuous:
    """Generic propagator from the JAX one's BH1 [2, M, M], mf_shift [X]
    and chol [M, M, X]."""
    device = config.resolve_device(device)
    return GenericContinuous(_t(BH1, device), _t(mf_shift, device),
                             _t(chol, device), dt=dt, exp_order=exp_order,
                             taylor_impl=taylor_impl)


def hubbard_continuous(BH1, mf_shift, *, dt: float, U: float, charge: bool,
                       device=None) -> HubbardContinuous:
    device = config.resolve_device(device)
    return HubbardContinuous(_t(BH1, device), _t(mf_shift, device), dt=dt,
                             U=U, charge=charge)


def hirsch(BT2, auxf, aux_wfac, *, dt: float, charge: bool, gamma: complex,
           sweep_kernel: str, device=None) -> Hirsch:
    """Hirsch propagator from the JAX one's tables BT2 [2, M, M],
    auxf [2, 2] and aux_wfac [2]."""
    device = config.resolve_device(device)
    return Hirsch(_t(BT2, device), _t(auxf, device), _t(aux_wfac, device),
                  dt=dt, charge=charge, gamma=gamma,
                  sweep_kernel=sweep_kernel)


def walker_state(*, phia, phib, weight, unscaled_weight, log_ovlp,
                 hybrid_energy, log_detr, total_weight, device=None
                 ) -> WalkerState:
    """WalkerState from the JAX state's fields ([w, M, n] layout)."""
    device = config.resolve_device(device)
    rdtype = config.real_dtype(_t(log_ovlp, "cpu").dtype)
    return WalkerState(
        phia=_t(phia, device),
        phib=_t(phib, device),
        weight=_t(weight, device),
        unscaled_weight=_t(unscaled_weight, device),
        log_ovlp=_t(log_ovlp, device),
        hybrid_energy=_t(hybrid_energy, device),
        log_detr=_t(log_detr, device),
        total_weight=torch.tensor(float(np.asarray(total_weight)),
                                  dtype=rdtype, device=device),
    )


def ueg(H1, h1e_mod, kpq_idx, kpq_mask, pmq_idx, pmq_mask, vqvec, *, basis,
        qvecs, rs: float, ecut: float, vol: float, kfac: float,
        ecore: float, nup: int, ndown: int, device=None) -> UEG:
    """UEG from the JAX system's tables ([nq, M] gather maps as integers
    and masks, vqvec [nq]) and its host basis and q vectors."""
    device = config.resolve_device(device)
    return UEG(_t(H1, device), _t(h1e_mod, device),
               _t(np.asarray(kpq_idx).astype(np.int64), device),
               _t(np.asarray(kpq_mask).astype(bool), device),
               _t(np.asarray(pmq_idx).astype(np.int64), device),
               _t(np.asarray(pmq_mask).astype(bool), device),
               _t(vqvec, device), basis=np.asarray(basis),
               qvecs=np.asarray(qvecs), rs=rs, ecut=ecut, vol=vol,
               kfac=kfac, ecore=ecore, nup=nup, ndown=ndown)


def one_body_trial(dmat, dmat_inv, left_table, bin_full, *, mu: float,
                   beta: float, dt: float, num_slices: int, stack_size: int,
                   nav: float, P_host, G_host, device=None) -> OneBodyTrial:
    """One-body thermal trial from the JAX trial's tensors and host 1-RDM
    and Green's function."""
    device = config.resolve_device(device)
    return OneBodyTrial(_t(dmat, device), _t(dmat_inv, device),
                        _t(left_table, device), _t(bin_full, device),
                        mu=mu, beta=beta, dt=dt, num_slices=num_slices,
                        stack_size=stack_size, nav=nav,
                        P_host=np.asarray(P_host), G_host=np.asarray(G_host))


def thermal_propagator(inner: str, BH1, mf_shift, *, dt: float,
                       mf_const_fac: complex, U: float | None = None,
                       ham: UEG | None = None, force_bias: bool = True,
                       fb_bound: float = 1.0, free_projection: bool = False,
                       device=None) -> ThermalContinuous:
    """Thermal propagator from the JAX one's BH1 [2, M, M], mf_shift and
    constants; ``inner`` "hubbard" (with U) or "ueg" (with the port's UEG
    on ``device``, whose gather metadata is rebuilt here as JAX builds
    it)."""
    device = config.resolve_device(device)
    bh1, shift = _t(BH1, device), _t(mf_shift, device)
    if inner == "hubbard":
        inn = ThermalHubbardInner(bh1, shift, dt=dt, U=U)
    elif inner == "ueg":
        inn = ThermalUEGInner(bh1, shift, ueg_sparse.make_sparse_rho(
            ham, config.real_dtype(bh1.dtype)), dt=dt)
    else:
        raise ValueError(f"unknown thermal inner {inner!r}")
    return ThermalContinuous(inn, dt=dt, mf_const_fac=mf_const_fac,
                             force_bias=force_bias, fb_bound=fb_bound,
                             free_projection=free_projection)


def thermal_walker_state(*, stack, right, G, log_m0, weight, unscaled_weight,
                         phase, total_weight, hybrid_energy, pq, pd, pt,
                         device=None) -> ThermalWalkerState:
    """ThermalWalkerState from the JAX state's fields."""
    device = config.resolve_device(device)
    rdtype = config.real_dtype(_t(log_m0, "cpu").dtype)
    return ThermalWalkerState(
        stack=_t(stack, device), right=_t(right, device), G=_t(G, device),
        log_m0=_t(log_m0, device), weight=_t(weight, device),
        unscaled_weight=_t(unscaled_weight, device),
        phase=_t(phase, device),
        total_weight=torch.tensor(float(np.asarray(total_weight)),
                                  dtype=rdtype, device=device),
        hybrid_energy=_t(hybrid_energy, device), pq=_t(pq, device),
        pd=_t(pd, device), pt=_t(pt, device))
