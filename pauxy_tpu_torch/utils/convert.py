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
from pauxy_tpu_torch.models.ghf import GHFTrial
from pauxy_tpu_torch.models.hubbard import Hubbard, band_energies
from pauxy_tpu_torch.models.hubbard_holstein import HubbardHolstein
from pauxy_tpu_torch.models.multi_coherent import MultiCoherentTrial
from pauxy_tpu_torch.models.multi_slater import MultiSlaterTrial
from pauxy_tpu_torch.models.thermal_trial import OneBodyTrial
from pauxy_tpu_torch.models.trial import SingleDetTrial, trial_density_matrix
from pauxy_tpu_torch.models.pw_fft import PWFFT
from pauxy_tpu_torch.models.ueg import UEG, fft_maps
from pauxy_tpu_torch.ops import ueg_sparse
from pauxy_tpu_torch.propagation.generic import GenericContinuous
from pauxy_tpu_torch.propagation.hirsch import Hirsch
from pauxy_tpu_torch.propagation.hirsch_dmc import HirschDMC
from pauxy_tpu_torch.propagation.hubbard import HubbardContinuous
from pauxy_tpu_torch.propagation.planewave import PlaneWave
from pauxy_tpu_torch.propagation.pw_fft import PWFFTInner
from pauxy_tpu_torch.propagation.thermal import (ThermalContinuous,
                                                 ThermalGenericInner,
                                                 ThermalHubbardInner,
                                                 ThermalUEGInner)
from pauxy_tpu_torch.propagation.thermal_discrete import ThermalDiscrete
from pauxy_tpu_torch.walkers.low_rank import LowRankWalkerState
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


def hubbard_holstein(T, U: float, *, g: float, w0: float, m: float,
                     lmbda: float, nx: int, ny: int, nup: int, ndown: int,
                     t: float = 1.0, device=None) -> HubbardHolstein:
    """Hubbard-Holstein system from its hopping matrix T [2, M, M]."""
    device = config.resolve_device(device)
    T = np.asarray(T)
    h1e_mod = (T - 0.5 * U * np.eye(T.shape[-1])[None]).astype(T.dtype)
    eks = band_energies(t, nx, ny).astype(T.dtype)
    return HubbardHolstein(_t(T, device), _t(h1e_mod, device),
                           _t(eks, device), U=U, t=t, g=g, w0=w0, m=m,
                           lmbda=lmbda, nx=nx, ny=ny, nup=nup, ndown=ndown)


def generic(H1, h1e_mod, chol, *, ecore: float, nup: int, ndown: int,
            device=None, **variants) -> Generic:
    """Generic Hamiltonian from H1, h1e_mod [2, M, M] and chol [M, M, X];
    ``variants`` the local-energy flags (``exact_eri``, ``stochastic_ri``,
    ``nsamples``, ``control_variate``, ``pno``, ``thresh_pno``)."""
    device = config.resolve_device(device)
    return Generic(_t(H1, device), _t(h1e_mod, device), _t(chol, device),
                   ecore=ecore, nup=nup, ndown=ndown, **variants)


def trial(psia, psib, etrial: float, *, name: str = "single_det",
          shift=None, e0_terms=None, device=None,
          **generic) -> SingleDetTrial:
    """Single-determinant trial from orbitals psia [M, na], psib [M, nb];
    a Hubbard-Holstein trial's phonon ``shift`` [M]; for a Generic system
    also its half-rotated tensors (``rchola``, ``rcholb``, ``rh1a``,
    ``rh1b`` and, when the trial has them, ``exx_supera``/``exx_superb``,
    the variants' ``eri_*``, ``ghalf0*``, the PNO channels ``pno_*`` (tuples
    of arrays) and ``e0_terms``; None entries are skipped)."""
    device = config.resolve_device(device)
    psia = np.asarray(psia)
    psib = np.asarray(psib)
    tensors = {k: (tuple(_t(a, device) for a in v) if isinstance(v, tuple)
                   else _t(v, device))
               for k, v in generic.items() if v is not None}
    return SingleDetTrial(_t(psia, device), _t(psib, device),
                          G_host=trial_density_matrix(psia, psib),
                          etrial=etrial, name=name,
                          shift=None if shift is None else _t(shift, device),
                          e0_terms=e0_terms, **tensors)


def multi_coherent_trial(psi, shifts, coeffs, inita, initb, shift, *,
                         nup: int, m: float, w0: float, etrial: float,
                         device=None) -> MultiCoherentTrial:
    """Multi-coherent trial from the JAX one's psi [P, M, na + nb], shifts
    [P, M], coeffs [P], initial walker and leading shift [M]."""
    device = config.resolve_device(device)
    return MultiCoherentTrial(_t(psi, device), _t(shifts, device),
                              _t(coeffs, device), _t(inita, device),
                              _t(initb, device), _t(shift, device), nup=nup,
                              m=m, w0=w0, etrial=etrial)


def multi_slater_trial(psia, psib, coeffs, inita, initb, *, G_host,
                       etrial: float, device=None,
                       **generic) -> MultiSlaterTrial:
    """Multi-determinant trial from the JAX one's psia [D, M, na], psib
    [D, M, nb], coeffs [D], initial walker inita / initb and host density
    matrix G_host [2, M, M]; for a Generic system also its per-determinant
    ``rchola``, ``rcholb``, ``rh1a``, ``rh1b`` (None entries skipped)."""
    device = config.resolve_device(device)
    tensors = {k: _t(v, device) for k, v in generic.items()
               if v is not None}
    return MultiSlaterTrial(_t(psia, device), _t(psib, device),
                            _t(coeffs, device), _t(inita, device),
                            _t(initb, device), G_host=np.asarray(G_host),
                            etrial=etrial, **tensors)


def ghf_trial(psi, coeffs, inita, initb, *, etrial: float,
              device=None) -> GHFTrial:
    """GHF trial from the JAX one's psi [D, 2M, ne], coeffs [D] and
    initial block-diagonal walker inita [M, nup] / initb [M, ndown]."""
    device = config.resolve_device(device)
    return GHFTrial(_t(psi, device), _t(coeffs, device), _t(inita, device),
                    _t(initb, device), etrial=etrial)


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
           sweep_kernel: str, free_projection: bool = False,
           two_body_mode: str = "single_site", btk=None, nx: int = 0,
           ny: int = 0, device=None) -> Hirsch:
    """Hirsch propagator from the JAX one's tables BT2 [2, M, M],
    auxf [2, 2] and aux_wfac [2], and for ``kinetic_kspace`` its
    momentum-space half step btk [ny, nx]."""
    device = config.resolve_device(device)
    return Hirsch(_t(BT2, device), _t(auxf, device), _t(aux_wfac, device),
                  dt=dt, charge=charge, gamma=gamma,
                  sweep_kernel=sweep_kernel, free_projection=free_projection,
                  two_body_mode=two_body_mode,
                  btk=None if btk is None else _t(btk, device), nx=nx, ny=ny)


def hirsch_dmc(hirsch: Hirsch, BT_half, *, dt: float, m: float, w0: float,
               cpl: float, eshift_boson: float,
               symmetric_trotter: bool = False, device=None) -> HirschDMC:
    """Hubbard-Holstein propagator from a port ``Hirsch`` (``hirsch``
    above, from the JAX one's tables) and the JAX one's BT_half
    [2, M, M]."""
    device = config.resolve_device(device)
    return HirschDMC(hirsch, _t(BT_half, device), dt=dt, m=m, w0=w0,
                     cpl=cpl, eshift_boson=eshift_boson,
                     symmetric_trotter=symmetric_trotter)


# The optional back-propagation / ITCF buffers of a walker state.
HISTORY_FIELDS = ("configs", "cos_fac", "weight_fac", "phia_old", "phib_old",
                  "phia_right", "phib_right")


def walker_state(*, phia, phib, weight, unscaled_weight, log_ovlp,
                 hybrid_energy, log_detr, total_weight, phase=None,
                 eloc=None, X=None, device=None, **history) -> WalkerState:
    """WalkerState from the JAX state's fields ([w, M, n] layout). The
    phase defaults to 1 and the local energy to 0 (a fresh state's); X
    [w, M] is a Hubbard-Holstein walker's phonon coordinates; ``history``
    takes the buffers of ``HISTORY_FIELDS`` (None skipped)."""
    device = config.resolve_device(device)
    unknown = set(history) - set(HISTORY_FIELDS)
    if unknown:
        raise TypeError(f"unknown walker fields {sorted(unknown)}")
    log_ovlp = _t(log_ovlp, device)
    rdtype = config.real_dtype(log_ovlp.dtype)
    return WalkerState(
        phia=_t(phia, device),
        phib=_t(phib, device),
        weight=_t(weight, device),
        unscaled_weight=_t(unscaled_weight, device),
        log_ovlp=log_ovlp,
        hybrid_energy=_t(hybrid_energy, device),
        log_detr=_t(log_detr, device),
        total_weight=torch.tensor(float(np.asarray(total_weight)),
                                  dtype=rdtype, device=device),
        phase=(torch.ones_like(log_ovlp) if phase is None
               else _t(phase, device)),
        eloc=(torch.zeros_like(log_ovlp) if eloc is None
              else _t(eloc, device)),
        X=None if X is None else _t(X, device),
        **{k: _t(v, device) for k, v in history.items() if v is not None},
    )


def ueg(H1, h1e_mod, kpq_idx, kpq_mask, pmq_idx, pmq_mask, vqvec, *, basis,
        qvecs, rs: float, ecut: float, vol: float, kfac: float,
        ecore: float, nup: int, ndown: int, gmap=None, qmap=None,
        qmesh=None, device=None) -> UEG:
    """UEG from the JAX system's tables ([nq, M] gather maps as integers
    and masks, vqvec [nq]), its host basis and q vectors, and its FFT-cube
    maps ``gmap`` [M], ``qmap`` [nq] on ``qmesh`` (derived from the basis,
    the q vectors and ecut, as ``make_ueg`` derives them, when not
    given)."""
    device = config.resolve_device(device)
    if gmap is None:
        nmax = int(np.ceil(np.sqrt(2 * ecut)))
        gmap, qmap, qmesh = fft_maps(np.asarray(basis), np.asarray(qvecs),
                                     nmax)
    return UEG(_t(H1, device), _t(h1e_mod, device),
               _t(np.asarray(kpq_idx).astype(np.int64), device),
               _t(np.asarray(kpq_mask).astype(bool), device),
               _t(np.asarray(pmq_idx).astype(np.int64), device),
               _t(np.asarray(pmq_mask).astype(bool), device),
               _t(vqvec, device), basis=np.asarray(basis),
               qvecs=np.asarray(qvecs), rs=rs, ecut=ecut, vol=vol,
               kfac=kfac, ecore=ecore, nup=nup, ndown=ndown,
               gmap=_t(np.asarray(gmap).astype(np.int64), device),
               qmap=_t(np.asarray(qmap).astype(np.int64), device),
               qmesh=tuple(qmesh))


def planewave(BH1, *, ham: UEG, dt: float, exp_order: int = 6,
              taylor_impl: str | None = "xla", device=None) -> PlaneWave:
    """The UEG propagator from the JAX one's BH1 [2, M] diagonal, with the
    port's UEG ``ham`` on ``device`` (its gather metadata rebuilt as JAX
    builds it, its FFT-cube maps when it has them)."""
    device = config.resolve_device(device)
    bh1 = _t(BH1, device)
    fft = {}
    if ham.gmap is not None:
        fft = dict(gmap=ham.gmap.to(device), qmap_fft=ham.qmap.to(device),
                   qmesh=ham.qmesh)
    return PlaneWave(bh1, torch.zeros(2 * ham.nq, dtype=bh1.dtype,
                                      device=device),
                     ueg_sparse.make_sparse_rho(
                         ham, config.real_dtype(bh1.dtype)).to(device),
                     dt=dt, exp_order=exp_order,
                     taylor_impl=taylor_impl, **fft)


def pw_fft_system(sp_eigv, h1e_mod, vqvec, gmap, qmap, *, basis, qvecs,
                  qmesh, rs: float, ecut: float, vol: float, kfac: float,
                  ecore: float, nup: int, ndown: int, nmax: int,
                  device=None) -> PWFFT:
    """PW_FFT from the JAX system's diagonal one-body terms [M], vqvec
    [nq], cube maps and host basis and q vectors."""
    device = config.resolve_device(device)
    return PWFFT(_t(sp_eigv, device), _t(h1e_mod, device), _t(vqvec, device),
                 _t(np.asarray(gmap).astype(np.int64), device),
                 _t(np.asarray(qmap).astype(np.int64), device),
                 basis=np.asarray(basis), qvecs=np.asarray(qvecs),
                 qmesh=tuple(qmesh), rs=rs, ecut=ecut, vol=vol, kfac=kfac,
                 ecore=ecore, nup=nup, ndown=ndown, nmax=nmax)


def pw_fft_inner(BH1, vqfac, vq_sqrtdt, gmap, qmap, ct_f_a, ct_if_a, ct_f_b,
                 ct_if_b, *, qmesh, sqrt_dt: float, exp_order: int = 6,
                 device=None) -> PWFFTInner:
    """The PW_FFT inner propagator from the JAX one's tensors."""
    device = config.resolve_device(device)
    bh1 = _t(BH1, device)
    return PWFFTInner(
        bh1, torch.zeros(2 * np.asarray(qmap).shape[0], dtype=bh1.dtype,
                         device=device),
        _t(vqfac, device), _t(vq_sqrtdt, device),
        _t(np.asarray(gmap).astype(np.int64), device),
        _t(np.asarray(qmap).astype(np.int64), device),
        *(_t(x, device) for x in (ct_f_a, ct_if_a, ct_f_b, ct_if_b)),
        qmesh=qmesh, sqrt_dt=sqrt_dt, exp_order=exp_order)


def one_body_trial(dmat, dmat_inv, left_table, bin_full, *, mu: float,
                   beta: float, dt: float, num_slices: int, stack_size: int,
                   nav: float, P_host, G_host, name: str = "one_body",
                   device=None) -> OneBodyTrial:
    """Thermal trial (one-body or mean-field, by ``name``) from the JAX
    trial's tensors and host 1-RDM and Green's function."""
    device = config.resolve_device(device)
    return OneBodyTrial(_t(dmat, device), _t(dmat_inv, device),
                        _t(left_table, device), _t(bin_full, device),
                        mu=mu, beta=beta, dt=dt, num_slices=num_slices,
                        stack_size=stack_size, nav=nav,
                        P_host=np.asarray(P_host), G_host=np.asarray(G_host),
                        name=name)


def thermal_propagator(inner: str, BH1, mf_shift, *, dt: float,
                       mf_const_fac: complex, U: float | None = None,
                       ham: UEG | None = None, chol=None,
                       force_bias: bool = True, fb_bound: float = 1.0,
                       free_projection: bool = False, low_rank: bool = False,
                       low_rank_thresh: float = 1e-6,
                       device=None) -> ThermalContinuous:
    """Thermal propagator from the JAX one's BH1 [2, M, M], mf_shift and
    constants; ``inner`` "hubbard" (with U), "generic" (with its complex
    chol [M, M, X]) or "ueg" (with the port's UEG on ``device``, whose
    gather metadata is rebuilt here as JAX builds it)."""
    device = config.resolve_device(device)
    bh1, shift = _t(BH1, device), _t(mf_shift, device)
    if inner == "hubbard":
        inn = ThermalHubbardInner(bh1, shift, dt=dt, U=U)
    elif inner == "generic":
        inn = ThermalGenericInner(bh1, shift, _t(chol, device), dt=dt)
    elif inner == "ueg":
        inn = ThermalUEGInner(bh1, shift, ueg_sparse.make_sparse_rho(
            ham, config.real_dtype(bh1.dtype)), dt=dt)
    else:
        raise ValueError(f"unknown thermal inner {inner!r}")
    return ThermalContinuous(inn, dt=dt, mf_const_fac=mf_const_fac,
                             force_bias=force_bias, fb_bound=fb_bound,
                             free_projection=free_projection,
                             low_rank=low_rank,
                             low_rank_thresh=low_rank_thresh)


def thermal_discrete(BH1, BH1_inv, auxf, aux_wfac, delta, *, dt: float,
                     charge: bool, free_projection: bool,
                     wrap_stabilize: int, device=None) -> ThermalDiscrete:
    """Discrete thermal propagator from the JAX one's tables."""
    device = config.resolve_device(device)
    return ThermalDiscrete(_t(BH1, device), _t(BH1_inv, device),
                           _t(auxf, device), _t(aux_wfac, device),
                           _t(delta, device), dt=dt, charge=charge,
                           free_projection=free_projection,
                           wrap_stabilize=wrap_stabilize)


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


def low_rank_walker_state(*, Qr, Dr, Tr, Dl, G, log_ovlp, weight,
                          unscaled_weight, phase, total_weight, hybrid_energy,
                          device=None) -> LowRankWalkerState:
    """LowRankWalkerState from the JAX state's fields."""
    device = config.resolve_device(device)
    rdtype = config.real_dtype(_t(log_ovlp, "cpu").dtype)
    return LowRankWalkerState(
        Qr=_t(Qr, device), Dr=_t(Dr, device), Tr=_t(Tr, device),
        Dl=_t(Dl, device), G=_t(G, device), log_ovlp=_t(log_ovlp, device),
        weight=_t(weight, device),
        unscaled_weight=_t(unscaled_weight, device), phase=_t(phase, device),
        total_weight=torch.tensor(float(np.asarray(total_weight)),
                                  dtype=rdtype, device=device),
        hybrid_energy=_t(hybrid_energy, device))
