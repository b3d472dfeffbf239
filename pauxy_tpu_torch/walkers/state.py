"""Struct-of-arrays walker state.

Counterpart of ``pauxy_tpu/walkers/state.py``: the whole population is one
dataclass of tensors with a leading walker axis, whatever the trial (a
multi-determinant, GHF or multi-coherent trial changes only the
overlaps). A Hubbard-Holstein walker also carries its phonon coordinates
X [w, M]. The
back-propagation / ITCF buffers (the auxiliary-field history and the
historic wavefunctions) are optional and ride along as [w, ...] fields, so
population control moves them with their walkers.
"""

from __future__ import annotations

import dataclasses

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import ghf
from pauxy_tpu_torch.models import hubbard_holstein as hh
from pauxy_tpu_torch.models import multi_coherent as mcoh
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.ops import greens


@dataclasses.dataclass
class WalkerState:
    phia: torch.Tensor             # [w, M, na] alpha Slater matrices
    phib: torch.Tensor             # [w, M, nb] beta Slater matrices
    weight: torch.Tensor           # [w] real walker weights
    unscaled_weight: torch.Tensor  # [w] real, pre-pop-control weights
    log_ovlp: torch.Tensor         # [w] complex log <psi_T|phi>
    hybrid_energy: torch.Tensor    # [w] complex hybrid energy of last step
    log_detr: torch.Tensor         # [w] real accumulated log det R
    total_weight: torch.Tensor     # [] real global weight (pop control)
    phase: torch.Tensor | None = None  # [w] complex phase (free projection)
    eloc: torch.Tensor | None = None   # [w] complex local energy, last step
    # Auxiliary-field history for back propagation / ITCF.
    configs: torch.Tensor | None = None     # [w, nprop_tot, nfields] complex
    cos_fac: torch.Tensor | None = None     # [w, nprop_tot] real
    weight_fac: torch.Tensor | None = None  # [w, nprop_tot] complex
    phia_old: torch.Tensor | None = None    # [w, M, na] historic wfn (BP)
    phib_old: torch.Tensor | None = None
    phia_right: torch.Tensor | None = None  # [w, M, na] snapshot (ITCF)
    phib_right: torch.Tensor | None = None
    X: torch.Tensor | None = None           # [w, M] phonon coordinates (HH)

    @property
    def nwalkers(self) -> int:
        return self.phia.shape[0]

    @property
    def nbasis(self) -> int:
        return self.phia.shape[1]


def init_walkers(trial, nwalkers: int, total_weight: float | None = None,
                 nprop_tot: int | None = None, nfields: int | None = None,
                 itcf: bool = False, phonon_mw: float | None = None,
                 generator: torch.Generator | None = None,
                 X0: torch.Tensor | None = None) -> WalkerState:
    """All walkers start as the trial's initial determinant, weight 1,
    phase 1.

    A trial with a phonon ``shift`` (Hubbard-Holstein) gives the walkers
    coordinates X: ``X0`` [w, M] when given, else drawn from
    |phi_B(X)|^2 = Normal(shift, 1 / (2 phonon_mw)), phonon_mw = m w0,
    with ``generator``. A multi-coherent trial's log-overlap is its
    mixture's at X.

    ``total_weight`` seeds the 10% weight cap before the first population
    control (the target weight by default). The log-overlaps go through
    ``clinalg.slogdet``: kernel B on the card; a multi-determinant or GHF
    trial's are its log-sum-exp over determinants. With ``nprop_tot`` the
    back-propagation buffers are added (fields zero, factors one, the
    historic wavefunction the initial one), with ``itcf`` also the ITCF
    snapshot.
    """
    inita, initb = trial.inita, trial.initb
    phia = inita[None].expand((nwalkers,) + tuple(inita.shape)).contiguous()
    phib = initb[None].expand((nwalkers,) + tuple(initb.shape)).contiguous()
    cdtype = inita.dtype
    rdtype = config.real_dtype(cdtype)
    dev = inita.device
    x0 = None
    if hh.carries_phonons(trial) and (
            X0 is not None or phonon_mw is not None):
        if X0 is not None:
            x0 = X0.to(device=dev, dtype=rdtype)
        else:
            sigma = (2.0 * phonon_mw) ** -0.5
            x0 = trial.shift[None, :].to(rdtype) + sigma * torch.randn(
                (nwalkers, trial.shift.shape[0]), generator=generator,
                dtype=rdtype, device=dev)
    if isinstance(trial, mcoh.MultiCoherentTrial):
        log_o = mcoh.mc_log_overlap(trial, phia, phib, x0)
    elif isinstance(trial, ghf.GHFTrial):
        log_o = ghf.ghf_log_overlap(trial, phia, phib)
    elif isinstance(trial, msd.MultiSlaterTrial):
        log_o = msd.log_overlap_multi_det(trial, phia, phib)
    else:
        log_o = (greens.log_overlap(phia, trial.psia)
                 + greens.log_overlap(phib, trial.psib))
    if total_weight is None:
        total_weight = float(nwalkers)
    extras = {}
    if nprop_tot is not None:
        extras = dict(
            configs=torch.zeros((nwalkers, nprop_tot, nfields), dtype=cdtype,
                                device=dev),
            cos_fac=torch.ones((nwalkers, nprop_tot), dtype=rdtype,
                               device=dev),
            weight_fac=torch.ones((nwalkers, nprop_tot), dtype=cdtype,
                                  device=dev),
            phia_old=phia, phib_old=phib)
        if itcf:
            extras.update(phia_right=phia, phib_right=phib)
    return WalkerState(
        phia=phia,
        phib=phib,
        weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        unscaled_weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        log_ovlp=log_o,
        hybrid_energy=torch.zeros(nwalkers, dtype=cdtype, device=dev),
        log_detr=torch.zeros(nwalkers, dtype=rdtype, device=dev),
        total_weight=torch.tensor(float(total_weight), dtype=rdtype,
                                  device=dev),
        phase=torch.ones(nwalkers, dtype=cdtype, device=dev),
        eloc=torch.zeros(nwalkers, dtype=cdtype, device=dev),
        X=x0,
        **extras,
    )


def orthogonalise(state: WalkerState, free_projection: bool = False
                  ) -> WalkerState:
    """CholeskyQR2 re-orthogonalisation of the whole population. Phaseless:
    the overlap absorbs det R. Free projection: |det R| (real positive by
    construction) multiplies the weight and the overlap is left as it is,
    as in JAX."""
    phia, log_ra = greens.reortho(state.phia)
    phib, log_rb = greens.reortho(state.phib)
    log_r = log_ra + log_rb
    if free_projection:
        return dataclasses.replace(
            state, phia=phia, phib=phib,
            weight=state.weight * torch.exp(log_r),
            log_detr=state.log_detr + log_r)
    return dataclasses.replace(
        state,
        phia=phia,
        phib=phib,
        log_ovlp=state.log_ovlp - log_r.to(state.log_ovlp.dtype),
        log_detr=state.log_detr + log_r,
    )
