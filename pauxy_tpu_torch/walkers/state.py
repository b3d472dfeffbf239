"""Struct-of-arrays walker state.

Counterpart of ``pauxy_tpu/walkers/state.py`` for single-determinant
phaseless runs: the whole population is one dataclass of tensors with a
leading walker axis. The free-projection phase, the local-energy history
and the back-propagation buffers of the JAX state are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from pauxy_tpu_torch import config
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

    @property
    def nwalkers(self) -> int:
        return self.phia.shape[0]

    @property
    def nbasis(self) -> int:
        return self.phia.shape[1]


def init_walkers(trial, nwalkers: int, total_weight: float | None = None
                 ) -> WalkerState:
    """All walkers start as the trial's initial determinant, weight 1.

    ``total_weight`` seeds the 10% weight cap before the first population
    control (the target weight by default). The log-overlaps go through
    ``clinalg.slogdet``: kernel B on the card.
    """
    inita, initb = trial.inita, trial.initb
    phia = inita[None].expand((nwalkers,) + tuple(inita.shape)).contiguous()
    phib = initb[None].expand((nwalkers,) + tuple(initb.shape)).contiguous()
    cdtype = inita.dtype
    rdtype = config.real_dtype(cdtype)
    dev = inita.device
    log_o = (greens.log_overlap(phia, trial.psia)
             + greens.log_overlap(phib, trial.psib))
    if total_weight is None:
        total_weight = float(nwalkers)
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
    )
