"""Build the port's objects from the JAX package's, given as numpy arrays.

The parity tests hand both packages identical inputs: they read the JAX
objects' fields with ``np.asarray`` and pass them here. Nothing here
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models.hubbard import Hubbard, band_energies
from pauxy_tpu_torch.models.trial import SingleDetTrial, trial_density_matrix
from pauxy_tpu_torch.propagation.hubbard import HubbardContinuous
from pauxy_tpu_torch.walkers.state import WalkerState


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def hubbard(T, U: float, symmetric: bool, *, nx: int, ny: int, nup: int,
            ndown: int, t: float = 1.0, device="cpu") -> Hubbard:
    """Hubbard from its hopping matrix T [2, M, M]; h1e_mod = T - U/2
    unless symmetric, as in ``make_hubbard``."""
    T = np.asarray(T)
    h1e_mod = T if symmetric else (T - 0.5 * U * np.eye(T.shape[-1])[None]
                                   ).astype(T.dtype)
    eks = band_energies(t, nx, ny).astype(np.real(T).dtype)
    return Hubbard(_t(T, device), _t(h1e_mod, device), _t(eks, device),
                   U=U, t=t, nx=nx, ny=ny, nup=nup, ndown=ndown,
                   symmetric=symmetric)


def trial(psia, psib, etrial: float, *, name: str = "single_det",
          device="cpu") -> SingleDetTrial:
    """Single-determinant trial from its orbitals psia [M, na], psib [M, nb]."""
    psia = np.asarray(psia)
    psib = np.asarray(psib)
    return SingleDetTrial(_t(psia, device), _t(psib, device),
                          G_host=trial_density_matrix(psia, psib),
                          etrial=etrial, name=name)


def hubbard_continuous(BH1, mf_shift, *, dt: float, U: float, charge: bool,
                       device="cpu") -> HubbardContinuous:
    return HubbardContinuous(_t(BH1, device), _t(mf_shift, device), dt=dt,
                             U=U, charge=charge)


def walker_state(*, phia, phib, weight, unscaled_weight, log_ovlp,
                 hybrid_energy, log_detr, total_weight, device="cpu"
                 ) -> WalkerState:
    """WalkerState from the JAX state's fields ([w, M, n] layout)."""
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
