"""Continuous Hubbard-Stratonovich propagator for the Hubbard model.

Counterpart of ``pauxy_tpu/propagation/hubbard.py``: the one-body
half-step ``BH1`` and the mean-field shift ``mf_shift`` for the charge or
spin decomposition. The HS potential is diagonal in the site basis; the
main path applies exp(VHS) as an elementwise gauge factor inside
``qmc/hubbard_fast.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch
from torch import nn

from pauxy_tpu_torch import config


class HubbardContinuous(nn.Module):
    """Charge (v_i = i sqrt(U)(n_iu + n_id)) or spin decomposition; one
    auxiliary field per site. ``BH1`` [2, M, M] and ``mf_shift`` [M] are
    complex buffers."""

    def __init__(self, BH1, mf_shift, *, dt: float, U: float,
                 charge: bool = True):
        super().__init__()
        self.register_buffer("BH1", BH1)
        self.register_buffer("mf_shift", mf_shift)
        self.dt = float(dt)
        self.U = float(U)
        self.charge = bool(charge)

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5


def make_hubbard_continuous(ham, trial, dt: float,
                            charge_decomposition: bool = True, *,
                            device=None, dtype=None) -> HubbardContinuous:
    """Build the propagator (host-side expm; setup, not the hot path).

    Charge: mf_shift_i = i sqrt(U) (G_T[0] + G_T[1])_ii,
            BH1 = expm(-dt/2 (h1e_mod - i sqrt(U) diag(mf_shift))).
    Spin:   mf_shift_i = sqrt(U) (G_T[0] - G_T[1])_ii,
            BH1 = expm(-dt/2 (T + U/2 - sqrt(U) diag(mf_shift))).
    """
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    g = np.asarray(trial.G_host)
    da, db = np.diagonal(g[0]), np.diagonal(g[1])
    if charge_decomposition:
        iu = 1j * ham.U ** 0.5
        mf_shift = iu * (da + db)
        h1 = ham.h1e_mod.cpu().numpy() - iu * np.diag(mf_shift)[None]
    else:
        mf_shift = ham.U ** 0.5 * (da - db)
        eye = np.eye(ham.nbasis)
        h1 = (ham.T.cpu().numpy() + 0.5 * ham.U * eye[None]
              - ham.U ** 0.5 * np.diag(mf_shift)[None])
    bh1 = np.stack([scipy.linalg.expm(-0.5 * dt * h1[0]),
                    scipy.linalg.expm(-0.5 * dt * h1[1])])
    return HubbardContinuous(
        torch.from_numpy(bh1.astype(prec.np_cplx)).to(device),
        torch.from_numpy(np.ascontiguousarray(mf_shift.astype(prec.np_cplx))
                         ).to(device),
        dt=dt, U=ham.U, charge=charge_decomposition,
    )
