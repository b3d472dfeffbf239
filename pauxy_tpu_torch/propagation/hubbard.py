"""Continuous Hubbard-Stratonovich propagator for the Hubbard model.

Counterpart of ``pauxy_tpu/propagation/hubbard.py``: the one-body
half-step ``BH1`` and the mean-field shift ``mf_shift`` for the charge or
spin decomposition, and the step pieces the generic [w, M, n] block needs
(the force bias from the full Green's function, exp(VHS) and the fields of
its adjoint for back propagation). The HS potential is diagonal in the site
basis, so exp(VHS) is an elementwise gauge factor, here and inside the
lanes block of ``qmc/hubbard_fast.py``.
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

    # The force bias reads the full Green's function's diagonal.
    uses_full_g = True

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5

    @property
    def mf_core(self) -> torch.Tensor:
        """0.5 mf_shift . mf_shift."""
        return 0.5 * torch.dot(self.mf_shift, self.mf_shift)

    def force_bias(self, trial, ga, gb) -> torch.Tensor:
        """xbar = -sqrt(dt) (vbias - mf_shift), vbias = i sqrt(U)
        (diag Ga + diag Gb) (charge) or sqrt(U) (diag Ga - diag Gb)
        (spin)."""
        da = torch.diagonal(ga.G, dim1=-2, dim2=-1)
        db = torch.diagonal(gb.G, dim1=-2, dim2=-1)
        if self.charge:
            vbias = 1j * self.U ** 0.5 * (da + db)
        else:
            vbias = self.U ** 0.5 * (da - db)
        return -self.sqrt_dt * (vbias - self.mf_shift)

    def apply_vhs(self, phia, phib, xshifted):
        """phi <- exp(VHS) phi, VHS diagonal: i sqrt(dt U) diag(x) on both
        spins (charge) or -/+ sqrt(dt U) diag(x) per spin (spin)."""
        if self.charge:
            gauge = torch.exp(self.sqrt_dt * 1j * self.U ** 0.5 * xshifted)
            return phia * gauge[:, :, None], phib * gauge[:, :, None]
        gauge = torch.exp((self.dt * self.U) ** 0.5 * xshifted)
        return phia / gauge[:, :, None], phib * gauge[:, :, None]

    def bp_dagger_fields(self, x: torch.Tensor) -> torch.Tensor:
        """Fields y with exp(VHS(y)) = exp(VHS(x))^dagger: -conj(x) for the
        anti-Hermitian charge generator, conj(x) for the spin one."""
        return -x.conj_physical() if self.charge else x.conj_physical()


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
