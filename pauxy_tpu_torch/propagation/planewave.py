"""Continuous Hubbard-Stratonovich propagator for the UEG (plane waves).

Counterpart of ``pauxy_tpu/propagation/planewave.py``. The density
operators stay sparse (``ops/ueg_sparse.SparseRho``): the VHS is one
gather of the per-q coefficients,

  iA_q = i (rho_q + rho_q^dagger),  iB_q = -(rho_q - rho_q^dagger)
  VHS  = sqrt(dt) sum_q [ (i x+_q - x-_q) rho_q + (i x+_q + x-_q) rho_q^T ]

(rho is real, so rho^dagger = rho^T), and exp(VHS) is applied to both
spins' columns at once by its order-6 Taylor series. The force bias takes
the pseudo-spectral Coulomb correlations on the FFT cube when the system
has its cube maps and the walkers' half-rotated G is at hand, else the
masked gathers over the kpq map. The mean-field shift is zero.

``taylor_impl`` (None reads ``PAUXY_TPU_TAYLOR_UEG``, default ``"xla"``,
as JAX does) selects the series as in ``propagation/generic.py``:
``"xla"`` six batched matmuls, ``"pallas"`` the fused kernel,
``"pallas_bf16"`` its bf16-multiplicand tier; an M past a kernel's cap
takes that tier's plain series, by shape. As in JAX, ``"xla_3m"`` runs the
plain complex series here.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators.local_energy import fft_coulomb_terms
from pauxy_tpu_torch.ops import ueg_sparse
from pauxy_tpu_torch.propagation.generic import (_check_taylor_impl,
                                                 taylor_series)
from pauxy_tpu_torch.utils.tracing import span


class PlaneWave(nn.Module):
    """Inner propagator for the UEG. Buffers: ``BH1`` [2, M] (the diagonal
    of expm(-dt/2 h1e_mod)), ``mf_shift`` [2 nq] zeros, and the FFT-cube
    maps ``gmap`` [M] and ``qmap_fft`` [nq] (None without them); ``sp``
    holds the gather metadata of the density operators."""

    def __init__(self, BH1, mf_shift, sp: ueg_sparse.SparseRho, *,
                 dt: float, gmap=None, qmap_fft=None,
                 qmesh: tuple | None = None, exp_order: int = 6,
                 taylor_impl: str = "xla"):
        super().__init__()
        self.register_buffer("BH1", BH1)
        self.register_buffer("mf_shift", mf_shift)
        self.register_buffer("gmap", gmap)
        self.register_buffer("qmap_fft", qmap_fft)
        self.sp = sp
        self.dt = float(dt)
        self.qmesh = None if qmesh is None else tuple(qmesh)
        self.exp_order = int(exp_order)
        self.taylor_impl = _check_taylor_impl(taylor_impl)

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5

    @property
    def nq(self) -> int:
        return self.sp.nq

    @property
    def uses_full_g(self) -> bool:
        """The gather route of the force bias reads the full G."""
        return self.qmesh is None

    def force_bias(self, trial, ga, gb) -> torch.Tensor:
        """-sqrt(dt) (<iA_q>, <iB_q>) [w, 2 nq] from <rho_q> and
        <rho_q^T>: FFT correlations of the half-rotated G, or the masked
        gathers of the full G."""
        if self.qmesh is not None and ga.Ghalf is not None:
            ka, pa = fft_coulomb_terms(trial.psia, ga.Ghalf, self.gmap,
                                       self.qmap_fft, self.qmesh)
            kb, pb = fft_coulomb_terms(trial.psib, gb.Ghalf, self.gmap,
                                       self.qmap_fft, self.qmesh)
            t1 = self.sp.qfac * (ka + kb)
            t2 = self.sp.qfac * (pa + pb)
        else:
            t1, t2 = ueg_sparse.rho_expectations(self.sp, ga.G + gb.G)
        vplus = 1j * (t1 + t2)
        vminus = -(t1 - t2)
        return -self.sqrt_dt * torch.cat([vplus, vminus], dim=-1)

    def build_vhs(self, xshifted: torch.Tensor) -> torch.Tensor:
        """VHS = sqrt(dt) (iA x+ + iB x-), [w, M, M] contiguous; the span
        ``vhs``."""
        with span("vhs"):
            xa = xshifted[:, :self.nq]
            xb = xshifted[:, self.nq:]
            vhs = ueg_sparse.assemble_vhs(self.sp, 1j * xa - xb,
                                          1j * xa + xb)
            return (self.sqrt_dt * vhs).contiguous()

    def apply_vhs(self, phia: torch.Tensor, phib: torch.Tensor,
                  xshifted: torch.Tensor):
        """exp(VHS) applied to [phia | phib] by one Taylor series."""
        vhs = self.build_vhs(xshifted)
        na = phia.shape[-1]
        phi = taylor_series(vhs, torch.cat([phia, phib], dim=-1),
                            self.exp_order, self.taylor_impl)
        return phi[..., :na], phi[..., na:]

    def bp_dagger_fields(self, x: torch.Tensor) -> torch.Tensor:
        """Fields y with exp(VHS(y)) = exp(VHS(x))^dagger: iA is
        anti-Hermitian (x+ -> -conj x+), iB Hermitian (x- -> conj x-)."""
        return torch.cat([-x[:, :self.nq].conj(), x[:, self.nq:].conj()],
                         dim=-1)


def make_planewave(ham, trial, dt: float, exp_order: int = 6,
                   taylor_impl: str | None = None, *, device=None,
                   dtype=None) -> PlaneWave:
    """BH1 = expm(-dt/2 h1e_mod), exact as a diagonal exponential (h1e_mod
    is diagonal), stored as a [2, M] diagonal; the gather metadata on
    ``device``. ``trial`` is unused, as in JAX (the mean-field shift is
    zero)."""
    del trial
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    if taylor_impl is None:
        taylor_impl = os.environ.get("PAUXY_TPU_TAYLOR_UEG", "xla")
    h1 = ham.h1e_mod.cpu().numpy()
    bh1 = np.stack([np.exp(-0.5 * dt * np.diagonal(h1[0])),
                    np.exp(-0.5 * dt * np.diagonal(h1[1]))])
    fft = {}
    if getattr(ham, "gmap", None) is not None:
        fft = dict(gmap=ham.gmap.to(device), qmap_fft=ham.qmap.to(device),
                   qmesh=ham.qmesh)
    return PlaneWave(
        torch.from_numpy(np.ascontiguousarray(bh1.astype(prec.np_cplx))
                         ).to(device),
        torch.zeros(2 * ham.nq, dtype=prec.cplx, device=device),
        ueg_sparse.make_sparse_rho(ham, prec.real).to(device), dt=dt,
        exp_order=exp_order, taylor_impl=taylor_impl, **fft)
