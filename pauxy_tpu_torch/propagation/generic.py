"""Continuous Hubbard-Stratonovich propagator for the Generic Hamiltonian.

Counterpart of ``pauxy_tpu/propagation/generic.py``. The one-body half-step
``BH1`` and the mean-field shift are built host-side (scipy's expm, as in
JAX); the two-body step builds VHS = i sqrt(dt) sum_x L_x (x - xbar)_x as
one [w, X] x [X, M^2] product and applies exp(VHS) by its order-6 Taylor
series to both spins' columns at once.

``taylor_impl`` selects the series, with the JAX package's values:
``"xla"`` (the default) six batched matmuls, ``"pallas"`` the fused kernel
(``ops/taylor_cuda``: the CUDA kernel on the card, its plain version on a
CPU tensor; an M past the kernel's cap, ``taylor_cuda.max_m``, takes the
six matmuls, chosen by shape before any launch), ``"pallas_bf16"`` the
fused kernel's bf16-multiplicand tier (bf16 products, float32 sums; an M
past its cap takes its plain version, by shape). ``"pallas_interpret"``
(JAX's CPU test mode) is refused: here ``"pallas"`` on a CPU tensor
already takes the plain version. ``"xla_3m"`` runs the ``"xla"`` series:
JAX splits each complex product into three real ones (3M) because the TPU
has no complex matmul unit; on the H100 the split was measured slower
than the complex products (PERF.md), so the port keeps one series.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.linalg
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.ops import taylor_cuda
from pauxy_tpu_torch.ops.contract import cr_einsum
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.utils.tracing import span

TAYLOR_IMPLS = ("xla", "xla_3m", "pallas", "pallas_bf16")

# The "xla" route: the series as batched matmuls, which is the fused
# kernel's plain version.
apply_exponential_taylor = taylor_cuda.apply_taylor_plain


def _check_taylor_impl(taylor_impl: str | None) -> str:
    if taylor_impl is None:
        return "xla"
    if taylor_impl == "pallas_interpret":
        raise ValueError(
            "taylor_impl 'pallas_interpret' is JAX's CPU test mode; use "
            "'pallas', which takes the plain version on a CPU tensor")
    if taylor_impl not in TAYLOR_IMPLS:
        raise ValueError(f"taylor_impl {taylor_impl!r}, want one of "
                         f"{TAYLOR_IMPLS}")
    return taylor_impl


def taylor_series(vhs: torch.Tensor, phi: torch.Tensor, order: int,
                  taylor_impl: str) -> torch.Tensor:
    """exp(vhs) phi to ``order`` by the route ``taylor_impl`` names: the
    fused kernel (f32 or bf16 tier) where M is within its cap, else that
    tier's plain series, chosen by shape before any launch; ``"xla"`` and
    ``"xla_3m"`` run the plain complex series. The kernels' plain series
    past their caps stand in for JAX's Pallas body, whose dots pin their
    precision, so they run in IEEE float32 under every matmul tier; the
    "xla" series takes the tier, as in JAX. Every route runs inside the
    span ``taylor``."""
    m = vhs.shape[-1]
    with span("taylor"):
        if taylor_impl == "pallas":
            if taylor_cuda.fits(m, vhs.dtype):
                return taylor_cuda.apply_taylor(vhs, phi, order)
            with config.full_precision():
                return apply_exponential_taylor(vhs, phi, order)
        if taylor_impl == "pallas_bf16":
            if taylor_cuda.fits(m, vhs.dtype, lowp=True):
                return taylor_cuda.apply_taylor(vhs, phi, order, lowp=True)
            with config.full_precision():
                return taylor_cuda.apply_taylor_plain(vhs, phi, order,
                                                      lowp=True)
        return apply_exponential_taylor(vhs, phi, order)


class GenericContinuous(nn.Module):
    """Inner propagator for the ab-initio Hamiltonian. Buffers: ``BH1``
    [2, M, M], ``mf_shift`` [X] complex, ``chol`` [M, M, X] (the
    Hamiltonian's, at its natural type)."""

    def __init__(self, BH1, mf_shift, chol, *, dt: float, exp_order: int = 6,
                 taylor_impl: str | None = None):
        super().__init__()
        self.register_buffer("BH1", BH1)
        self.register_buffer("mf_shift", mf_shift)
        self.register_buffer("chol", chol)
        self.dt = float(dt)
        self.exp_order = int(exp_order)
        self.taylor_impl = _check_taylor_impl(taylor_impl)

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5

    def force_bias(self, trial, ga, gb) -> torch.Tensor:
        """xbar = -sqrt(dt) (i vbias - mf_shift), vbias [w, X] from the
        trial's half-rotated Cholesky tensors: per determinant and
        det-weighted for a multi-determinant trial (vbias = sum_d w_d
        tr(rchol_d Ghalf_d)); from the full G (sum_pq L_pq (Ga + Gb)_pq)
        where there is no half rotation."""
        rca = getattr(trial, "rchola", None)
        if ga.Ghalf is None or rca is None:
            vbias = cr_einsum("pqx,wpq->wx", self.chol, ga.G + gb.G)
        elif isinstance(trial, msd.MultiSlaterTrial):
            wd = ga.det_weights[..., None, None]          # [w, D, 1, 1]
            vbias = (cr_einsum("dxim,wdim->wx", rca, wd * ga.Ghalf)
                     + cr_einsum("dxim,wdim->wx", trial.rcholb,
                                 wd * gb.Ghalf))
        else:
            vbias = (cr_einsum("xim,wim->wx", rca, ga.Ghalf)
                     + cr_einsum("xim,wim->wx", trial.rcholb, gb.Ghalf))
        return -self.sqrt_dt * (1j * vbias - self.mf_shift)

    def apply_vhs(self, phia: torch.Tensor, phib: torch.Tensor,
                  xshifted: torch.Tensor):
        """VHS = i sqrt(dt) sum_x L_x xshifted_x, then exp(VHS) applied to
        [phia | phib] by one Taylor series. On a [walker, chol] mesh each
        rank forms its X slice's part of VHS and the chol group sums them
        before the series. Forming VHS is the span ``vhs``."""
        with span("vhs"):
            vhs = cr_einsum("pqx,wx->wpq", self.chol,
                            (1j * self.sqrt_dt) * xshifted).contiguous()
            # On a [walker, chol] mesh, a partial sum over this rank's X
            # slice.
            vhs = pmesh.chol_sum(vhs)
        na = phia.shape[-1]
        phi_in = torch.cat([phia, phib], dim=-1)
        phi = taylor_series(vhs, phi_in, self.exp_order, self.taylor_impl)
        return phi[..., :na], phi[..., na:]

    def bp_dagger_fields(self, x: torch.Tensor) -> torch.Tensor:
        """Fields y with exp(VHS(y)) = exp(VHS(x))^dagger: y = -conj(x)."""
        return -x.conj()


def construct_mean_field_shift(ham, trial) -> np.ndarray:
    """mf_shift_x = i sum_ik L[i,k,x] (G_T0 + G_T1)[i,k]."""
    g = np.asarray(trial.G_host)
    chol = ham.chol.cpu().numpy()
    m = chol.shape[0]
    return 1j * ((g[0] + g[1]).reshape(-1) @ chol.reshape(m * m, -1))


def make_generic_continuous(ham, trial, dt: float, exp_order: int = 6,
                            taylor_impl: str | None = None, *, device=None,
                            dtype=None) -> GenericContinuous:
    """Host-side set-up: BH1_s = expm(-dt/2 (h1e_mod_s - i sum_x mf_x
    L_x)); ``chol`` keeps its natural type. ``taylor_impl`` None reads
    ``PAUXY_TPU_TAYLOR`` (default ``"xla"``), as JAX's does."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    if taylor_impl is None:
        taylor_impl = os.environ.get("PAUXY_TPU_TAYLOR", "xla")
    mf_shift = construct_mean_field_shift(ham, trial)
    chol = ham.chol.cpu().numpy()
    m = chol.shape[0]
    shift = 1j * (chol.reshape(m * m, -1) @ mf_shift).reshape(m, m)
    h1 = ham.h1e_mod.cpu().numpy() - shift[None]
    bh1 = np.stack([scipy.linalg.expm(-0.5 * dt * h1[0]),
                    scipy.linalg.expm(-0.5 * dt * h1[1])])
    chol_dtype = prec.cplx if ham.chol.is_complex() else prec.real
    return GenericContinuous(
        torch.from_numpy(np.ascontiguousarray(bh1.astype(prec.np_cplx))
                         ).to(device),
        torch.from_numpy(np.ascontiguousarray(mf_shift.astype(prec.np_cplx))
                         ).to(device),
        ham.chol.to(device=device, dtype=chol_dtype),
        dt=dt, exp_order=exp_order, taylor_impl=taylor_impl,
    )
