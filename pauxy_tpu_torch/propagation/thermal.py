"""Finite-temperature continuous-HS propagation.

Counterpart of ``pauxy_tpu/propagation/thermal.py`` for the full-rank
stack. Per slice

    B(x) = B_{H1/2} e^{VHS(x - xbar)} B_{H1/2}

with the force bias from the walker's 1-RDM P = 1 - G^T, the slice pushed
into the binned stack, the Green's function re-stratified from the
prefix-cached QDT fold (``ops/cpqr`` on every fold) and the phaseless
weight from det G_old / det G_new = det(1 + A_new) / det(1 + A_old). The
UEG inner's exp(VHS) is the plain order-6 series (``taylor_cuda.
apply_taylor_plain``, batched matmuls), as JAX's is its einsum series. The
Generic inner, the low-rank stack and the discrete thermal propagator are
not ported and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import thermal as th
from pauxy_tpu_torch.estimators.thermal import one_rdm_from_G
from pauxy_tpu_torch.ops import ueg_sparse
from pauxy_tpu_torch.ops.taylor_cuda import apply_taylor_plain
from pauxy_tpu_torch.walkers import thermal_state as tws


def clamp_force_bias(xbar: torch.Tensor, bound: float) -> torch.Tensor:
    """Rescale components with |xbar| > bound to unit magnitude (not to
    ``bound``), like the reference's fb_bound handling."""
    absx = xbar.abs()
    safe = torch.where(absx == 0, torch.ones_like(absx), absx)
    return torch.where(absx > bound, xbar / safe, xbar)


@dataclasses.dataclass
class ThermalHubbardInner:
    """Charge-decomposition HS for the Hubbard model at T > 0."""

    BH1: torch.Tensor        # [2, M, M], with the mean-field shift and mu
    mf_shift: torch.Tensor   # [M]
    dt: float
    U: float

    def force_bias_P(self, p: torch.Tensor) -> torch.Tensor:
        d = torch.diagonal(p, dim1=-2, dim2=-1)           # [w, 2, M]
        vbias = 1j * self.U ** 0.5 * (d[:, 0] + d[:, 1])
        return -(self.dt ** 0.5) * (vbias - self.mf_shift)

    def dense_bv(self, xshifted: torch.Tensor) -> torch.Tensor:
        gauge = torch.exp(self.dt ** 0.5 * 1j * self.U ** 0.5 * xshifted)
        bv = torch.diag_embed(gauge)                      # [w, M, M]
        return torch.stack([bv, bv], dim=1)               # [w, 2, M, M]


@dataclasses.dataclass
class ThermalUEGInner:
    """The UEG at T > 0 (plane-wave full-rank path)."""

    BH1: torch.Tensor        # [2, M, M] diagonal
    mf_shift: torch.Tensor   # [2 nq] zeros
    sp: ueg_sparse.SparseRho
    dt: float
    exp_order: int = 6

    @property
    def nq(self) -> int:
        return self.sp.nq

    def force_bias_P(self, p: torch.Tensor) -> torch.Tensor:
        t1, t2 = ueg_sparse.rho_expectations(self.sp, p[:, 0] + p[:, 1])
        vplus = 1j * (t1 + t2)
        vminus = -(t1 - t2)
        return -(self.dt ** 0.5) * torch.cat([vplus, vminus], dim=-1)

    def dense_bv(self, xshifted: torch.Tensor) -> torch.Tensor:
        xa = xshifted[:, :self.nq]
        xb = xshifted[:, self.nq:]
        vhs = self.dt ** 0.5 * ueg_sparse.assemble_vhs(
            self.sp, 1j * xa - xb, 1j * xa + xb)
        m = vhs.shape[-1]
        eye = torch.eye(m, dtype=vhs.dtype, device=vhs.device).expand(
            vhs.shape)
        bv = apply_taylor_plain(vhs, eye, self.exp_order)
        return torch.stack([bv, bv], dim=1)


@dataclasses.dataclass
class ThermalContinuous:
    inner: ThermalHubbardInner | ThermalUEGInner
    dt: float
    mf_const_fac: complex = 1.0 + 0j
    force_bias: bool = True
    # Force-bias clamp |xbar| <= fb_bound (the reference's option).
    fb_bound: float = 1.0
    free_projection: bool = False

    @property
    def nfields(self) -> int:
        return self.inner.mf_shift.shape[0]

    def _sample_b(self, state, xi: torch.Tensor | None,
                  generator: torch.Generator | None):
        """Fields and the slice propagator B = B_{H1/2} e^{VHS} B_{H1/2}:
        (b, cfb, cmf). ``xi`` [w, nfields] is drawn from ``generator``
        unless given (tests inject JAX's draws)."""
        inner = self.inner
        nw = state.nwalkers
        rdtype = state.weight.dtype
        if xi is None:
            xi = torch.randn((nw, self.nfields), generator=generator,
                             dtype=rdtype, device=state.weight.device)
        cdtype = state.G.dtype
        if self.force_bias:
            xbar = clamp_force_bias(inner.force_bias_P(one_rdm_from_G(
                state.G)), self.fb_bound)
        else:
            xbar = torch.zeros((nw, self.nfields), dtype=cdtype,
                               device=xi.device)
        xshifted = xi - xbar
        cfb = torch.sum(xi * xbar, -1) - 0.5 * torch.sum(xbar * xbar, -1)
        cmf = -(self.dt ** 0.5) * torch.matmul(xshifted, inner.mf_shift)
        bv = inner.dense_bv(xshifted)                     # [w, 2, M, M]
        b = torch.matmul(torch.matmul(inner.BH1, bv), inner.BH1)
        return b, cfb, cmf

    def _update_weight(self, state, log_oratio, cfb, cmf, extra: dict):
        """Hybrid phaseless or free-projection weight update."""
        cdtype = log_oratio.dtype
        if self.free_projection:
            arg = cmf + cfb + log_oratio
            weight = state.weight * torch.exp(arg.real)
            phase = state.phase * torch.exp(1j * arg.imag).to(cdtype)
            weight = torch.where(torch.isfinite(weight), weight,
                                 torch.zeros_like(weight))
            return dataclasses.replace(state, weight=weight, phase=phase,
                                       **extra)
        hybrid = log_oratio + cfb + cmf
        magn = abs(self.mf_const_fac) * torch.exp(hybrid.real)
        cosine_fac = torch.clamp_min(torch.cos((hybrid - cfb).imag), 0.0)
        weight = state.weight * magn * cosine_fac
        weight = torch.where(torch.isfinite(weight), weight,
                             torch.zeros_like(weight))
        return dataclasses.replace(state, weight=weight,
                                   hybrid_energy=-hybrid / self.dt, **extra)

    def propagate(self, trial, state, ts: int, xi: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """One time slice for the whole population. Bins below the active
        one are final for the rest of the beta sweep, so their QDT fold
        (the prefix carry pq/pd/pt) is refreshed once on entering a bin and
        each slice folds only bins block..nbins-1 on top of it."""
        b, cfb, cmf = self._sample_b(state, xi, generator)
        state = tws.update_stack(trial, state, b, ts)
        block, counter = divmod(ts, trial.stack_size)
        s = state.stack.transpose(1, 2)                   # [w, 2, bins, M, M]
        prefix = (state.pq, state.pd, state.pt)
        if counter == 0 and block > 0:
            prefix = th.qdt_fold(s, prefix, block - 1, block)
        q, d, t = th.qdt_fold(s, prefix, block, state.nbins)
        g_new, log_m0_new = th.inverse_one_plus_qdt_logdet(q, d, t)
        log_oratio = torch.sum(state.log_m0 - log_m0_new, dim=-1)
        return self._update_weight(
            state, log_oratio, cfb, cmf,
            {"G": g_new, "log_m0": log_m0_new, "pq": prefix[0],
             "pd": prefix[1], "pt": prefix[2]})


def make_thermal_propagator(ham, trial, dt: float, options=None, *,
                            device=None, dtype=None) -> ThermalContinuous:
    """The thermal propagator of a Hubbard or UEG Hamiltonian (host-side
    set-up, as in JAX). The sampled slices carry the system's chemical
    potential ``options["mu"]``, the trial's by default."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    opts = dict(options or {})
    if opts.get("low_rank"):
        raise NotImplementedError("the low-rank thermal stack is not ported")
    p_trial = np.asarray(trial.P_host)
    mu = float(trial.mu if opts.get("mu") is None else opts["mu"])

    def dev(x, dt_=None):
        return torch.from_numpy(np.ascontiguousarray(
            x.astype(dt_ or prec.np_cplx))).to(device)

    m = ham.nbasis
    if ham.name == "Hubbard":
        iu = 1j * ham.U ** 0.5
        mf_shift = iu * (np.diagonal(p_trial[0]) + np.diagonal(p_trial[1]))
        h1 = (ham.h1e_mod.cpu().numpy() - iu * np.diag(mf_shift)[None]
              - mu * np.eye(m)[None])
        bh1 = np.stack([scipy.linalg.expm(-0.5 * dt * h1[0]),
                        scipy.linalg.expm(-0.5 * dt * h1[1])])
        inner = ThermalHubbardInner(BH1=dev(bh1), mf_shift=dev(mf_shift),
                                    dt=float(dt), U=float(ham.U))
        mf_core = 0.5 * np.dot(mf_shift, mf_shift)
    elif ham.name == "UEG":
        h1 = ham.h1e_mod.cpu().numpy() - mu * np.eye(m)[None]
        bh1 = np.stack([np.diag(np.exp(-0.5 * dt * np.diagonal(h1[0]))),
                        np.diag(np.exp(-0.5 * dt * np.diagonal(h1[1])))])
        inner = ThermalUEGInner(
            BH1=dev(bh1),
            mf_shift=torch.zeros(2 * ham.nq, dtype=prec.cplx, device=device),
            sp=ueg_sparse.make_sparse_rho(ham, prec.real),
            dt=float(dt))
        mf_core = 0.0
    else:
        raise NotImplementedError(
            f"no ported thermal propagator for {ham.name!r} (the Generic "
            "thermal inner is not ported)")
    return ThermalContinuous(
        inner=inner,
        dt=float(dt),
        mf_const_fac=complex(np.exp(-dt * complex(mf_core))),
        force_bias=opts.get("force_bias", True),
        fb_bound=float(opts.get("fb_bound", 1.0)),
        free_projection=opts.get("free_projection", False),
    )
