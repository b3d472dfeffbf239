"""Model-agnostic continuous Hubbard-Stratonovich propagation.

Counterpart of ``pauxy_tpu/propagation/continuous.py``: ``Continuous`` holds
the step's settings around the model's inner propagator (the Generic one
here; the Hubbard lanes block of ``qmc/hubbard_fast.py`` runs its own step)
and ``propagate_phaseless`` is the batched phaseless step

    phi <- B_{T/2} e^{VHS(x - xbar)} B_{T/2} phi

with the hybrid weight update. Not ported yet, each raising
``NotImplementedError``: free projection, the local-energy update
(``hybrid=False``), the stochastic-RI one-body step and multi-determinant
trials.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pauxy_tpu_torch.ops import greens


@dataclasses.dataclass(frozen=True)
class Continuous:
    """Propagation configuration around the model's inner propagator."""

    inner: object
    dt: float
    free_projection: bool = False
    hybrid: bool = True
    force_bias: bool = True
    stochastic_ri: bool = False
    ri_nsamples: int = 20

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5

    @property
    def ebound(self) -> float:
        """Hybrid-energy bound sqrt(2/dt)."""
        return (2.0 / self.dt) ** 0.5

    def propagate(self, trial, state, generator, eshift: float, xi=None):
        """One phaseless step. ``xi`` [w, nfields] injects the normal field
        draws (tests); otherwise they come from ``generator``."""
        missing = {"free_projection": self.free_projection,
                   "hybrid=False": not self.hybrid,
                   "stochastic_ri": self.stochastic_ri,
                   "multi-determinant trials": not is_single_det(trial)}
        if any(missing.values()):
            raise NotImplementedError(
                "not ported yet for the continuous propagator: "
                + ", ".join(k for k, v in missing.items() if v))
        return propagate_phaseless(self, trial, state, generator, eshift, xi)


def is_single_det(trial) -> bool:
    return getattr(trial, "psia", None) is not None and trial.psia.dim() == 2


def _bound_hybrid(ehyb: torch.Tensor, eshift: float, ebound: float
                  ) -> torch.Tensor:
    """Cap Re(ehyb) to eshift +/- ebound; no-op while eshift ~ 0."""
    if abs(eshift) < 1e-10:
        return ehyb
    re = ehyb.real.clamp(eshift - ebound, eshift + ebound)
    return torch.complex(re, ehyb.imag)


def trial_greens(trial, phia, phib):
    """(ga, gb, log overlap) of a single-determinant trial; only the
    half-rotated Green's functions are formed."""
    ga = greens.greens_function(phia, trial.psia, want_g=False)
    gb = greens.greens_function(phib, trial.psib, want_g=False)
    return ga, gb, ga.log_ovlp + gb.log_ovlp


def trial_log_overlap(trial, phia, phib) -> torch.Tensor:
    return (greens.log_overlap(phia, trial.psia)
            + greens.log_overlap(phib, trial.psib))


class TwoBodyFactors(NamedTuple):
    cmf: torch.Tensor       # [w] mean-field-shift constant factor
    cfb: torch.Tensor       # [w] force-bias shift constant factor
    xshifted: torch.Tensor  # [w, nfields]


def _apply_bh1(bh1: torch.Tensor, phia: torch.Tensor, phib: torch.Tensor):
    """One-body half-step phi <- B_{T/2} phi; a [2, M] bh1 is diagonal."""
    if bh1.dim() == 2:
        return bh1[0][None, :, None] * phia, bh1[1][None, :, None] * phib
    return torch.matmul(bh1[0], phia), torch.matmul(bh1[1], phib)


def two_body_factors(prop: Continuous, trial, ga, gb, nwalkers: int,
                     generator=None, xi=None) -> TwoBodyFactors:
    """Fields x ~ N(0, 1) [w, nfields] (``xi`` if given), the force bias
    xbar with components clamped to unit modulus, and the shift factors."""
    inner = prop.inner
    mf = inner.mf_shift
    nfields = mf.shape[0]
    if xi is None:
        xi = torch.randn((nwalkers, nfields), generator=generator,
                         dtype=mf.real.dtype, device=mf.device)
    if prop.force_bias:
        xbar = inner.force_bias(trial, ga, gb)
        absx = xbar.abs()
        xbar = torch.where(absx > 1.0,
                           xbar / torch.where(absx == 0, 1.0, absx), xbar)
    else:
        xbar = torch.zeros((nwalkers, nfields), dtype=mf.dtype,
                           device=mf.device)
    xshifted = xi - xbar
    cmf = -prop.sqrt_dt * (xshifted @ mf)
    cfb = torch.sum(xi * xbar, dim=-1) - 0.5 * torch.sum(xbar * xbar, dim=-1)
    return TwoBodyFactors(cmf=cmf, cfb=cfb, xshifted=xshifted)


def propagate_phaseless(prop: Continuous, trial, state, generator,
                        eshift: float, xi=None):
    """One phaseless step for the whole population, with the hybrid weight
    update. Walkers with |weight| <= 1e-8 are frozen, which also keeps NaNs
    of dead walkers out of the state."""
    inner = prop.inner
    ga, gb, log_o = trial_greens(trial, state.phia, state.phib)
    phia, phib = _apply_bh1(inner.BH1, state.phia, state.phib)
    fac = two_body_factors(prop, trial, ga, gb, state.nwalkers, generator,
                           xi)
    phia, phib = inner.apply_vhs(phia, phib, fac.xshifted)
    phia, phib = _apply_bh1(inner.BH1, phia, phib)
    log_o_new = trial_log_overlap(trial, phia, phib)

    dt = prop.dt
    log_ratio = log_o_new - log_o
    ehyb = _bound_hybrid(-(log_ratio + fac.cfb + fac.cmf) / dt, eshift,
                         prop.ebound)
    log_imp = -dt * (0.5 * (ehyb + state.hybrid_energy) - eshift)
    magn = torch.exp(log_imp.real)
    dtheta = (-dt * ehyb - fac.cfb).imag
    weight = state.weight * magn * torch.clamp_min(torch.cos(dtheta), 0.0)
    weight = torch.where(torch.isfinite(weight), weight,
                         torch.zeros_like(weight))

    alive = state.weight.abs() > 1e-8

    def sel(new, old):
        return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    return dataclasses.replace(
        state,
        phia=sel(phia, state.phia),
        phib=sel(phib, state.phib),
        weight=sel(weight, state.weight),
        log_ovlp=sel(log_o_new, state.log_ovlp),
        hybrid_energy=sel(ehyb, state.hybrid_energy),
    )
