"""Model-agnostic continuous Hubbard-Stratonovich propagation.

Counterpart of ``pauxy_tpu/propagation/continuous.py``: ``Continuous`` holds
the step's settings around the model's inner propagator (Hubbard or
Generic; the Hubbard lanes block of ``qmc/hubbard_fast.py`` runs its own
step) and the batched steps

    phi <- B_{T/2} e^{VHS(x - xbar)} B_{T/2} phi

``propagate_phaseless`` with the hybrid weight update or, with
``hybrid=False``, the local-energy update; ``propagate_free`` for free
projection. With a back-propagation buffer the phaseless step records its
shifted fields and weight factors at ``bp_ix``. The trial is a single
determinant or a multi-determinant expansion (``models/multi_slater``:
the Green's functions det-weighted, the overlap a log-sum-exp over the
determinants). With ``stochastic_ri`` each one-body half-step is
sketched: phi <- (B theta)(theta^T phi) / S with a fresh Rademacher
sketch theta [M, S] a half-step, shared by the walkers (exact in
expectation; a diagonal B is applied exactly).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pauxy_tpu_torch.estimators import mixed
from pauxy_tpu_torch.estimators.local_energy import rademacher
from pauxy_tpu_torch.models import ghf
from pauxy_tpu_torch.models import multi_coherent as mcoh
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.ops import greens
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.utils.tracing import span


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

    def propagate(self, trial, state, generator, eshift: float, xi=None, *,
                  bp_ix: int | None = None, ham=None):
        """One step. ``xi`` [w, nfields] injects the normal field draws
        (tests), with ``stochastic_ri`` an ``RIDraws`` (the fields and the
        two half-steps' sketches); otherwise they come from ``generator``.
        ``bp_ix`` is the back-propagation buffer's slot for this step;
        ``ham`` is needed by the local-energy update (``hybrid=False``)."""
        if isinstance(trial, ghf.GHFTrial):
            raise NotImplementedError(
                "the continuous propagator takes single- and "
                "multi-determinant trials, not a GHF trial")
        if self.free_projection:
            return propagate_free(self, trial, state, generator, eshift, xi)
        return propagate_phaseless(self, trial, state, generator, eshift, xi,
                                   bp_ix=bp_ix, ham=ham)


def is_single_det(trial) -> bool:
    return not isinstance(trial, (msd.MultiSlaterTrial, ghf.GHFTrial,
                                  mcoh.MultiCoherentTrial))


def _bound_hybrid(ehyb: torch.Tensor, eshift: float, ebound: float
                  ) -> torch.Tensor:
    """Cap Re(ehyb) to eshift +/- ebound; no-op while eshift ~ 0."""
    if abs(eshift) < 1e-10:
        return ehyb
    re = ehyb.real.clamp(eshift - ebound, eshift + ebound)
    return torch.complex(re, ehyb.imag)


def trial_greens(trial, phia, phib, want_g: bool = False):
    """(ga, gb, log overlap) of a single- or multi-determinant trial; the
    full Green's functions are formed only with ``want_g``. For a
    multi-determinant trial Ghalf is per determinant [w, D, n, M], G the
    det-weighted one, ``det_weights`` [w, D] rides on both spins and the
    whole log overlap on ga (gb's is 0)."""
    if isinstance(trial, msd.MultiSlaterTrial):
        md = msd.greens_function_multi_det(trial, phia, phib, want_g)
        ga = greens.SpinGreens(
            G=None if md.G is None else md.G[:, 0], Ghalf=md.Ghalfa,
            log_ovlp=md.log_ovlp, det_weights=md.det_weights)
        gb = greens.SpinGreens(
            G=None if md.G is None else md.G[:, 1], Ghalf=md.Ghalfb,
            log_ovlp=torch.zeros_like(md.log_ovlp),
            det_weights=md.det_weights)
        return ga, gb, md.log_ovlp
    ga = greens.greens_function(phia, trial.psia, want_g=want_g)
    gb = greens.greens_function(phib, trial.psib, want_g=want_g)
    return ga, gb, ga.log_ovlp + gb.log_ovlp


def trial_log_overlap(trial, phia, phib) -> torch.Tensor:
    if isinstance(trial, msd.MultiSlaterTrial):
        return msd.log_overlap_multi_det(trial, phia, phib)
    return (greens.log_overlap(phia, trial.psia)
            + greens.log_overlap(phib, trial.psib))


class RIDraws(NamedTuple):
    """A stochastic-RI step's draws: the fields [w, nfields] and the
    Rademacher sketches theta1, theta2 [M, S] of the two half-steps."""

    fields: torch.Tensor
    theta1: torch.Tensor
    theta2: torch.Tensor


class TwoBodyFactors(NamedTuple):
    cmf: torch.Tensor       # [w] mean-field-shift constant factor
    cfb: torch.Tensor       # [w] force-bias shift constant factor
    xshifted: torch.Tensor  # [w, nfields]


def _apply_bh1(bh1: torch.Tensor, phia: torch.Tensor, phib: torch.Tensor):
    """One-body half-step phi <- B_{T/2} phi; a [2, M] bh1 is diagonal."""
    if bh1.dim() == 2:
        return bh1[0][None, :, None] * phia, bh1[1][None, :, None] * phib
    return torch.matmul(bh1[0], phia), torch.matmul(bh1[1], phib)


def _apply_bh1_stochastic(bh1: torch.Tensor, phia: torch.Tensor,
                          phib: torch.Tensor, theta: torch.Tensor):
    """The sketched half-step phi <- (B theta)(theta^T phi) / S, theta
    [M, S] of +/-1, so that E[theta theta^T / S] = I; B theta is formed
    once for the whole batch. A diagonal [2, M] bh1 is applied exactly."""
    if bh1.dim() == 2:
        return _apply_bh1(bh1, phia, phib)
    theta = theta.to(bh1.dtype)
    inv = 1.0 / theta.shape[1]
    return tuple(inv * torch.matmul(b @ theta, theta.T.to(phi.dtype) @ phi)
                 for b, phi in ((bh1[0], phia), (bh1[1], phib)))


def _half_steps(prop: Continuous, state, generator, xi):
    """(first, second, fields): the two one-body half-step closures,
    sketched with stochastic RI (the sketches from ``xi`` or drawn), and
    the step's field draws (``xi`` or None)."""
    bh1 = prop.inner.BH1
    if not prop.stochastic_ri:
        def fn(pa, pb):
            return _apply_bh1(bh1, pa, pb)
        return fn, fn, xi
    if xi is None:
        shape = (state.nbasis, prop.ri_nsamples)
        rd = state.weight.dtype
        xi = RIDraws(None, *(rademacher(shape, rd, generator,
                                        state.weight.device)
                             for _ in range(2)))
    return (lambda pa, pb: _apply_bh1_stochastic(bh1, pa, pb, xi.theta1),
            lambda pa, pb: _apply_bh1_stochastic(bh1, pa, pb, xi.theta2),
            xi.fields)


def two_body_factors(prop: Continuous, trial, ga, gb, nwalkers: int,
                     generator=None, xi=None) -> TwoBodyFactors:
    """Fields x ~ N(0, 1) [w, nfields] (``xi`` if given), the force bias
    xbar with components clamped to unit modulus (the span
    ``force_bias``), and the shift factors."""
    inner = prop.inner
    mf = inner.mf_shift
    nfields = mf.shape[0]
    if xi is None:
        xi = pmesh.draw(lambda shape: torch.randn(
            shape, generator=generator, dtype=mf.real.dtype,
            device=mf.device), (nwalkers, nfields), walker_dim=0,
            chol_dim=1 if pmesh.chol_sharded() else None)
    if prop.force_bias:
        with span("force_bias"):
            xbar = inner.force_bias(trial, ga, gb)
            absx = xbar.abs()
            xbar = torch.where(absx > 1.0,
                               xbar / torch.where(absx == 0, 1.0, absx),
                               xbar)
    else:
        xbar = torch.zeros((nwalkers, nfields), dtype=mf.dtype,
                           device=mf.device)
    xshifted = xi - xbar
    cmf = -prop.sqrt_dt * (xshifted @ mf)
    cfb = torch.sum(xi * xbar, dim=-1) - 0.5 * torch.sum(xbar * xbar, dim=-1)
    if pmesh.chol_sharded():
        # Partial sums over this rank's X slice of the fields.
        cmf, cfb = pmesh.chol_sum(torch.stack([cmf, cfb.to(cmf.dtype)]))
    return TwoBodyFactors(cmf=cmf, cfb=cfb, xshifted=xshifted)


def propagate_phaseless(prop: Continuous, trial, state, generator,
                        eshift: float, xi=None, *, bp_ix: int | None = None,
                        ham=None):
    """One phaseless step for the whole population: the hybrid weight
    update or, with ``prop.hybrid`` False, the local-energy update
    (magnitude from the bounded local energy, cosine from the overlap
    ratio's phase). Walkers with |weight| <= 1e-8 are frozen, which also
    keeps NaNs of dead walkers out of the state. With a buffer and
    ``bp_ix`` the shifted fields, the phase factor and the cosine factor
    are recorded in slot ``bp_ix``."""
    inner = prop.inner
    ga, gb, log_o = trial_greens(trial, state.phia, state.phib,
                                 getattr(inner, "uses_full_g", False))
    first, second, xi = _half_steps(prop, state, generator, xi)
    phia, phib = first(state.phia, state.phib)
    fac = two_body_factors(prop, trial, ga, gb, state.nwalkers, generator,
                           xi)
    phia, phib = inner.apply_vhs(phia, phib, fac.xshifted)
    phia, phib = second(phia, phib)
    log_o_new = trial_log_overlap(trial, phia, phib)

    dt = prop.dt
    log_ratio = log_o_new - log_o
    ehyb = -(log_ratio + fac.cfb + fac.cmf) / dt
    if prop.hybrid:
        ehyb = _bound_hybrid(ehyb, eshift, prop.ebound)
        log_imp = -dt * (0.5 * (ehyb + state.hybrid_energy) - eshift)
        magn = torch.exp(log_imp.real)
        dtheta = (-dt * ehyb - fac.cfb).imag
    else:
        if ham is None:
            raise ValueError("the local-energy weight update needs ham")
        eloc = mixed.energy_estimator(ham, trial)(ga, gb)[0]
        re_eloc = _bound_hybrid(eloc, eshift, prop.ebound)
        magn = torch.exp(-0.5 * dt * (re_eloc + state.eloc - eshift).real)
        log_imp = torch.zeros_like(log_ratio)
        dtheta = log_ratio.imag
        ehyb = state.hybrid_energy
        state = dataclasses.replace(state, eloc=eloc)
    cosine_fac = torch.clamp_min(torch.cos(dtheta), 0.0)
    weight = state.weight * magn * cosine_fac
    weight = torch.where(torch.isfinite(weight), weight,
                         torch.zeros_like(weight))

    alive = state.weight.abs() > 1e-8

    def sel(new, old):
        return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    updates = dict(
        phia=sel(phia, state.phia),
        phib=sel(phib, state.phib),
        weight=sel(weight, state.weight),
        log_ovlp=sel(log_o_new, state.log_ovlp),
        hybrid_energy=sel(ehyb, state.hybrid_energy),
    )
    if state.configs is not None and bp_ix is not None:
        ok = magn > 1e-16
        phase_fac = torch.where(ok, torch.exp(1j * log_imp.imag),
                                torch.zeros_like(log_imp))
        cos_rec = torch.where(ok, cosine_fac, torch.zeros_like(cosine_fac))
        configs = state.configs.clone()
        configs[:, bp_ix] = sel(fac.xshifted.to(configs.dtype),
                                configs[:, bp_ix])
        weight_fac = state.weight_fac.clone()
        weight_fac[:, bp_ix] = sel(phase_fac.to(weight_fac.dtype),
                                   weight_fac[:, bp_ix])
        cos_fac = state.cos_fac.clone()
        cos_fac[:, bp_ix] = sel(cos_rec.to(cos_fac.dtype), cos_fac[:, bp_ix])
        updates.update(configs=configs, weight_fac=weight_fac,
                       cos_fac=cos_fac)
    return dataclasses.replace(state, **updates)


def propagate_free(prop: Continuous, trial, state, generator, eshift: float,
                   xi=None):
    """One free-projection step (no phaseless constraint): the weight takes
    |exp(cmf + dt eshift)|, the walker phase its argument. The force bias,
    off by default, is formed only when asked for."""
    inner = prop.inner
    if prop.force_bias:
        ga, gb, _ = trial_greens(trial, state.phia, state.phib,
                                 getattr(inner, "uses_full_g", False))
    else:
        ga = gb = None
    first, second, xi = _half_steps(prop, state, generator, xi)
    phia, phib = first(state.phia, state.phib)
    fac = two_body_factors(prop, trial, ga, gb, state.nwalkers, generator,
                           xi)
    phia, phib = inner.apply_vhs(phia, phib, fac.xshifted)
    phia, phib = second(phia, phib)
    log_o_new = trial_log_overlap(trial, phia, phib)
    arg = fac.cmf + prop.dt * eshift
    return dataclasses.replace(
        state,
        phia=phia,
        phib=phib,
        weight=state.weight * torch.exp(arg.real),
        phase=state.phase * torch.exp(1j * arg.imag).to(state.phase.dtype),
        log_ovlp=log_o_new,
    )
