"""Discrete-HS propagation for the Hubbard-Holstein model: Hirsch electron
updates and drift-diffusion (DMC) phonon moves.

Counterpart of ``pauxy_tpu/propagation/hirsch_dmc.py``. A step, in the
default (non-symmetric) Trotter order:

  1. electron half-step: phi <- diag(e^{k X/2}) B_{T/2} diag(e^{k X/2}) phi
     with k = dt/2 g sqrt(2 m w0), and the magnitude x cosine constraint;
  2. the Hirsch single-site sweep for the U term;
  3. a second electron half-step;
  4. the phonon drift-diffusion move with the DMC weight
     w *= exp(-dt/2 (E_B(X') + E_B(X) - 2 E_B^shift)).

``symmetric_trotter`` splits the phonon move into two half moves around
the electron block. With a coherent-state or Lang-Firsov trial the sweep
is the port's ``Hirsch._site_sweep`` (the sweep kernel when the
propagation is real, chosen by ``_auto_sweep_kernel`` as in JAX); with a
multi-coherent trial it is ``_site_sweep_mc``, the heat-bath ratio of the
whole mixture with each component's spin inverses kept by Sherman-Morrison,
a Python loop over sites of batched [w, P] operations with no kernel (the
inverses and log-dets it starts from come from kernel B).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import hubbard_holstein as hh
from pauxy_tpu_torch.models import multi_coherent as mcoh
from pauxy_tpu_torch.ops import greens
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.propagation.hirsch import Hirsch, make_hirsch


class DMCDraws(NamedTuple):
    """One step's draws (tests inject JAX's): the sweep's uniforms
    ``sweep`` [M, w], the phonon move's normals ``boson`` [w, M] and, with
    ``symmetric_trotter``, the second half move's ``boson2`` [w, M]."""

    sweep: torch.Tensor
    boson: torch.Tensor
    boson2: torch.Tensor | None = None


class HirschDMC(nn.Module):
    """The Hirsch tables (``hirsch``, a ``Hirsch``) and ``BT_half`` [2, M, M]
    = expm(-dt/2 T); ``cpl`` = g sqrt(2 m w0); ``eshift_boson`` the
    phonon local energy at the trial's shift."""

    # AFQMC's eshift follows the projected energy.
    hybrid = False

    def __init__(self, hirsch: Hirsch, BT_half, *, dt: float, m: float,
                 w0: float, cpl: float, eshift_boson: float = 0.0,
                 symmetric_trotter: bool = False):
        super().__init__()
        self.hirsch = hirsch
        self.register_buffer("BT_half", BT_half)
        self.dt = float(dt)
        self.m = float(m)
        self.w0 = float(w0)
        self.cpl = float(cpl)
        self.eshift_boson = float(eshift_boson)
        self.symmetric_trotter = bool(symmetric_trotter)

    def _kinetic(self, state, dt_half: float):
        """diag(e^{k X/2}) B_{T/2} diag(e^{k X/2}) applied to both spins."""
        gauge = torch.exp(0.5 * dt_half * self.cpl * state.X)[:, :, None]
        phia = gauge * torch.matmul(self.BT_half[0], state.phia * gauge)
        phib = gauge * torch.matmul(self.BT_half[1], state.phib * gauge)
        return phia, phib

    def _constrained(self, state, phia, phib, log_new):
        """weight *= |ratio| cos(arg ratio) where |arg ratio| < pi/2,
        else 0."""
        log_new = log_new.to(state.log_ovlp.dtype)
        ratio = torch.exp(log_new - state.log_ovlp)
        phase = torch.angle(ratio)
        ok = phase.abs() < 0.5 * math.pi
        cosine = torch.clamp_min(torch.cos(phase), 0.0)
        weight = torch.where(ok, state.weight * ratio.abs() * cosine,
                             torch.zeros_like(state.weight))
        return dataclasses.replace(state, phia=phia, phib=phib,
                                   weight=weight, log_ovlp=log_new)

    def _electron_half_step(self, trial, state, dt_half: float):
        """The kinetic and coupling half-step, then the constraint, with
        the trial's overlap (log-dets from kernel B)."""
        phia, phib = self._kinetic(state, dt_half)
        log_new = (greens.log_overlap(phia, trial.psia)
                   + greens.log_overlap(phib, trial.psib))
        return self._constrained(state, phia, phib, log_new)

    def _normals(self, state, generator, draws):
        if draws is not None:
            return draws
        return pmesh.draw(lambda shape: torch.randn(
            shape, generator=generator, dtype=state.X.dtype,
            device=state.X.device), state.X.shape, walker_dim=0)

    def _boson_move(self, trial, state, dt: float, generator=None,
                    normals=None):
        """Drift-diffusion move X' = X + dx + (dt/m) grad log phi_B(X),
        dx ~ N(0, dt/m), and the DMC weight."""
        shift = trial.shift
        x = state.X
        eloc_old = hh.ho_local_energy(x, self.m, self.w0, shift)
        drift = (dt / self.m) * hh.ho_gradient(x, self.m, self.w0, shift)
        dx = self._normals(state, generator, normals) * math.sqrt(dt / self.m)
        x_new = x + dx + drift
        eloc_new = hh.ho_local_energy(x_new, self.m, self.w0, shift)
        log_ratio = (hh.ho_log_value(x_new, self.m, self.w0, shift)
                     - hh.ho_log_value(x, self.m, self.w0, shift))
        weight = state.weight * torch.exp(
            -0.5 * dt * (eloc_new + eloc_old - 2 * self.eshift_boson))
        return dataclasses.replace(
            state, X=x_new, weight=weight,
            log_ovlp=state.log_ovlp + log_ratio.to(state.log_ovlp.dtype))

    # ---- multi-coherent trials ------------------------------------------
    def _electron_half_step_mc(self, trial, state, dt_half: float):
        """The half-step with the mixture's overlap."""
        phia, phib = self._kinetic(state, dt_half)
        log_new = mcoh.mc_log_overlap(trial, phia, phib, state.X)
        return self._constrained(state, phia, phib, log_new)

    def _site_sweep_mc(self, trial, state, generator=None, rs=None):
        """Site sweep against the mixture: per site the heat-bath ratio
        R(x) = sum_p u_p R_p(x) / sum_p u_p, each component's S_p^-1
        updated by Sherman-Morrison. Returns (state, fields [w, M])."""
        hirsch = self.hirsch
        m, nw = state.nbasis, state.nwalkers
        na = trial.nup
        cdtype = state.phia.dtype
        delta = hirsch.delta
        wfac = hirsch.aux_wfac
        ta = trial.psi[:, :, :na].conj()                 # [P, M, na]
        tb = trial.psi[:, :, na:].conj()
        logw, inva, invb = mcoh._components(trial, state.phia, state.phib,
                                            state.X)
        ots, _ = mcoh._normalised(logw)                  # scale-free u_p
        ot = torch.sum(ots, dim=-1)
        rs = hirsch._draws(state, generator, rs)

        def sherman_morrison(inv, u, vt, gii, dlt):
            # (S_p + u_p vt)^-1, u [P, n], vt [w, n].
            t1 = torch.einsum("wpab,pb->wpa", inv, u)
            t2 = torch.einsum("wa,wpab->wpb", vt, inv)
            denom = 1.0 + dlt[:, None] * gii
            return inv - (t1[..., None] * t2[:, :, None, :]
                          / denom[:, :, None, None])

        phia = state.phia.clone()
        phib = state.phib.clone()
        weight = state.weight
        dlog = torch.zeros(nw, dtype=cdtype, device=phia.device)
        zero = torch.zeros_like(dlog)
        fields = []
        for i in range(m):
            row_a = phia[:, i, :].clone()                # [w, na]
            row_b = phib[:, i, :].clone()
            tai, tbi = ta[:, i], tb[:, i]                # [P, n]
            ga = torch.einsum("pa,wpba,wb->wp", tai, inva, row_a)
            gb = torch.einsum("pa,wpba,wb->wp", tbi, invb, row_b)
            r_p = ((1 + delta[:, 0] * ga[..., None])
                   * (1 + delta[:, 1] * gb[..., None]))  # [w, P, 2]
            rtot = torch.einsum("wpx,wp->wx", r_p, ots) / ot[:, None]
            pr = torch.clamp_min((0.5 * rtot * wfac[None, :]).real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (weight.abs() > 0)
            safe = torch.where(alive, norm, torch.ones_like(norm))
            xi = (rs[i] >= pr[:, 0] / safe).long()
            weight = torch.where(alive, weight * norm,
                                 torch.zeros_like(weight))
            chosen = torch.gather(rtot, 1, xi[:, None])[:, 0]
            dlog = dlog + torch.where(alive, torch.log(chosen.to(cdtype)),
                                      zero)
            da = torch.where(alive, delta[xi, 0], zero)
            db = torch.where(alive, delta[xi, 1], zero)
            chosen_rp = torch.gather(
                r_p, 2, xi[:, None, None].expand(-1, r_p.shape[1], 1))[..., 0]
            ots = torch.where(alive[:, None], ots * chosen_rp, ots)
            ot = torch.sum(ots, dim=-1)
            vta = row_a * da[:, None]
            vtb = row_b * db[:, None]
            phia[:, i, :] += vta
            phib[:, i, :] += vtb
            inva = sherman_morrison(inva, tai, vta, ga, da)
            invb = sherman_morrison(invb, tbi, vtb, gb, db)
            fields.append(xi.to(torch.int32))
        return (dataclasses.replace(state, phia=phia, phib=phib,
                                    weight=weight,
                                    log_ovlp=state.log_ovlp + dlog),
                torch.stack(fields, dim=1))

    def _boson_move_mc(self, trial, state, dt: float, generator=None,
                       normals=None):
        """The drift-diffusion move with the mixture's drift and phonon
        local energy. The stored overlap becomes 2 log_new - log_old, so
        that the next electron half-step divides this move's trial-value
        ratio out of the weight (the reference's deferred division); a
        one-component mixture then follows the coherent-state path."""
        x = state.X
        # The electron log-dets do not change in the move: one pass of
        # kernel B a spin serves X and X'.
        logd = mcoh.electron_log_dets(trial, state.phia, state.phib)
        grad_old, lap_old = mcoh.phonon_terms(
            trial, mcoh.mixture_weights(mcoh.log_weights(trial, logd, x)), x)

        def eloc(lap, z):
            return (-0.5 * torch.sum(lap, -1).real / self.m
                    + 0.5 * self.m * self.w0 ** 2 * torch.sum(z * z, -1)
                    - 0.5 * self.w0 * z.shape[-1])

        drift = (dt / self.m) * grad_old.real
        dx = self._normals(state, generator, normals) * math.sqrt(dt / self.m)
        x_new = x + dx + drift
        logw_new = mcoh.log_weights(trial, logd, x_new)
        _, lap_new = mcoh.phonon_terms(trial, mcoh.mixture_weights(logw_new),
                                       x_new)
        log_new = mcoh.log_sum(logw_new)
        weight = state.weight * torch.exp(
            -0.5 * dt * (eloc(lap_new, x_new) + eloc(lap_old, x)
                         - 2 * self.eshift_boson))
        return dataclasses.replace(
            state, X=x_new, weight=weight,
            log_ovlp=(2.0 * log_new - state.log_ovlp).to(
                state.log_ovlp.dtype))

    def propagate(self, trial, state, generator, eshift: float,
                  rs: DMCDraws | None = None, *, bp_ix: int | None = None,
                  ham=None):
        """One step; ``rs`` injects its draws (``DMCDraws``), else they come
        from ``generator``. ``bp_ix`` and ``ham`` are unused (the other
        propagators' signature)."""
        mc = isinstance(trial, mcoh.MultiCoherentTrial)
        e_half = self._electron_half_step_mc if mc \
            else self._electron_half_step
        sweep = self._site_sweep_mc if mc else self.hirsch._site_sweep
        boson = self._boson_move_mc if mc else self._boson_move
        draws = rs if rs is not None else DMCDraws(None, None, None)
        if self.symmetric_trotter:
            state = boson(trial, state, 0.5 * self.dt, generator,
                          draws.boson)
        state = e_half(trial, state, 0.5 * self.dt)
        state, _ = sweep(trial, state, generator, draws.sweep)
        state = e_half(trial, state, 0.5 * self.dt)
        if self.symmetric_trotter:
            state = boson(trial, state, 0.5 * self.dt, generator,
                          draws.boson2)
        else:
            state = boson(trial, state, self.dt, generator, draws.boson)
        growth = math.exp(self.dt * float(np.real(eshift)))
        return dataclasses.replace(state, weight=state.weight * growth)


def make_hirsch_dmc(ham, trial, dt: float, lang_firsov: bool = False,
                    symmetric_trotter: bool = False, mesh=None, *,
                    device=None, dtype=None) -> HirschDMC:
    """Build the propagator (host-side expm; setup). ``lang_firsov``
    replaces U by the Lang-Firsov effective interaction in the Hirsch
    tables. ``mesh`` is accepted as in ``make_hirsch``: on the port's
    walker mesh each rank runs its own walkers. The trial must carry a phonon shift (coherent-state,
    Lang-Firsov or multi-coherent), else ``ValueError``."""
    if not hh.carries_phonons(trial):
        raise ValueError(
            "Hubbard-Holstein discrete propagation needs a phonon-aware "
            "trial providing a coherent-state shift (coherent_state, "
            f"lang_firsov, or multi-coherent); got {type(trial).__name__}")
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    ham_eff = ham
    if lang_firsov:
        _, ueff = hh._lf_params(ham)
        ham_eff = types.SimpleNamespace(T=ham.T, U=float(ueff), nx=ham.nx,
                                        ny=ham.ny)
    hirsch = make_hirsch(ham_eff, trial, dt, device=device, dtype=dtype)
    t = ham.T.cpu().numpy().astype(np.float64)
    bt_half = np.stack([scipy.linalg.expm(-0.5 * dt * t[0]),
                        scipy.linalg.expm(-0.5 * dt * t[1])])
    shift = trial.shift.detach().cpu().to(torch.float64)
    eshift_b = float(hh.ho_local_energy(shift, ham.m, ham.w0, shift))
    return HirschDMC(
        hirsch,
        torch.from_numpy(np.ascontiguousarray(bt_half.astype(prec.np_cplx))
                         ).to(device),
        dt=dt, m=ham.m, w0=ham.w0, cpl=ham.gsq2mw, eshift_boson=eshift_b,
        symmetric_trotter=symmetric_trotter)
