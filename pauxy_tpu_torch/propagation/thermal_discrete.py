"""Finite-temperature discrete-HS (Hirsch) propagation for Hubbard.

Counterpart of ``pauxy_tpu/propagation/thermal_discrete.py``: per time
slice a sequential single-site heat-bath sweep with rank-1 Green's-function
updates

    R_s(x) = 1 + (1 - G_s[i,i]) delta[x, s],
    p(x)   = max(0, Re(R_up R_dn)) / 2,   weight *= sum_x p(x),
    G_s   <- G_s - delta/denom * outer(G_s[:, i], (e_i - G_s[i, :])),

then the slice propagator B = diag(BV) BH1 is pushed into the binned stack.
G at the slice boundary is re-stratified from the stack (``nbins + 1``
factors through ``walkers/thermal_state``'s QDT: the cpqr kernel and
kernel B on the card) at bin boundaries and every ``wrap_stabilize``
slices, and wrapped to the next boundary (BH1 G BH1^-1) in between. The
site sweep is plain tensor code, a Python loop over the sites, as JAX's is
a ``scan`` (the zero-temperature sweep kernel computes a different
update and does not apply).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import thermal as th
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.walkers import thermal_state as tws


@dataclasses.dataclass
class ThermalDiscrete:
    """Discrete HS at T > 0."""

    BH1: torch.Tensor        # [2, M, M] expm(-dt (H1 - mu))
    BH1_inv: torch.Tensor    # [2, M, M] expm(+dt (H1 - mu))
    auxf: torch.Tensor       # [2, 2] field x spin
    aux_wfac: torch.Tensor   # [2]
    delta: torch.Tensor      # [2, 2] auxf - 1
    dt: float
    charge: bool = False
    free_projection: bool = False
    # Recompute G from the stack at least every this many slices (and at
    # every bin boundary); in between G is wrapped to the next boundary,
    # G <- BH1 G BH1^-1, an exact similarity transform because BH1 is built
    # at the trial's mu and equals the trial B_T slice.
    wrap_stabilize: int = 10

    def _sweep_greens_function(self, trial, state, ts: int) -> torch.Tensor:
        """G at the current slice boundary with the slice's BH1 applied:
        A = BH1 . right . stack[block-1] ... stack[0] .
        bin_full^{nbins-1-block} . BT^{ss-1-c}, as nbins + 1 factors (the
        trailing trial power, the other bins from the rolled stack, the
        head). Built before the slice's ``update_stack`` writes the
        stack."""
        block, c = divmod(ts, trial.stack_size)
        nbins, nw, m = state.nbins, state.nwalkers, state.nbasis
        rolled = torch.roll(state.stack, -(block + 1), dims=1)
        base = (torch.eye(m, dtype=state.right.dtype,
                          device=state.right.device) if c == 0
                else state.right)
        head = torch.matmul(self.BH1, base).expand(nw, 2, m, m)
        tail = trial.left_table[c].expand(nw, 1, 2, m, m)
        factors = torch.cat([tail, rolled[:, :nbins - 1], head[:, None]],
                            dim=1)                     # [w, nbins+1, 2, M, M]
        return th.greens_function_qdt(factors.transpose(1, 2))

    def _site_sweep(self, state, g: torch.Tensor, rs: torch.Tensor):
        """Sequential heat-bath site updates, batched over walkers, with
        the uniforms ``rs`` [M, w]. Returns (G, weight, BV [w, 2, M])."""
        m, nw = state.nbasis, state.nwalkers
        cdtype = g.dtype
        delta = self.delta.to(cdtype)
        auxf = self.auxf.to(cdtype)
        weight = state.weight
        bv = torch.ones((nw, 2, m), dtype=cdtype, device=g.device)
        for i in range(m):
            gii = g[:, :, i, i]                            # [w, 2]
            r1 = ((1 + (1 - gii[:, 0]) * delta[0, 0])
                  * (1 + (1 - gii[:, 1]) * delta[0, 1]))
            r2 = ((1 + (1 - gii[:, 0]) * delta[1, 0])
                  * (1 + (1 - gii[:, 1]) * delta[1, 1]))
            pr = torch.clamp_min(0.5 * torch.stack([r1, r2], -1).real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (weight > 0)
            weight = torch.where(alive, weight * norm,
                                 torch.zeros_like(weight))
            safe = torch.where(norm > 0, norm, torch.ones_like(norm))
            xi = (rs[i] >= pr[:, 0] / safe).long()         # [w]
            dx = delta[xi]                                 # [w, 2]
            g_col = g[:, :, :, i]                          # [w, 2, M]
            g_row = -g[:, :, i, :]
            g_row[:, :, i] += 1.0
            denom = 1 + (1 - gii) * dx
            g = g - (dx / denom)[:, :, None, None] * (
                g_col[:, :, :, None] * g_row[:, :, None, :])
            bv[:, :, i] = auxf[xi]
        return g, weight, bv

    def propagate(self, trial, state, ts: int,
                  draws: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """One time slice. ``draws`` are the slice's heat-bath uniforms
        [M, w] (constrained path) or its fields [w, M] in {0, 1} (free
        projection), drawn from ``generator`` unless given."""
        if self.free_projection:
            return self._propagate_free(trial, state, ts, draws, generator)
        if draws is None:
            draws = pmesh.draw(lambda shape: torch.rand(
                shape, generator=generator, dtype=state.weight.dtype,
                device=state.weight.device), (state.nbasis, state.nwalkers),
                walker_dim=1)
        if ts % trial.stack_size == 0 or ts % self.wrap_stabilize == 0:
            g = self._sweep_greens_function(trial, state, ts)
        else:
            g = state.G
        g, weight, bv = self._site_sweep(state, g, draws)
        b = bv[:, :, :, None] * self.BH1[None]            # diag(BV) BH1
        state = tws.update_stack(trial, state, b, ts)
        # Wrap to the next slice boundary, except at the last slice, where
        # the swept G is the full-path estimator G.
        if ts != trial.num_slices - 1:
            g = torch.matmul(torch.matmul(self.BH1, g), self.BH1_inv)
        # The constrained path's weight comes from the heat-bath ratios;
        # log_m0 has no consumer on it.
        weight = torch.where(torch.isfinite(weight), weight,
                             torch.zeros_like(weight))
        return dataclasses.replace(state, G=g, weight=weight)

    def _propagate_free(self, trial, state, ts: int, fields, generator):
        """Random fields, determinant-ratio weight with phase; the new G
        and log det G come from the stack (JAX's swept G of this path has
        no consumer and is not built)."""
        m, nw = state.nbasis, state.nwalkers
        cdtype = state.log_m0.dtype
        if fields is None:
            fields = pmesh.draw(lambda shape: torch.randint(
                0, 2, shape, generator=generator,
                device=state.weight.device), (nw, m), walker_dim=0)
        fields = fields.long()
        bv = self.auxf.to(cdtype)[fields].transpose(1, 2)  # [w, 2, M]
        wfac = torch.prod(self.aux_wfac.to(cdtype)[fields], dim=-1)
        b = bv[:, :, :, None] * self.BH1[None]
        log_m0_old = state.log_m0
        state = tws.update_stack(trial, state, b, ts)
        g_new, log_m0_new = tws.greens_function(state.stack)
        # det(G_old)/det(G_new) = det(1 + A_new)/det(1 + A_old); the cyclic
        # rotation between the sweep boundary and boundary 0 leaves the
        # determinant unchanged.
        log_oratio = torch.log(wfac) + torch.sum(log_m0_old - log_m0_new, -1)
        weight = state.weight * torch.exp(log_oratio.real)
        phase = state.phase * torch.exp(1j * log_oratio.imag).to(cdtype)
        weight = torch.where(torch.isfinite(weight), weight,
                             torch.zeros_like(weight))
        return dataclasses.replace(state, G=g_new, log_m0=log_m0_new,
                                   weight=weight, phase=phase)


def make_thermal_discrete(ham, trial, dt: float,
                          charge_decomposition: bool = False,
                          free_projection: bool = False,
                          mu: float | None = None, wrap_stabilize: int = 10,
                          *, device=None, dtype=None) -> ThermalDiscrete:
    """The discrete thermal propagator of a Hubbard Hamiltonian (host-side
    set-up, as in JAX). BH1 is built at the trial's mu (it must equal the
    trial B_T for the stack's left-fill algebra); a system mu differing
    from it is folded into the diagonal field factors,
    auxf *= e^{dt (mu_sys - mu_T)}."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    u = float(ham.U)
    dmu = 0.0 if mu is None else float(mu) - float(trial.mu)
    mu = float(trial.mu)
    if charge_decomposition:
        gamma = np.arccosh(np.exp(-0.5 * dt * u + 0j))
        auxf = np.array([[np.exp(gamma), np.exp(gamma)],
                         [np.exp(-gamma), np.exp(-gamma)]])
        aux_wfac = np.exp(0.5 * dt * u) * np.array([np.exp(-gamma),
                                                    np.exp(gamma)])
    else:
        if u < 0:
            # arccosh(e^{dt U/2}) is complex for attractive U: the spin HS
            # decomposition does not exist.
            raise ValueError(
                "discrete spin decomposition requires U >= 0; use "
                "propagator {'charge_decomposition': true} for attractive U")
        gamma = np.arccosh(np.exp(0.5 * dt * u))
        auxf = np.array([[np.exp(gamma), np.exp(-gamma)],
                         [np.exp(-gamma), np.exp(gamma)]])
        aux_wfac = np.array([1.0, 1.0])
    if not ham.symmetric:
        auxf = auxf * np.exp(-0.5 * dt * u)
    auxf = auxf.astype(complex) * np.exp(dt * dmu)
    h1 = ham.T.cpu().numpy()           # bare hopping: U is in the fields
    eye = np.eye(ham.nbasis)
    bh1 = np.stack([scipy.linalg.expm(-dt * (h1[s] - mu * eye))
                    for s in (0, 1)])
    bh1_inv = np.stack([scipy.linalg.expm(dt * (h1[s] - mu * eye))
                        for s in (0, 1)])

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(prec.np_cplx))).to(device)

    return ThermalDiscrete(
        BH1=dev(bh1), BH1_inv=dev(bh1_inv), auxf=dev(auxf),
        aux_wfac=dev(aux_wfac), delta=dev(auxf - 1), dt=float(dt),
        charge=bool(charge_decomposition),
        free_projection=bool(free_projection),
        wrap_stabilize=max(1, int(wrap_stabilize)))
