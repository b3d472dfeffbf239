"""Discrete Hubbard-Stratonovich (Hirsch) propagation for the Hubbard model.

Counterpart of ``pauxy_tpu/propagation/hirsch.py``: constrained-path CPMC
with a sequential single-site sweep, batched over walkers. A step is a
kinetic half-step B_{T/2} with the real-part/phase constraint, the site
sweep, a second kinetic half-step, and the eshift growth factor.

The sweep has two implementations, chosen at build time by
``_auto_sweep_kernel`` exactly as the JAX package chooses between its
``lax.scan`` and Pallas paths:

* ``"kernel"``: the whole propagation is real (spin decomposition, real
  hopping, real trial), so the sweep runs in real arithmetic in one CUDA
  kernel (``ops/sweep_cuda``), with S^-1 from kernel B on real input;
* ``"scan"``: the general complex path, a Python loop over sites of
  batched tensor operations.

Both routes return the chosen fields, which a back-propagation buffer
records at ``bp_ix``. Besides the sweep: the whole-lattice
``two_body_mode='direct'`` update (dynamic force bias), free projection
(fields 50/50, |aux_wfac| into the weight, its phase into the walker's) and
``kinetic_kspace`` (B_{T/2} diagonal in momentum space, by ``torch.fft``).
A GHF trial (``models/ghf``) takes its own step, as in JAX: dense kinetic
half-steps with the GHF overlap, and a site sweep batched over walkers and
determinants (the joint two-row ratio of each determinant, then two
sequential Sherman-Morrison updates of S_d^-1), a Python loop over sites
of small batched operations with no kernel (JAX's is a ``lax.scan``).
On a walker mesh (``parallel/mesh``) each rank sweeps its own walkers
with the sweep kernel, so ``mesh=`` (JAX's per-shard ``shard_map``
dispatch) needs nothing more; its draws are the rank's slice of the whole
population's (``mesh.draw``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.linalg
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import ghf
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.ops import clinalg, greens, sweep_cuda
from pauxy_tpu_torch.parallel import mesh as pmesh

SWEEP_KERNELS = ("scan", "kernel")
TWO_BODY_MODES = ("single_site", "direct")


class Hirsch(nn.Module):
    """Discrete HS propagator (spin or charge decomposition).

    Buffers, with gamma = arccosh(e^{+/- dt U / 2}):
      BT2 [2, M, M]   expm(-dt/2 T) (T, not h1e_mod)
      auxf [2, 2]     e^{+/- gamma} e^{-dt U/2} per field and spin
      aux_wfac [2]    1 (spin) or e^{dt U/2 -/+ gamma} (charge)
    """

    # The driver's eshift follows the projected energy (no hybrid energy).
    hybrid = False

    def __init__(self, BT2, auxf, aux_wfac, *, dt: float,
                 charge: bool = False, gamma: complex = 0.0,
                 sweep_kernel: str = "scan", free_projection: bool = False,
                 two_body_mode: str = "single_site", btk=None, nx: int = 0,
                 ny: int = 0):
        super().__init__()
        if sweep_kernel not in SWEEP_KERNELS:
            raise ValueError(f"sweep_kernel {sweep_kernel!r}, want one of "
                             f"{SWEEP_KERNELS}")
        if two_body_mode not in TWO_BODY_MODES:
            raise ValueError(f"two_body_mode {two_body_mode!r}, want one of "
                             f"{TWO_BODY_MODES}")
        self.register_buffer("BT2", BT2)
        self.register_buffer("auxf", auxf)
        self.register_buffer("aux_wfac", aux_wfac)
        # exp(-dt/2 eps_k) [ny, nx] on the FFT grid, or None (dense BT2).
        self.register_buffer("btk", btk)
        self.dt = float(dt)
        self.charge = bool(charge)
        self.gamma = complex(gamma)
        self.sweep_kernel = sweep_kernel
        self.free_projection = bool(free_projection)
        self.two_body_mode = two_body_mode
        self.nx = int(nx)
        self.ny = int(ny)

    @property
    def delta(self) -> torch.Tensor:
        return self.auxf - 1.0

    def _apply_bt2_kspace(self, phi: torch.Tensor) -> torch.Tensor:
        """B_{T/2} phi as a diagonal in momentum space (2-D FFT over the
        lattice)."""
        w, m, n = phi.shape
        gk = torch.fft.fft2(phi.reshape(w, self.ny, self.nx, n), dim=(1, 2))
        gk = gk * self.btk[None, :, :, None]
        return torch.fft.ifft2(gk, dim=(1, 2)).reshape(w, m, n)

    def _kinetic_half_step(self, trial, state):
        """B_{T/2} phi and the constraint: weight *= Re(ratio) where
        |arg ratio| < pi/2, else 0."""
        if self.btk is not None:
            phia = self._apply_bt2_kspace(state.phia)
            phib = self._apply_bt2_kspace(state.phib)
        else:
            phia = torch.matmul(self.BT2[0], state.phia)
            phib = torch.matmul(self.BT2[1], state.phib)
        log_new = (greens.log_overlap(phia, trial.psia)
                   + greens.log_overlap(phib, trial.psib)
                   ).to(state.log_ovlp.dtype)
        ratio = torch.exp(log_new - state.log_ovlp)
        phase_ok = torch.angle(ratio).abs() < 0.5 * math.pi
        weight = torch.where(phase_ok, state.weight * ratio.real,
                             torch.zeros_like(state.weight))
        return dataclasses.replace(state, phia=phia, phib=phib,
                                   weight=weight, log_ovlp=log_new)

    def _draws(self, state, generator, rs):
        """Uniform field draws [M, w], walker last, unless given."""
        if rs is not None:
            return rs
        return pmesh.draw(lambda shape: torch.rand(
            shape, generator=generator, dtype=state.weight.dtype,
            device=state.weight.device), (state.nbasis, state.nwalkers),
            walker_dim=1)

    def _site_sweep(self, trial, state, generator=None, rs=None):
        """Sequential single-site updates; returns (state, fields [w, M])."""
        if self.sweep_kernel == "kernel":
            return self._site_sweep_kernel(trial, state, generator, rs)
        rs = self._draws(state, generator, rs)
        m = state.nbasis
        delta = self.delta
        wfac = self.aux_wfac
        psia, psib = trial.psia, trial.psib
        # Maintained inverse overlaps S^-1, S = psi^H phi.
        inva = clinalg.inv(torch.einsum("mi,wmj->wij", psia.conj(),
                                        state.phia))
        invb = clinalg.inv(torch.einsum("mi,wmj->wij", psib.conj(),
                                        state.phib))

        def gii(inv, row, psi_row):
            q = torch.einsum("wba,wb->wa", inv, row)
            return torch.einsum("a,wa->w", psi_row.conj(), q)

        def sherman_morrison(inv, u, vt):
            t1 = torch.einsum("wab,b->wa", inv, u)
            t2 = torch.einsum("wa,wab->wb", vt, inv)
            denom = 1.0 + torch.einsum("wa,wa->w", vt, t1)
            return inv - t1[:, :, None] * t2[:, None, :] / denom[:, None,
                                                                 None]

        phia = state.phia.clone()
        phib = state.phib.clone()
        weight = state.weight
        dlog = torch.zeros_like(state.log_ovlp)
        zero = torch.zeros_like(dlog)
        fields = []
        for i in range(m):
            row_a = phia[:, i, :].clone()
            row_b = phib[:, i, :].clone()
            ga = gii(inva, row_a, psia[i])
            gb = gii(invb, row_b, psib[i])
            r1 = (1 + delta[0, 0] * ga) * (1 + delta[0, 1] * gb)
            r2 = (1 + delta[1, 0] * ga) * (1 + delta[1, 1] * gb)
            probs = 0.5 * torch.stack([r1, r2], -1) * wfac[None, :]
            pr = torch.clamp_min(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (weight.abs() > 0)
            safe = torch.where(alive, norm, torch.ones_like(norm))
            xi = (rs[i] >= pr[:, 0] / safe).long()
            weight = torch.where(alive, weight * norm,
                                 torch.zeros_like(weight))
            chosen = torch.gather(probs, 1, xi[:, None])[:, 0]
            dlog = dlog + torch.where(alive, torch.log(2.0 * chosen), zero)
            da = torch.where(alive, delta[xi, 0], zero)
            db = torch.where(alive, delta[xi, 1], zero)
            vt_a = row_a * da[:, None]
            vt_b = row_b * db[:, None]
            phia[:, i, :] += vt_a
            phib[:, i, :] += vt_b
            inva = sherman_morrison(inva, psia[i].conj(), vt_a)
            invb = sherman_morrison(invb, psib[i].conj(), vt_b)
            fields.append(xi.to(torch.int32))
        return (dataclasses.replace(state, phia=phia, phib=phib,
                                    weight=weight,
                                    log_ovlp=state.log_ovlp + dlog),
                torch.stack(fields, dim=1))

    def _site_sweep_kernel(self, trial, state, generator=None, rs=None):
        """The same sweep in real arithmetic, one launch of the sweep
        kernel; S^-1 from kernel B on real input."""
        cdtype = state.phia.dtype
        rdtype = state.weight.dtype
        psia = trial.psia.real.to(rdtype)
        psib = trial.psib.real.to(rdtype)
        phia = state.phia.real.to(rdtype)
        phib = state.phib.real.to(rdtype)
        inva = clinalg.inv(torch.einsum("mi,wmj->wij", psia, phia))
        invb = clinalg.inv(torch.einsum("mi,wmj->wij", psib, phib))
        rs = self._draws(state, generator, rs)
        phia, phib, weight, dlog, fields = sweep_cuda.hirsch_sweep_real(
            psia, psib, self.delta.real.to(rdtype),
            self.aux_wfac.real.to(rdtype), phia, phib, inva, invb, rs,
            state.weight)
        return (dataclasses.replace(state, phia=phia.to(cdtype),
                                    phib=phib.to(cdtype), weight=weight,
                                    log_ovlp=state.log_ovlp
                                    + dlog.to(cdtype)),
                fields)

    def _two_body_direct(self, trial, state, generator=None, rs=None):
        """Whole-lattice discrete update with the dynamic force bias from
        the current diagonal of G: every site's field drawn at once from
        ``rs`` [w, M] uniforms, then one diagonal scaling. Returns
        (state, fields [w, M])."""
        m, nw = state.nbasis, state.nwalkers
        cdtype = state.phia.dtype
        gamma = torch.tensor(self.gamma, dtype=cdtype,
                             device=state.phia.device)
        psia, psib = trial.psia, trial.psib
        inva = clinalg.inv(torch.einsum("mi,wmj->wij", psia.conj(),
                                        state.phia))
        invb = clinalg.inv(torch.einsum("mi,wmj->wij", psib.conj(),
                                        state.phib))
        nia = torch.einsum("ia,wba,wib->wi", psia.conj(), inva, state.phia)
        nib = torch.einsum("ia,wba,wib->wi", psib.conj(), invb, state.phib)
        fb_term = (nia + nib - 1.0) if self.charge else (nia - nib)
        pp = 0.5 * torch.exp(gamma * fb_term).real
        pm = 0.5 * torch.exp(-gamma * fb_term).real
        norm = pp + pm
        if rs is None:
            rs = pmesh.draw(lambda shape: torch.rand(
                shape, generator=generator, dtype=state.weight.dtype,
                device=state.weight.device), (nw, m), walker_dim=0)
        xi = (rs >= pp / norm).long()
        sign = torch.where(xi == 0, -1.0, 1.0).to(cdtype)
        fb_fac = torch.prod((0.5 * norm) * torch.exp(sign * gamma
                                                     * fb_term).real, dim=-1)
        phia = state.phia * self.auxf[xi, 0][:, :, None]
        phib = state.phib * self.auxf[xi, 1][:, :, None]
        wfac = torch.prod(self.aux_wfac[xi], dim=-1)
        log_new = (greens.log_overlap(phia, psia)
                   + greens.log_overlap(phib, psib)).to(state.log_ovlp.dtype)
        ratio = wfac * torch.exp(log_new - state.log_ovlp)
        phase_ok = torch.angle(ratio).abs() < 0.5 * math.pi
        weight = torch.where(phase_ok, state.weight * (fb_fac * ratio).real,
                             torch.zeros_like(state.weight))
        return (dataclasses.replace(state, phia=phia, phib=phib,
                                    weight=weight, log_ovlp=log_new),
                xi.to(torch.int32))

    def _propagate_constrained(self, trial, state, generator, eshift: float,
                               rs=None, bp_ix: int | None = None):
        """Kinetic half, site sweep (or the direct update; with a GHF trial
        the GHF half-steps and sweep), kinetic half, eshift growth; the
        fields go into the buffer at ``bp_ix``."""
        if isinstance(trial, ghf.GHFTrial):
            half, two_body = self._kinetic_half_step_ghf, self._site_sweep_ghf
        elif self.two_body_mode == "direct":
            half, two_body = self._kinetic_half_step, self._two_body_direct
        else:
            half, two_body = self._kinetic_half_step, self._site_sweep
        state = half(trial, state)
        state, fields = two_body(trial, state, generator, rs)
        state = half(trial, state)
        growth = math.exp(self.dt * float(np.real(eshift)))
        state = dataclasses.replace(state, weight=state.weight * growth)
        if state.configs is not None and bp_ix is not None:
            configs = state.configs.clone()
            configs[:, bp_ix] = fields.to(configs.dtype)
            state = dataclasses.replace(state, configs=configs)
        return state

    def _propagate_free(self, trial, state, generator, eshift: float,
                        bits=None):
        """Free projection: fields 50/50 (``bits`` [w, M] of 0/1, drawn
        unless given), |wfac| and the growth into the weight, the phase of
        wfac into the walker's phase; dense B_{T/2} on both sides."""
        phia = torch.matmul(self.BT2[0], state.phia)
        phib = torch.matmul(self.BT2[1], state.phib)
        if bits is None:
            bits = pmesh.draw(lambda shape: torch.rand(
                shape, generator=generator, dtype=state.weight.dtype,
                device=state.weight.device),
                (state.nwalkers, state.nbasis), walker_dim=0) < 0.5
        xi = bits.long()
        phia = torch.matmul(self.BT2[0], phia * self.auxf[xi, 0][:, :, None])
        phib = torch.matmul(self.BT2[1], phib * self.auxf[xi, 1][:, :, None])
        wfac = torch.prod(self.aux_wfac[xi], dim=-1)
        log_new = (greens.log_overlap(phia, trial.psia)
                   + greens.log_overlap(phib, trial.psib)
                   ).to(state.log_ovlp.dtype)
        growth = math.exp(self.dt * float(np.real(eshift)))
        return dataclasses.replace(
            state, phia=phia, phib=phib,
            weight=state.weight * wfac.abs() * growth,
            phase=state.phase * torch.exp(1j * torch.angle(wfac)).to(
                state.phase.dtype),
            log_ovlp=log_new)

    # ---- GHF trials -------------------------------------------------
    def _kinetic_half_step_ghf(self, trial, state):
        """Dense B_{T/2} phi and the constraint, with the GHF overlap."""
        phia = torch.matmul(self.BT2[0], state.phia)
        phib = torch.matmul(self.BT2[1], state.phib)
        log_new = ghf.ghf_log_overlap(trial, phia, phib).to(
            state.log_ovlp.dtype)
        ratio = torch.exp(log_new - state.log_ovlp)
        phase_ok = torch.angle(ratio).abs() < 0.5 * math.pi
        weight = torch.where(phase_ok, state.weight * ratio.real,
                             torch.zeros_like(state.weight))
        return dataclasses.replace(state, phia=phia, phib=phib,
                                   weight=weight, log_ovlp=log_new)

    def _site_sweep_ghf(self, trial, state, generator=None, rs=None):
        """Sequential single-site updates against a GHF trial, batched over
        walkers and determinants. Per site i and determinant d: the joint
        ratio of the two rows i (up) and i + M (down) of S_d for each
        field, r = (1 + d_up Guu)(1 + d_dn Gdd) - d_up d_dn Gud Gdu; the
        heat-bath choice from sum_d conj(c_d) r det S_d / <psi_T|phi>; the
        rows scaled; S_d^-1 updated for the up row, then (with the updated
        inverse) for the down row. Returns (state, fields [w, M])."""
        rs = self._draws(state, generator, rs)
        m = state.nbasis
        na = trial.nup
        delta = self.delta
        cconj = trial.coeffs.conj()                       # [D]
        tpsi = trial.psi.conj()                           # [D, 2M, ne]
        s = ghf.ghf_overlap_matrices(trial, state.phia, state.phib)
        logdets, binv = clinalg.inv_logdet(s)             # [w, D], S^-1
        ref = torch.amax(logdets.real, dim=-1, keepdim=True)
        ots = torch.exp(logdets - ref)                    # scale-free dets
        ot = torch.einsum("d,wd->w", cconj, ots)
        phia = state.phia.clone()
        phib = state.phib.clone()
        weight = state.weight
        dlog = torch.zeros_like(state.log_ovlp)
        zero = torch.zeros_like(dlog)
        d_up, d_dn = delta[:, 0], delta[:, 1]             # [2] by field
        fields = []
        for i in range(m):
            row_a = phia[:, i, :].clone()                 # [w, na]
            row_b = phib[:, i, :].clone()
            tup, tdn = tpsi[:, i], tpsi[:, i + m]         # [D, ne]
            u_a = torch.einsum("we,wdek->wdk", row_a, binv[:, :, :na])
            u_b = torch.einsum("we,wdek->wdk", row_b, binv[:, :, na:])
            guu = torch.einsum("wdk,dk->wd", u_a, tup)
            gdu = torch.einsum("wdk,dk->wd", u_a, tdn)
            gud = torch.einsum("wdk,dk->wd", u_b, tup)
            gdd = torch.einsum("wdk,dk->wd", u_b, tdn)
            r_d = ((1 + d_up * guu[..., None]) * (1 + d_dn * gdd[..., None])
                   - d_up * d_dn * (gud * gdu)[..., None])   # [w, D, 2]
            rtot = torch.einsum("d,wdx,wd->wx", cconj, r_d, ots) / ot[:, None]
            probs = 0.5 * rtot * self.aux_wfac[None, :]
            pr = torch.clamp_min(probs.real, 0.0)
            norm = pr.sum(-1)
            alive = (norm > 0) & (weight.abs() > 0)
            safe = torch.where(alive, norm, torch.ones_like(norm))
            xi = (rs[i] >= pr[:, 0] / safe).long()
            weight = torch.where(alive, weight * norm,
                                 torch.zeros_like(weight))
            chosen = torch.gather(rtot, 1, xi[:, None])[:, 0]
            dlog = dlog + torch.where(alive, torch.log(chosen.to(dlog.dtype)),
                                      zero)
            da = torch.where(alive, delta[xi, 0], zero)
            db = torch.where(alive, delta[xi, 1], zero)
            chosen_rd = torch.gather(
                r_d, 2, xi[:, None, None].expand(-1, r_d.shape[1], 1))[..., 0]
            ots = torch.where(alive[:, None], ots * chosen_rd, ots)
            ot = torch.einsum("d,wd->w", cconj, ots)
            vta = row_a * da[:, None]
            vtb = row_b * db[:, None]
            phia[:, i, :] += vta
            phib[:, i, :] += vtb
            bu = torch.einsum("wdek,dk->wde", binv, tup)
            denom1 = 1.0 + da[:, None] * guu
            binv = binv - (bu[..., None]
                           * (da[:, None, None] * u_a)[:, :, None, :]
                           / denom1[:, :, None, None])
            u_b2 = torch.einsum("we,wdek->wdk", row_b, binv[:, :, na:])
            gdd2 = torch.einsum("wdk,dk->wd", u_b2, tdn)
            bu2 = torch.einsum("wdek,dk->wde", binv, tdn)
            denom2 = 1.0 + db[:, None] * gdd2
            binv = binv - (bu2[..., None]
                           * (db[:, None, None] * u_b2)[:, :, None, :]
                           / denom2[:, :, None, None])
            fields.append(xi.to(torch.int32))
        return (dataclasses.replace(state, phia=phia, phib=phib,
                                    weight=weight,
                                    log_ovlp=state.log_ovlp + dlog),
                torch.stack(fields, dim=1))

    def propagate(self, trial, state, generator, eshift: float, rs=None, *,
                  bp_ix: int | None = None, ham=None):
        """One step. ``rs`` injects the step's draws (tests): the sweep's
        uniforms [M, w] (also the GHF sweep's), the direct update's
        uniforms [w, M] or free projection's field bits [w, M]; otherwise
        they come from ``generator``. ``bp_ix`` is the back-propagation
        buffer's slot; ``ham`` is unused (the continuous propagator's
        signature). A GHF trial takes the GHF step whatever the options,
        as in JAX."""
        if isinstance(trial, ghf.GHFTrial):
            return self._propagate_constrained(trial, state, generator,
                                               eshift, rs, bp_ix)
        if isinstance(trial, msd.MultiSlaterTrial):
            raise NotImplementedError(
                "the discrete propagator takes single-determinant and GHF "
                "trials only")
        if self.free_projection:
            return self._propagate_free(trial, state, generator, eshift, rs)
        return self._propagate_constrained(trial, state, generator, eshift,
                                           rs, bp_ix)


def make_hirsch(ham, trial, dt: float, charge_decomposition: bool = False,
                free_projection: bool = False,
                two_body_mode: str = "single_site",
                kinetic_kspace: bool = False, mesh=None, *, device=None,
                dtype=None) -> Hirsch:
    """Build the discrete propagator's tables (host-side expm; setup).

    The sweep's route comes from ``_auto_sweep_kernel``; the real-arithmetic
    kernel is never forced onto a complex system. ``mesh`` (JAX's) is
    accepted; the port's mesh needs no per-shard dispatch. The spin decomposition
    needs U >= 0. ``kinetic_kspace`` needs a circulant hopping matrix (a
    periodic lattice without twist or pinning fields).
    """
    # ``mesh`` is JAX's per-shard kernel dispatch: on the port's walker
    # mesh every rank sweeps its own walkers, so it changes nothing here.
    del mesh
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    t = ham.T.cpu().numpy()
    bt2 = np.stack([scipy.linalg.expm(-0.5 * dt * t[0]),
                    scipy.linalg.expm(-0.5 * dt * t[1])])
    btk = None
    nx = ny = 0
    if kinetic_kspace:
        nx, ny = int(ham.nx), int(ham.ny)
        # A circulant T on the (ny, nx) torus has the FFT of its column at
        # site 0 as eigenvalues (in float64 whatever the run's precision).
        t64 = t[0].astype(np.complex128)
        ek = np.fft.fft2(t64[:, 0].reshape(ny, nx))
        if np.abs(ek.imag).max() > 1e-10:
            raise ValueError(
                "kinetic_kspace requires a circulant hopping matrix "
                "(PBC, no twist/pinning)")
        btk = np.exp(-0.5 * dt * ek.real)
        f = np.fft.fft2(np.eye(nx * ny).reshape(nx * ny, ny, nx),
                        axes=(1, 2)).reshape(nx * ny, nx * ny)
        recon = f.conj().T @ (btk.reshape(-1)[:, None] * f) / (nx * ny)
        if np.abs(recon - scipy.linalg.expm(-0.5 * dt * t64)).max() > 1e-8:
            raise ValueError("kinetic_kspace: the momentum-space B_{T/2} "
                             "does not reproduce expm(-dt T / 2)")
    if charge_decomposition:
        gamma = np.arccosh(np.exp(-0.5 * dt * ham.U + 0j))
        auxf = np.array([[np.exp(gamma), np.exp(gamma)],
                         [np.exp(-gamma), np.exp(-gamma)]])
        aux_wfac = np.exp(0.5 * dt * ham.U) * np.array([np.exp(-gamma),
                                                        np.exp(gamma)])
    else:
        if ham.U < 0:
            raise ValueError(
                "discrete spin decomposition requires U >= 0; use "
                "propagator {'charge_decomposition': true} for attractive U")
        gamma = np.arccosh(np.exp(0.5 * dt * ham.U))
        auxf = np.array([[np.exp(gamma), np.exp(-gamma)],
                         [np.exp(-gamma), np.exp(gamma)]])
        aux_wfac = np.array([1.0, 1.0])
    auxf = auxf * np.exp(-0.5 * dt * ham.U)
    sweep_kernel = _auto_sweep_kernel(trial, t, auxf, aux_wfac,
                                      free_projection, two_body_mode)

    def buf(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(prec.np_cplx))).to(device)

    return Hirsch(buf(bt2), buf(auxf), buf(aux_wfac), dt=dt,
                  charge=charge_decomposition, gamma=complex(gamma),
                  sweep_kernel=sweep_kernel, free_projection=free_projection,
                  two_body_mode=two_body_mode,
                  btk=None if btk is None else buf(btk), nx=nx, ny=ny)


def _auto_sweep_kernel(trial, t, auxf, aux_wfac, free_projection,
                       two_body_mode) -> str:
    """``"kernel"`` when the whole propagation is provably real and small
    enough for the sweep kernel (spin decomposition, real hopping, a real
    single-determinant trial with both spins occupied, n <= 32, constrained
    path, single-site sweep), else ``"scan"``: the conditions of
    ``pauxy_tpu/propagation/hirsch.py:620-659``."""
    if free_projection or two_body_mode != "single_site":
        return "scan"
    if any(np.abs(np.asarray(x).imag).max() > 0 for x in (auxf, aux_wfac, t)):
        return "scan"
    mats = [getattr(trial, k, None) for k in ("psia", "psib", "inita",
                                              "initb")]
    if any(not isinstance(x, torch.Tensor) or x.dim() != 2 for x in mats):
        return "scan"
    host = [x.detach().cpu().numpy() for x in mats]
    if any(np.iscomplexobj(x) and x.size and np.abs(x.imag).max() > 0
           for x in host):
        return "scan"
    if min(host[0].shape[1], host[1].shape[1]) == 0:
        return "scan"
    if max(host[0].shape[1], host[1].shape[1]) > sweep_cuda.MAX_N:
        return "scan"
    return "kernel"
