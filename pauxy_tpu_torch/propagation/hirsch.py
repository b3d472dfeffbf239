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

Not ported yet, each raising ``NotImplementedError``: free projection, the
whole-lattice ``two_body_mode='direct'`` update, ``kinetic_kspace``, the
GHF (multi-determinant) variants and a walker ``mesh``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.linalg
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import clinalg, greens, sweep_cuda

SWEEP_KERNELS = ("scan", "kernel")


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
                 sweep_kernel: str = "scan"):
        super().__init__()
        if sweep_kernel not in SWEEP_KERNELS:
            raise ValueError(f"sweep_kernel {sweep_kernel!r}, want one of "
                             f"{SWEEP_KERNELS}")
        self.register_buffer("BT2", BT2)
        self.register_buffer("auxf", auxf)
        self.register_buffer("aux_wfac", aux_wfac)
        self.dt = float(dt)
        self.charge = bool(charge)
        self.gamma = complex(gamma)
        self.sweep_kernel = sweep_kernel

    @property
    def delta(self) -> torch.Tensor:
        return self.auxf - 1.0

    def _kinetic_half_step(self, trial, state):
        """B_{T/2} phi and the constraint: weight *= Re(ratio) where
        |arg ratio| < pi/2, else 0."""
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
        return torch.rand((state.nbasis, state.nwalkers),
                          generator=generator, dtype=state.weight.dtype,
                          device=state.weight.device)

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

    def _propagate_constrained(self, trial, state, generator, eshift: float,
                               rs=None):
        """Kinetic half, site sweep, kinetic half, eshift growth."""
        state = self._kinetic_half_step(trial, state)
        state, _ = self._site_sweep(trial, state, generator, rs)
        state = self._kinetic_half_step(trial, state)
        growth = math.exp(self.dt * float(np.real(eshift)))
        return dataclasses.replace(state, weight=state.weight * growth)

    def propagate(self, trial, state, generator, eshift: float, rs=None):
        """One constrained-path step. ``rs`` [M, w] injects the sweep's
        uniform draws (tests); otherwise they come from ``generator``."""
        if getattr(trial, "psia", None) is None or trial.psia.dim() != 2:
            raise NotImplementedError(
                "the discrete propagator is ported for single-determinant "
                "trials only (no GHF)")
        return self._propagate_constrained(trial, state, generator, eshift,
                                           rs)


def make_hirsch(ham, trial, dt: float, charge_decomposition: bool = False,
                free_projection: bool = False,
                two_body_mode: str = "single_site",
                kinetic_kspace: bool = False, mesh=None, *, device=None,
                dtype=None) -> Hirsch:
    """Build the discrete propagator's tables (host-side expm; setup).

    The sweep's route comes from ``_auto_sweep_kernel``; the real-arithmetic
    kernel is never forced onto a complex system. The spin decomposition
    needs U >= 0.
    """
    missing = {"free_projection": free_projection,
               "two_body_mode='direct'": two_body_mode != "single_site",
               "kinetic_kspace": kinetic_kspace,
               "mesh": mesh is not None}
    if any(missing.values()):
        raise NotImplementedError(
            "not ported yet for the discrete propagator: "
            + ", ".join(k for k, v in missing.items() if v))
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    t = ham.T.cpu().numpy()
    bt2 = np.stack([scipy.linalg.expm(-0.5 * dt * t[0]),
                    scipy.linalg.expm(-0.5 * dt * t[1])])
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
                  sweep_kernel=sweep_kernel)


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
