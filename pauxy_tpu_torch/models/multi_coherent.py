"""Multi-coherent-state trials for the Hubbard-Holstein model.

Counterpart of ``pauxy_tpu/models/multi_coherent.py``. The trial is

  |Psi_T> = sum_p c_p |psi_p> (x) |phi_B(shift_p)>,

a sum of (Slater determinant x coherent phonon state) components. The
walker stays one determinant phi with phonon coordinates X (the usual
``WalkerState``); every per-component quantity is a batched operation over
[w, P] with log-space component weights

  log u_p = log conj(c_p) + logdet S_pa + logdet S_pb + log phi_B,p(X),
  log phi_B,p(X) = -(m w0 / 2) sum_i (X_i - shift_p_i)^2.

The [w, P] overlap matrices' log-dets and inverses come from kernel B in
one pass (``clinalg.inv_logdet``). Without explicit stacks the trial is
the coherent-state trial symmetrised over the nx * ny lattice
translations, with uniform coefficients.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import clinalg


class MultiCoherentTrial(nn.Module):
    """Buffers: ``psi`` [P, M, na + nb] component determinants, ``shifts``
    [P, M] real phonon displacements, ``coeffs`` [P], the walkers' initial
    determinant ``inita`` / ``initb`` and ``shift`` [M] (the leading
    component's, which seeds the walkers' X)."""

    name = "multi_coherent"

    def __init__(self, psi, shifts, coeffs, inita, initb, shift, *,
                 nup: int, m: float, w0: float, etrial: float = 0.0):
        super().__init__()
        self.register_buffer("psi", psi)
        self.register_buffer("shifts", shifts)
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("inita", inita)
        self.register_buffer("initb", initb)
        self.register_buffer("shift", shift)
        self.nup = int(nup)
        self.m = float(m)
        self.w0 = float(w0)
        self.etrial = float(etrial)

    @property
    def nperms(self) -> int:
        return self.psi.shape[0]

    @property
    def nbasis(self) -> int:
        return self.psi.shape[1]

    @property
    def ndown(self) -> int:
        return self.psi.shape[2] - self.nup


def boson_log_value(trial: MultiCoherentTrial, x) -> torch.Tensor:
    """log phi_B,p(X) [w, P], the order-0 oscillator product,
    unnormalised."""
    d = x[:, None, :] - trial.shifts[None, :, :]
    return -0.5 * trial.m * trial.w0 * torch.sum(d * d, dim=-1)


def _overlaps(trial: MultiCoherentTrial, phia, phib):
    """The component overlap matrices S_ps = t_ps^H phi_s, [w, P, n, n]."""
    na = trial.nup
    return (torch.einsum("pmi,wmj->wpij", trial.psi[:, :, :na].conj(), phia),
            torch.einsum("pmi,wmj->wpij", trial.psi[:, :, na:].conj(), phib))


def electron_log_dets(trial: MultiCoherentTrial, phia, phib):
    """log det S_pa + log det S_pb [w, P], one pass of kernel B a spin.
    They do not depend on X: a phonon move reuses them at X and X'."""
    sa, sb = _overlaps(trial, phia, phib)
    return clinalg.slogdet(sa) + clinalg.slogdet(sb)


def log_weights(trial: MultiCoherentTrial, logd, x):
    """log u_p from the components' log det S_pa + log det S_pb."""
    logb = boson_log_value(trial, x).to(logd.dtype)
    return logd + logb + torch.log(trial.coeffs.conj())[None, :]


def _components(trial: MultiCoherentTrial, phia, phib, x):
    """(log u_p [w, P], S_pa^-1 [w, P, na, na], S_pb^-1), from one pass of
    kernel B per spin."""
    sa, sb = _overlaps(trial, phia, phib)
    lda, inva = clinalg.inv_logdet(sa)
    ldb, invb = clinalg.inv_logdet(sb)
    return log_weights(trial, lda + ldb, x), inva, invb


def _normalised(logw: torch.Tensor):
    """(u_p / max |u|, its sum over p): the scale-free weights."""
    ref = torch.amax(logw.real, dim=-1, keepdim=True)
    u = torch.exp(logw - ref)
    return u, ref[:, 0]


def mixture_weights(logw: torch.Tensor) -> torch.Tensor:
    """The normalised component weights v_p = u_p / sum_p u_p [w, P]."""
    u, _ = _normalised(logw)
    return u / torch.sum(u, dim=-1, keepdim=True)


def log_sum(logw: torch.Tensor) -> torch.Tensor:
    """log sum_p u_p (complex log-sum-exp), [w]."""
    u, ref = _normalised(logw)
    return torch.log(torch.sum(u, dim=-1)) + ref


def component_log_weights(trial: MultiCoherentTrial, phia, phib, x):
    """(log u_p [w, P] complex, S_pa [w, P, na, na], S_pb): the log
    weights (log-dets only) and the component overlap matrices."""
    sa, sb = _overlaps(trial, phia, phib)
    logd = clinalg.slogdet(sa) + clinalg.slogdet(sb)
    return log_weights(trial, logd, x), sa, sb


def mc_log_overlap(trial: MultiCoherentTrial, phia, phib, x) -> torch.Tensor:
    """log <Psi_T|phi, X> = log sum_p u_p (complex log-sum-exp), [w]."""
    return log_sum(log_weights(trial, electron_log_dets(trial, phia, phib),
                               x))


def mc_greens_function(trial: MultiCoherentTrial, phia, phib, x):
    """(Gi [w, P, 2, M, M], comp_w [w, P]): per-component Green's functions
    G_p = (phi S_p^-1 t_p^H)^T and the normalised mixture weights."""
    na = trial.nup
    logw, inva, invb = _components(trial, phia, phib, x)
    comp_w = mixture_weights(logw)

    def greens(inv, t, phi):
        phiinv = torch.einsum("wme,wpek->wpmk", phi, inv)
        return torch.einsum("wpmk,pnk->wpnm", phiinv, t.conj())

    ga = greens(inva, trial.psi[:, :, :na], phia)
    gb = greens(invb, trial.psi[:, :, na:], phib)
    return torch.stack([ga, gb], dim=2), comp_w


def phonon_terms(trial: MultiCoherentTrial, v, x):
    """(gradient [w, M], lap_over_phi [w, M]) of the phonon mixture at X
    from its normalised weights v [w, P]: grad = sum_p v_p grad log
    phi_B,p and lap = sum_p v_p (lap phi_B,p / phi_B,p)."""
    mw = trial.m * trial.w0
    d = x[:, None, :] - trial.shifts[None, :, :]
    grad = torch.einsum("wp,wpm->wm", v, (-mw * d).to(v.dtype))
    lap = torch.einsum("wp,wpm->wm", v, (mw * mw * d * d - mw).to(v.dtype))
    return grad, lap


def mc_boson_mixture(trial: MultiCoherentTrial, phia, phib, x):
    """(gradient [w, M], lap_over_phi [w, M], comp_weights [w, P]) of the
    phonon mixture at X (``phonon_terms``), v the normalised weights."""
    v = mixture_weights(log_weights(
        trial, electron_log_dets(trial, phia, phib), x))
    return (*phonon_terms(trial, v, x), v)


def _translation_perms(ham) -> list:
    """Site permutations of the nx * ny lattice translations."""
    nx, ny = int(ham.nx), int(ham.ny)
    perms = []
    for dy in range(ny):
        for dx in range(nx):
            perms.append(np.array([((iy + dy) % ny) * nx + (ix + dx) % nx
                                   for iy in range(ny) for ix in range(nx)]))
    return perms


def multi_coherent_trial(ham, psi_stack=None, shift_stack=None, coeffs=None,
                         verbose: bool = False, *, device=None,
                         dtype=None) -> MultiCoherentTrial:
    """The trial from explicit stacks psi [P, M, na + nb], shifts [P, M]
    and coefficients [P]; without them the coherent-state trial
    symmetrised over the lattice translations, coefficients 1/sqrt(P).
    ``etrial`` is the mixture's energy at the leading component."""
    from pauxy_tpu_torch.models.hubbard_holstein import coherent_state_trial

    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    na = ham.nup
    if psi_stack is None:
        base = coherent_state_trial(ham, device="cpu", dtype=dtype)
        psi0 = np.concatenate([base.psia.numpy(), base.psib.numpy()], axis=1)
        shift0 = base.shift.numpy()
        perms = _translation_perms(ham)
        psi_stack = np.stack([psi0[p, :] for p in perms])
        shift_stack = np.stack([shift0[p] for p in perms])
        coeffs = np.ones(len(perms)) / np.sqrt(len(perms))
    psi_stack = np.asarray(psi_stack, dtype=prec.np_cplx)
    shift_stack = np.asarray(shift_stack, dtype=prec.np_real)
    coeffs = np.asarray(coeffs, dtype=prec.np_cplx)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    trial = MultiCoherentTrial(
        dev(psi_stack), dev(shift_stack), dev(coeffs),
        dev(psi_stack[0, :, :na]), dev(psi_stack[0, :, na:]),
        dev(shift_stack[0]), nup=na, m=ham.m, w0=ham.w0)
    trial.etrial = _mc_trial_energy(ham, trial)
    if verbose:
        print(f"# Multi-coherent trial: {len(coeffs)} components, "
              f"E_T = {trial.etrial:.8f}")
    return trial


def _mc_trial_energy(ham, trial: MultiCoherentTrial) -> float:
    """The mixture's local energy at phi = the leading component and
    X = its shift."""
    from pauxy_tpu_torch.estimators import local_energy as le

    phia, phib = trial.inita[None], trial.initb[None]
    x = trial.shift[None]
    gi, comp_w = mc_greens_function(trial, phia, phib, x)
    _, lap, _ = mc_boson_mixture(trial, phia, phib, x)
    etot, _, _ = le.local_energy_multi_coherent(ham, gi, comp_w, x, lap)
    return float(etot.real[0])
