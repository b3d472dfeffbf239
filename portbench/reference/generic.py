"""Plain reference of the Generic (Cholesky) phaseless model.

From the raw integrals the benchmark draws (``h1e`` [M, M], ``chol``
[M, M, X] real, (ik|jl) = sum_x L[i,k,x] L[j,l,x]) and an RHF identity
trial (the first nup / ndown orbitals), everything the step needs is worked
out again here:

* h1e_mod = H1 - 0.5 sum_{k x} L[i,k,x] L[j,k,x];
* the mean-field shift mf_x = i sum_ik L[i,k,x] (G_T,a + G_T,b)[i,k] and
  B_{T/2} = expm(-dt/2 (h1e_mod - i sum_x mf_x L_x));
* the force bias xbar = -sqrt(dt) (i vbias - mf), vbias_x = sum_s
  sum_{i m} rchol_s[x, i, m] Ghalf_s[i, m], rchol_s[x] = psi_s^H L_x;
* VHS = i sqrt(dt) sum_x L_x (x - xbar)_x;
* the local energy from the half-rotated Green's functions: one-body
  sum rh1_s Ghalf_s + ecore, Coulomb 0.5 (sum_s X_s)^2, exchange
  -0.5 sum_s sum_x tr(T_x T_x), T_x = rchol_s[x] Ghalf_s^T.
"""

from __future__ import annotations

import math

import torch


class GenericModel:
    """The Generic Hamiltonian and its identity trial at ``dtype``
    (complex128: the reference; complex64: the control)."""

    walker_chunk = 512   # walkers a block of the check's energies

    def __init__(self, h1e: torch.Tensor, chol: torch.Tensor, nup: int,
                 ndown: int, ecore: float, dt: float, *,
                 dtype=torch.complex128):
        dev = chol.device
        m, _, nx = chol.shape
        self.dtype = dtype
        self.dt = float(dt)
        self.ecore = float(ecore)
        # Derived quantities in float64 first, then cast.
        h1 = h1e.to(torch.float64)
        lx = chol.to(torch.float64)
        flat = lx.reshape(m, m * nx)
        h1e_mod = h1 - 0.5 * (flat @ flat.T)
        eye = torch.eye(m, dtype=torch.complex128, device=dev)
        psia, psib = eye[:, :nup], eye[:, :ndown]
        gt = sum(p.conj() @ torch.linalg.solve(p.T @ p.conj(), p.T)
                 for p in (psia, psib))
        lflat = lx.reshape(m * m, nx).to(torch.complex128)
        mf = 1j * (gt.reshape(-1) @ lflat)
        shift = 1j * (lflat @ mf).reshape(m, m)
        bh1 = torch.linalg.matrix_exp(-0.5 * self.dt * (h1e_mod - shift))
        rchol = [torch.einsum("pi,pmx->xim", p.conj(), lx.to(torch.complex128))
                 for p in (psia, psib)]
        rh1 = [p.conj().T @ h1.to(torch.complex128) for p in (psia, psib)]
        self.psia, self.psib = psia.to(dtype), psib.to(dtype)
        self.mf_shift = mf.to(dtype)
        self.bh1 = bh1.to(dtype)
        self.rchola, self.rcholb = (r.to(dtype) for r in rchol)
        self.rh1a, self.rh1b = (r.to(dtype) for r in rh1)
        self.chol_t = lx.permute(2, 0, 1).reshape(nx, m * m).to(dtype)

    def apply_bh1(self, phia, phib):
        return self.bh1 @ phia, self.bh1 @ phib

    def _vbias(self, gha, ghb):
        return (torch.einsum("xim,wim->wx", self.rchola, gha)
                + torch.einsum("xim,wim->wx", self.rcholb, ghb))

    def force_bias(self, gha, ghb):
        return -math.sqrt(self.dt) * (1j * self._vbias(gha, ghb)
                                      - self.mf_shift)

    def vhs(self, xs):
        m = self.bh1.shape[-1]
        v = (1j * math.sqrt(self.dt)) * (xs.to(self.dtype) @ self.chol_t)
        return v.reshape(-1, m, m)

    def local_energy(self, gha, ghb):
        e1b = (torch.einsum("im,wim->w", self.rh1a, gha)
               + torch.einsum("im,wim->w", self.rh1b, ghb) + self.ecore)
        ecoul = torch.sum(self._vbias(gha, ghb) ** 2, dim=-1)
        exx = 0
        for rc, gh in ((self.rchola, gha), (self.rcholb, ghb)):
            t = torch.einsum("xim,wjm->wxij", rc, gh)
            exx = exx + torch.einsum("wxij,wxji->w", t, t)
        e2b = 0.5 * (ecoul - exx)
        return e1b + e2b, e1b, e2b
