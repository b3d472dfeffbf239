"""Plain reference of the 3D uniform electron gas in plane waves.

Built from (nup, ndown, rs, ecut) alone:

* the basis: integer vectors n with |n|^2 / 2 <= ecut, enumerated with x
  outermost and stably sorted by |n|^2 (the orbitals' order); the momentum
  transfers q: the same over 4 ecut, q = 0 dropped;
* L = rs (4 pi N / 3)^(1/3), vol = L^3, kfac = 2 pi / L, v(q) =
  4 pi / (kfac^2 |q|^2);
* the density operators rho_q[a, b] = sqrt(v(q) / (4 vol)) for every pair
  of orbitals with k_a - k_b = q, held as a list of (q, a, b);
* h1e_mod: kinetic kfac^2 |n|^2 / 2 less 1/(2 vol) sum_{j != i}
  4 pi / (kfac^2 |k_i - k_j|^2) on the diagonal; B_{T/2} its exponential;
* two fields a q: iA_q = i (rho_q + rho_q^T) and iB_q = -(rho_q - rho_q^T);
  VHS = sqrt(dt) sum_q (x+_q iA_q + x-_q iB_q); the force bias
  -sqrt(dt) (<iA_q>, <iB_q>) with <O> = sum_ab O_ab G_ab; no mean-field
  shift;
* the local energy: kinetic sum_m eps_m (G_a + G_b)_mm and
  1/(2 vol) sum_q v(q) [sum_{s s'} Gkpq_s Gpmq_s' - Gprod_a - Gprod_b],
  Gkpq(q) = sum_i G[i, k_i + q], Gpmq(q) = sum_i G[i, k_i - q],
  Gprod(q) = sum_ij G[j, k_i + q] G[i, k_j - q] (no Madelung term).
"""

from __future__ import annotations

import itertools
import math

import torch


def sorted_vectors(ecut: float):
    """Integer vectors with |n|^2 / 2 <= ecut in the basis order."""
    nmax = int(math.ceil(math.sqrt(2 * ecut)))
    rng = range(-nmax, nmax + 1)
    vecs = [v for v in itertools.product(rng, rng, rng)
            if 0.5 * (v[0] ** 2 + v[1] ** 2 + v[2] ** 2) <= ecut]
    return sorted(vecs, key=lambda v: v[0] ** 2 + v[1] ** 2 + v[2] ** 2)


class UEGModel:
    """The UEG and its RHF trial (the nup / ndown lowest plane waves) at
    ``dtype``."""

    walker_chunk = 256   # walkers a block of the check's dense G

    def __init__(self, nup: int, ndown: int, rs: float, ecut: float,
                 dt: float, *, device, dtype=torch.complex128):
        self.dtype = dtype
        self.dt = float(dt)
        ne = nup + ndown
        length = rs * (4.0 * ne * math.pi / 3.0) ** (1.0 / 3.0)
        self.vol = length ** 3
        kfac = 2 * math.pi / length
        basis = sorted_vectors(ecut)
        qvecs = [q for q in sorted_vectors(4 * ecut) if q != (0, 0, 0)]
        m, nq = len(basis), len(qvecs)
        self.nbasis, self.nq = m, nq
        qindex = {q: i for i, q in enumerate(qvecs)}
        f64 = dict(dtype=torch.float64, device=device)
        b = torch.tensor(basis, **f64)
        q = torch.tensor(qvecs, **f64)
        self.vq = 4 * math.pi / (kfac ** 2 * (q * q).sum(-1))
        self.qfac = torch.sqrt(self.vq / (4.0 * self.vol))
        qi, ai, bi = [], [], []
        for a, ka in enumerate(basis):
            for c, kc in enumerate(basis):
                iq = qindex.get((ka[0] - kc[0], ka[1] - kc[1], ka[2] - kc[2]))
                if iq is not None:
                    qi.append(iq)
                    ai.append(a)
                    bi.append(c)
        long = dict(dtype=torch.long, device=device)
        self.pq = torch.tensor(qi, **long)
        self.pa = torch.tensor(ai, **long)
        self.pb = torch.tensor(bi, **long)
        self.pfac = self.qfac[self.pq]
        # Pairs grouped by q for the exchange sums.
        order = torch.argsort(self.pq, stable=True)
        counts = torch.bincount(self.pq, minlength=nq).tolist()
        self.groups = list(zip(torch.split(self.pa[order], counts),
                               torch.split(self.pb[order], counts)))
        eps = 0.5 * kfac ** 2 * (b * b).sum(-1)
        d = kfac * (b[:, None, :] - b[None, :, :])
        dsq = (d * d).sum(-1)
        vpair = torch.where(dsq > 1e-12, 4 * math.pi / torch.where(
            dsq > 0, dsq, torch.ones_like(dsq)), torch.zeros_like(dsq))
        h1mod = eps - vpair.sum(1) / (2.0 * self.vol)
        self.eps = eps.to(dtype)
        self.bh1 = torch.exp(-0.5 * self.dt * h1mod).to(dtype)
        eye = torch.eye(m, dtype=dtype, device=device)
        self.psia, self.psib = eye[:, :nup], eye[:, :ndown]
        self.mf_shift = torch.zeros(2 * nq, dtype=dtype, device=device)

    def apply_bh1(self, phia, phib):
        return self.bh1[:, None] * phia, self.bh1[:, None] * phib

    def _g(self, psi, gh):
        return torch.einsum("mi,win->wmn", psi.conj(), gh)

    def _rho(self, g):
        """(<rho_q>, <rho_q^T>) [w, nq] of G [w, M, M]."""
        w = g.shape[0]
        fac = self.pfac.to(g.dtype)
        t1 = torch.zeros(w, self.nq, dtype=g.dtype, device=g.device)
        t2 = torch.zeros_like(t1)
        t1.index_add_(1, self.pq, g[:, self.pa, self.pb] * fac)
        t2.index_add_(1, self.pq, g[:, self.pb, self.pa] * fac)
        return t1, t2

    def force_bias(self, gha, ghb):
        g = self._g(self.psia, gha) + self._g(self.psib, ghb)
        t1, t2 = self._rho(g)
        return -math.sqrt(self.dt) * torch.cat([1j * (t1 + t2), -(t1 - t2)],
                                               dim=-1)

    def vhs(self, xs):
        xs = xs.to(self.dtype)
        xp, xm = xs[:, :self.nq], xs[:, self.nq:]
        c1 = (1j * xp - xm)[:, self.pq] * self.pfac.to(self.dtype)
        c2 = (1j * xp + xm)[:, self.pq] * self.pfac.to(self.dtype)
        w, m = xs.shape[0], self.nbasis
        v = torch.zeros(w, m * m, dtype=self.dtype, device=xs.device)
        v.index_add_(1, self.pa * m + self.pb, c1)
        v.index_add_(1, self.pb * m + self.pa, c2)
        return math.sqrt(self.dt) * v.reshape(w, m, m)

    def _spin_terms(self, g):
        """(Gkpq, Gpmq, Gprod) [w, nq] of one spin's G."""
        w = g.shape[0]
        gkpq = torch.zeros(w, self.nq, dtype=g.dtype, device=g.device)
        gpmq = torch.zeros_like(gkpq)
        gkpq.index_add_(1, self.pq, g[:, self.pb, self.pa])
        gpmq.index_add_(1, self.pq, g[:, self.pa, self.pb])
        gprod = torch.zeros_like(gkpq)
        for iq, (a, b) in enumerate(self.groups):
            # sum over pairs t, u of q: G[a_u, a_t] G[b_t, b_u]
            x = g[:, a[:, None], a[None, :]]
            y = g[:, b[:, None], b[None, :]]
            gprod[:, iq] = torch.einsum("wut,wtu->w", x, y)
        return gkpq, gpmq, gprod

    def local_energy(self, gha, ghb):
        ga, gb = self._g(self.psia, gha), self._g(self.psib, ghb)
        ke = torch.einsum("m,wmm->w", self.eps, ga + gb)
        ka, pa, xa = self._spin_terms(ga)
        kb, pb, xb = self._spin_terms(gb)
        vq = self.vq.to(ga.dtype)
        pe = ((ka + kb) * (pa + pb) - xa - xb) @ vq / (2.0 * self.vol)
        return ke + pe, ke, pe
