"""FFT-cube helpers and the FFT two-body propagator of the plane-wave UEG.

Counterpart of ``pauxy_tpu/propagation/pw_fft.py``. Cubes are flat
[..., Ng] tensors in FFT frequency order (index = n mod N per axis), so
circular convolution indices line up with momentum sums; ``fft3`` and
``ifft3`` transform the last axis as the (N, N, N) cube with
``torch.fft``. The JAX package's matmul DFT for odd cubes worked around
the TPU's FFT and is not ported: on the CPU in float64 the two agree to
~1e-12.

``PWFFTInner`` applies the HS two-body propagator of the PW_FFT system as
one batched pseudo-spectral update: writing X+-(Q) for the scaled shifted
fields,

    A(Q) = i [X+(Q) + X+(-Q)] - [X-(Q) - X-(-Q)],
    (VHS phi)(G) = sum_Q A(Q) phi(G - Q),

evaluated as IFFT(FFT(A) * FFT(phi)) on the cube (FFT(rev X) is
Ng IFFT(X)), each Taylor order truncated back to the basis sphere.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config


def to_cube(arr: torch.Tensor, idx: torch.Tensor, ngrid: int
            ) -> torch.Tensor:
    """Scatter [..., M] k-components into a flat [..., ngrid] cube."""
    cube = arr.new_zeros(arr.shape[:-1] + (ngrid,))
    cube[..., idx] = arr
    return cube


@functools.lru_cache(maxsize=None)
def neg_perm(qmesh: tuple, device=torch.device("cpu")) -> torch.Tensor:
    """Flat cube index of -G for every G, a long tensor on ``device``, made
    once per cube and device (no host copy on every call). Correlation
    cubes obey C2(Q) = C1(-Q) (rho_q^T = rho_{-q}), so the second FFT
    chain of a Coulomb or exchange pair is a gather of the first through
    this permutation."""
    d0, d1, d2 = qmesh
    a, b, c = np.meshgrid(np.arange(d0), np.arange(d1), np.arange(d2),
                          indexing="ij")
    perm = (((-a) % d0) * d1 + ((-b) % d1)) * d2 + ((-c) % d2)
    return torch.from_numpy(perm.reshape(-1).astype(np.int64)).to(device)


def fft3(cube_flat: torch.Tensor, qmesh) -> torch.Tensor:
    x = cube_flat.reshape(cube_flat.shape[:-1] + tuple(qmesh))
    return torch.fft.fftn(x, dim=(-3, -2, -1)).reshape(cube_flat.shape)


def ifft3(cube_flat: torch.Tensor, qmesh) -> torch.Tensor:
    x = cube_flat.reshape(cube_flat.shape[:-1] + tuple(qmesh))
    return torch.fft.ifftn(x, dim=(-3, -2, -1)).reshape(cube_flat.shape)


class PWFFTInner(nn.Module):
    """Inner propagator of ``Continuous`` for the PW_FFT system (diagonal
    BH1 and the FFT VHS). Buffers: ``BH1`` [2, M] (the diagonal of
    exp(-dt/2 h1e_mod)), ``mf_shift`` [2 nq] zeros, ``vqfac`` [nq]
    sqrt(v_q / (4 V)), ``vq_sqrtdt`` [nq] sqrt(dt) vqfac, ``gmap`` [M],
    ``qmap`` [nq], and the FFT and inverse FFT of the conjugate trial
    orbitals' cubes ``ct_f_a``/``ct_if_a`` [na, Ng], ``ct_f_b``/``ct_if_b``
    [nb, Ng]."""

    uses_full_g = False

    def __init__(self, BH1, mf_shift, vqfac, vq_sqrtdt, gmap, qmap, ct_f_a,
                 ct_if_a, ct_f_b, ct_if_b, *, qmesh: tuple, sqrt_dt: float,
                 exp_order: int = 6):
        super().__init__()
        for name, buf in (("BH1", BH1), ("mf_shift", mf_shift),
                          ("vqfac", vqfac), ("vq_sqrtdt", vq_sqrtdt),
                          ("gmap", gmap), ("qmap", qmap), ("ct_f_a", ct_f_a),
                          ("ct_if_a", ct_if_a), ("ct_f_b", ct_f_b),
                          ("ct_if_b", ct_if_b)):
            self.register_buffer(name, buf)
        self.qmesh = tuple(qmesh)
        self.sqrt_dt = float(sqrt_dt)
        self.exp_order = int(exp_order)

    @property
    def nq(self) -> int:
        return self.qmap.shape[0]

    @property
    def ngrid(self) -> int:
        return int(np.prod(self.qmesh))

    def _gkpq_gpmq(self, ghalf, ct_f, ct_if):
        """Gkpq(Q) = sum_iG CT_i(G+Q) theta_i(G) and
        Gpmq(Q) = sum_iG CT_i(G-Q) theta_i(G) by FFT correlations, each
        [w, nq]."""
        ng = self.ngrid
        th = to_cube(ghalf, self.gmap, ng)                 # [w, n, Ng]
        th_f = fft3(th, self.qmesh)
        th_if = ifft3(th, self.qmesh)
        # conv(a, rev b) = IFFT(FFT(a) * Ng * IFFT(b)).
        gkpq = ifft3(torch.einsum("ig,wig->wg", ct_f, th_if) * ng,
                     self.qmesh)
        gpmq = ifft3(torch.einsum("wig,ig->wg", th_f, ct_if) * ng,
                     self.qmesh)
        return gkpq[..., self.qmap], gpmq[..., self.qmap]

    def force_bias(self, trial, ga, gb) -> torch.Tensor:
        """xbar = -sqrt(dt) vbias: vplus = i (Gkpq + Gpmq), vminus =
        -(Gkpq - Gpmq), scaled by sqrt(v_q / (4 V))."""
        ka, pa = self._gkpq_gpmq(ga.Ghalf, self.ct_f_a, self.ct_if_a)
        kb, pb = self._gkpq_gpmq(gb.Ghalf, self.ct_f_b, self.ct_if_b)
        gk, gp = ka + kb, pa + pb
        vplus = 1j * (gk + gp) * self.vqfac[None]
        vminus = -(gk - gp) * self.vqfac[None]
        return -self.sqrt_dt * torch.cat([vplus, vminus], dim=-1)

    def apply_vhs(self, phia: torch.Tensor, phib: torch.Tensor,
                  xshifted: torch.Tensor):
        """exp(VHS) phi by its Taylor series, one FFT convolution an
        order."""
        nq, ng = self.nq, self.ngrid
        cdtype = phia.dtype
        xp = (xshifted[:, :nq] * self.vq_sqrtdt[None]).to(cdtype)
        xm = (xshifted[:, nq:] * self.vq_sqrtdt[None]).to(cdtype)
        xp_c = to_cube(xp, self.qmap, ng)                  # [w, Ng]
        xm_c = to_cube(xm, self.qmap, ng)
        a_hat = (1j * (fft3(xp_c, self.qmesh) + ng * ifft3(xp_c, self.qmesh))
                 - (fft3(xm_c, self.qmesh) - ng * ifft3(xm_c, self.qmesh)))
        mask = torch.zeros(ng, dtype=cdtype, device=phia.device)
        mask[self.gmap] = 1.0

        def expv(phi):
            u = to_cube(phi.transpose(-1, -2), self.gmap, ng)  # [w, n, Ng]
            out = u
            for n in range(1, self.exp_order + 1):
                u = ifft3(a_hat[:, None, :] * fft3(u, self.qmesh),
                          self.qmesh) / n
                u = u * mask[None, None, :]
                out = out + u
            return out[..., self.gmap].transpose(-1, -2)

        return expv(phia), expv(phib)


def make_pw_fft_inner(ham, trial, dt: float, exp_order: int = 6, *,
                      device=None, dtype=None) -> PWFFTInner:
    """Host-side set-up, as JAX builds it: BH1 = exp(-dt/2 h1e_mod)
    (diagonal), the trial's conjugate orbital cubes transformed with
    numpy's FFT in complex128, then cast to the precision."""
    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    bh1 = np.exp(-0.5 * dt * ham.h1e_mod.cpu().numpy().astype(np.float64))
    vqfac = np.sqrt(ham.vqvec.cpu().numpy().astype(np.float64)
                    / (4.0 * ham.vol))
    mesh = tuple(ham.qmesh)
    ng = int(np.prod(mesh))
    gmap = ham.gmap.cpu().numpy()

    def ct_cubes(psi):
        cube = np.zeros((psi.shape[1], ng), dtype=complex)
        cube[:, gmap] = psi.conj().T
        return cube

    def f3(a):
        return np.fft.fftn(a.reshape(a.shape[:-1] + mesh),
                           axes=(-3, -2, -1)).reshape(a.shape)

    def if3(a):
        return np.fft.ifftn(a.reshape(a.shape[:-1] + mesh),
                            axes=(-3, -2, -1)).reshape(a.shape)

    cta = ct_cubes(trial.psia.cpu().numpy())
    ctb = ct_cubes(trial.psib.cpu().numpy())

    def tens(x, dt_):
        return torch.from_numpy(np.ascontiguousarray(x.astype(dt_))).to(
            device)

    return PWFFTInner(
        tens(np.stack([bh1, bh1]), prec.np_cplx),
        torch.zeros(2 * ham.nq, dtype=prec.cplx, device=device),
        tens(vqfac, prec.np_real), tens(dt ** 0.5 * vqfac, prec.np_real),
        ham.gmap.to(device), ham.qmap.to(device),
        tens(f3(cta), prec.np_cplx), tens(if3(cta), prec.np_cplx),
        tens(f3(ctb), prec.np_cplx), tens(if3(ctb), prec.np_cplx),
        qmesh=mesh, sqrt_dt=float(dt) ** 0.5, exp_order=exp_order)
