"""Imaginary-time correlation functions (single-particle Green's function).

Counterpart of ``pauxy_tpu/estimators/itcf.py``: G>(tau) = <c(tau) c^dag>
and G<(tau) = <c^dag c(tau)> of both spins over the stored
auxiliary-field path, batched over walkers:

1. phi_left = psi_T back-propagated through the stored fields, keeping
   the left wavefunction after every slice;
2. the equal-time G at the path's start from (phi_left, phi_right);
3. a forward loop over the slices with the dense propagators B(x):
   unstable, G> <- B G>, G< <- G< B^-1; stable, products of single-slice
   terms G> <- (B Gnn>) G>, G< <- G< (Gnn< B^-1) with the equal-time Gnn
   re-derived every slice from the stored left wavefunctions and the
   advanced right wavefunction.

The solves are kernel B's inverses and the re-orthogonalisations the
Cholesky-inverse kernel's, on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pauxy_tpu_torch.estimators.back_prop import (ortho_every,
                                                  restored_weights,
                                                  trial_batch)
from pauxy_tpu_torch.ops import clinalg, greens


def dense_propagators(prop, configs_t, discrete: bool):
    """Dense B = (Ba, Bb), [w, M, M] each, for one stored field row:
    BT2 diag(auxf[x, s]) BT2 (discrete) or BH1 e^{VHS(x)} BH1
    (continuous; e^{VHS} applied to the identity)."""
    nw = configs_t.shape[0]
    if discrete:
        bt2 = prop.BT2
        xi = configs_t.real.long()
        left_a = bt2[0][None] * prop.auxf[xi, 0][:, None, :]
        left_b = bt2[1][None] * prop.auxf[xi, 1][:, None, :]
        return torch.matmul(left_a, bt2[0]), torch.matmul(left_b, bt2[1])
    inner = prop.inner
    bh1 = inner.BH1
    m = bh1.shape[-1]
    eye = torch.eye(m, dtype=bh1.dtype, device=bh1.device).expand(nw, m, m)
    ev_a, ev_b = inner.apply_vhs(eye, eye, configs_t)
    if bh1.dim() == 2:
        return (bh1[0][None, :, None] * ev_a * bh1[0][None, None, :],
                bh1[1][None, :, None] * ev_b * bh1[1][None, None, :])
    return (torch.matmul(torch.matmul(bh1[0], ev_a), bh1[0]),
            torch.matmul(torch.matmul(bh1[1], ev_b), bh1[1]))


def equal_time_greens(phia_l, phib_l, phia_r, phib_r):
    """((G>a, G>b), (G<a, G<b)) with G< = gab(L, R) and G> = I - G<."""
    m = phia_l.shape[1]
    eye = torch.eye(m, dtype=phia_l.dtype, device=phia_l.device)
    gls_a = greens.gab(phia_l, phia_r)
    gls_b = greens.gab(phib_l, phib_r)
    return (eye - gls_a, eye - gls_b), (gls_a, gls_b)


def back_propagate_left(prop, trial, configs, nstblz: int, discrete: bool):
    """psi_T back-propagated through all stored fields (most recent first),
    keeping the left wavefunction after every slice. Returns (phia, phib,
    la, lb) with la[j] the bra after the last j + 1 fields."""
    nw, nprop, _ = configs.shape
    phia, phib = trial_batch(
        trial, nw, prop.BT2.dtype if discrete else prop.inner.BH1.dtype)
    la, lb = [], []
    for j in range(nprop):
        ba, bb = dense_propagators(prop, configs[:, nprop - 1 - j], discrete)
        phia = torch.matmul(ba.conj().transpose(-1, -2), phia)
        phib = torch.matmul(bb.conj().transpose(-1, -2), phib)
        phia, phib = ortho_every(j, nstblz, phia, phib)
        la.append(phia)
        lb.append(phib)
    return phia, phib, la, lb


def measure(prop, trial, state, *, nmax: int, nstblz: int, stable: bool,
            restore_weights: bool, discrete: bool, stack_size: int = 1
            ) -> torch.Tensor:
    """One ITCF measurement: the flat accumulator
    [denominator, G(tau) [nmax // stack_size + 1, 2 spin, 2 (>, <), M, M]]
    summed over walkers; G(tau) kept every ``stack_size`` slices."""
    configs = state.configs
    nprop = configs.shape[1]
    phia_l, phib_l, la, lb = back_propagate_left(prop, trial, configs,
                                                 nstblz, discrete)
    (ggr_a, ggr_b), (gls_a, gls_b) = equal_time_greens(
        phia_l, phib_l, state.phia_right, state.phib_right)
    wfac = restored_weights(state, "full" if restore_weights else None,
                            state.log_ovlp.dtype)

    def acc_slice(gra, grb, lsa, lsb):
        g = torch.stack([torch.stack([gra, lsa]), torch.stack([grb, lsb])])
        return torch.einsum("w,sewmn->semn", wfac, g)

    spgf = [acc_slice(ggr_a, ggr_b, gls_a, gls_b)]
    cum_gr_a, cum_gr_b, cum_ls_a, cum_ls_b = ggr_a, ggr_b, gls_a, gls_b
    pra = state.phia_right.to(spgf[0].dtype)
    prb = state.phib_right.to(spgf[0].dtype)
    for ic in range(nmax):
        ba, bb = dense_propagators(prop, configs[:, ic], discrete)
        if stable:
            (nn_gr_a, nn_gr_b), (nn_ls_a, nn_ls_b) = equal_time_greens(
                la[nprop - 1 - ic], lb[nprop - 1 - ic], pra, prb)
            cum_gr_a = torch.matmul(torch.matmul(ba, nn_gr_a), cum_gr_a)
            cum_gr_b = torch.matmul(torch.matmul(bb, nn_gr_b), cum_gr_b)
            # G< <- G< (Gnn< B^-1): solve on the right via transposes.
            t_a = clinalg.solve(ba.transpose(-1, -2),
                                nn_ls_a.transpose(-1, -2))
            t_b = clinalg.solve(bb.transpose(-1, -2),
                                nn_ls_b.transpose(-1, -2))
            cum_ls_a = torch.matmul(cum_ls_a, t_a.transpose(-1, -2))
            cum_ls_b = torch.matmul(cum_ls_b, t_b.transpose(-1, -2))
            pra = torch.matmul(ba, pra)
            prb = torch.matmul(bb, prb)
            pra, prb = ortho_every(ic, nstblz, pra, prb)
        else:
            cum_gr_a = torch.matmul(ba, cum_gr_a)
            cum_gr_b = torch.matmul(bb, cum_gr_b)
            cum_ls_a = clinalg.solve(ba.transpose(-1, -2),
                                     cum_ls_a.transpose(-1, -2)
                                     ).transpose(-1, -2)
            cum_ls_b = clinalg.solve(bb.transpose(-1, -2),
                                     cum_ls_b.transpose(-1, -2)
                                     ).transpose(-1, -2)
        spgf.append(acc_slice(cum_gr_a, cum_gr_b, cum_ls_a, cum_ls_b))
    spgf = torch.stack(spgf)                              # [nmax+1,2,2,M,M]
    if stack_size > 1:
        spgf = spgf[::stack_size]
    return torch.cat([torch.sum(wfac)[None], spgf.reshape(-1)])


def itcf_acc_size(nbasis: int, nmax: int, stack_size: int) -> int:
    return 1 + (nmax // stack_size + 1) * 4 * nbasis * nbasis


def itcf_to_kspace(spgf: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """G_k(tau) = (1/M) sum_ij e^{-ik(r_i - r_j)} G_ij(tau) on the lattice's
    momentum grid, a 2-D FFT over both site indices; [..., M] diagonal
    momentum occupations."""
    m = nx * ny
    shape = spgf.shape[:-2]
    g = spgf.reshape(*shape, ny, nx, ny, nx)
    gk = np.fft.fft2(g, axes=(-4, -3))
    gk = np.fft.ifft2(gk, axes=(-2, -1)) * m
    gk = gk.reshape(*shape, m, m) / m
    return np.einsum("...kk->...k", gk)


class ITCFReporter:
    """Host-side normalisation of a block's ITCF accumulator. With an
    ``output`` (an ``H5EstimatorHelper`` on the group ``itcf``) it pushes
    ``real_space_greens_function`` (``mode`` 'full', 'diagonal' or a list
    of (i, j) pairs), ``k_space_greens_function`` with ``kspace_dims`` and
    ``denominator``; every block's values are also kept in ``rows``."""

    def __init__(self, output, kspace_dims=None, mode="full"):
        self.output = output
        self.kspace_dims = kspace_dims
        self.mode = mode
        self.rows: list[dict] = []

    def _select(self, spgf):
        if self.mode == "full":
            return spgf
        if self.mode == "diagonal":
            return np.einsum("...ii->...i", spgf)
        pairs = np.asarray(self.mode, dtype=int).reshape(-1, 2)
        return spgf[..., pairs[:, 0], pairs[:, 1]]

    def block_row(self, acc, nbasis: int, nmax: int):
        acc = np.asarray(acc)
        denom = acc[0]
        spgf = acc[1:].reshape(nmax + 1, 2, 2, nbasis, nbasis)
        if abs(denom) > 0:
            spgf = spgf / denom
        row = {"real_space_greens_function": self._select(spgf).real,
               "denominator": np.array([denom])}
        if self.kspace_dims is not None:
            row["k_space_greens_function"] = itcf_to_kspace(
                spgf, *self.kspace_dims).real
        if self.output is not None:
            for name in ("real_space_greens_function",
                         "k_space_greens_function", "denominator"):
                if name in row:
                    self.output.push(row[name], name)
            self.output.increment()
        self.rows.append(row)
        return spgf
