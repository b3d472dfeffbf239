"""Sparse plane-wave density operators for the UEG.

Counterpart of ``pauxy_tpu/ops/ueg_sparse.py``. Each rho_q has one nonzero
per column, rho_q[idx(k+q), k] = sqrt(pi / (vol q^2)), and for any matrix
position (a, b) at most one q has k_a - k_b = q, so the operator family
inverts into one [M, M] map Q[a, b] = index(k_a - k_b) and

  sum_q c1_q rho_q + c2_q rho_q^T = c1[Q] * F + (c2[Q] * F)^T,

F[a, b] = sqrt(pi / (vol q^2)) where k_a - k_b is on the grid, else 0. The
expectations <rho_q> and <rho_q^T> are masked gathers over the [nq, M]
``kpq`` map, and the VHS is one gather of the per-q coefficients through
Q; nothing is truncated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SparseRho:
    """Gather metadata for {rho_q}, built host-side."""

    qmap: torch.Tensor      # [M, M] long: index of q = k_a - k_b (0 off-grid)
    fac: torch.Tensor       # [M, M] real: sqrt(pi/(vol q^2)), 0 off-grid
    kpq_idx: torch.Tensor   # [nq, M] long: idx(k_i + q) (0 where invalid)
    kpq_fac: torch.Tensor   # [nq, M] real: factor * mask
    qfac: torch.Tensor      # [nq] real: sqrt(pi/(vol q^2))
    nbasis: int
    nq: int

    def to(self, device) -> "SparseRho":
        """The same metadata on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_sparse_rho(ham, real_dtype: torch.dtype) -> SparseRho:
    """The gather metadata from a UEG's ``basis`` [M, 3], ``qvecs``
    [nq, 3], ``kpq_idx/kpq_mask`` [nq, M], ``vqvec`` [nq] (= 4 pi / q^2)
    and ``vol``; factor = sqrt(vqvec / (4 vol)). On the UEG's device."""
    basis = np.asarray(ham.basis)
    qvecs = np.asarray(ham.qvecs)
    kpq_idx = ham.kpq_idx.cpu().numpy()
    kpq_mask = ham.kpq_mask.cpu().numpy()
    nq, m = kpq_idx.shape
    factor = np.sqrt(ham.vqvec.cpu().numpy() / (4.0 * ham.vol))

    # Invert the operator family: Q[a, b] = q-index of k_a - k_b.
    qlut = {tuple(v): i for i, v in enumerate(qvecs)}
    qmap = np.zeros((m, m), dtype=np.int64)
    fac = np.zeros((m, m))
    diff = basis[:, None, :] - basis[None, :, :]
    for a in range(m):
        for b in range(m):
            iq = qlut.get(tuple(diff[a, b]))
            if iq is not None:
                qmap[a, b] = iq
                fac[a, b] = factor[iq]
    # Consistency: (a, b) = (kpq_idx[q, b], b) must round-trip to q.
    qi, ii = np.nonzero(kpq_mask)
    assert (qmap[kpq_idx[qi, ii], ii] == qi).all()

    dev = ham.kpq_idx.device

    def real(x):
        return torch.from_numpy(np.asarray(x)).to(dev, real_dtype)

    return SparseRho(
        qmap=torch.from_numpy(qmap).to(dev),
        fac=real(fac),
        kpq_idx=torch.from_numpy(kpq_idx.astype(np.int64)).to(dev),
        kpq_fac=real(factor[:, None] * kpq_mask),
        qfac=real(factor),
        nbasis=int(m),
        nq=int(nq),
    )


def rho_expectations(sp: SparseRho, g: torch.Tensor):
    """(<rho_q>, <rho_q^T>) of g [w, M, M] as masked gathers, each [w, nq]:
    t1[w, q] = sum_m g[w, idx(k_m + q), m] fac,
    t2[w, q] = sum_p g[w, p, idx(k_p + q)] fac."""
    cols = torch.arange(sp.nbasis, device=g.device)[None, :]
    fac = sp.kpq_fac.to(g.dtype)[None]
    t1 = torch.sum(g[:, sp.kpq_idx, cols] * fac, dim=-1)
    t2 = torch.sum(g[:, cols, sp.kpq_idx] * fac, dim=-1)
    return t1, t2


def assemble_vhs(sp: SparseRho, c1: torch.Tensor,
                 c2: torch.Tensor) -> torch.Tensor:
    """sum_q (c1[w, q] rho_q + c2[w, q] rho_q^T) as a dense [w, M, M]
    tensor: one gather of the per-q coefficients through the q-map per
    term."""
    fac = sp.fac.to(c1.dtype)[None]
    t1 = c1[:, sp.qmap] * fac
    t2 = c2[:, sp.qmap] * fac
    return t1 + t2.transpose(-1, -2)
