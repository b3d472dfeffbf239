"""Extended Koopmans' theorem generalised Fock matrices.

Counterpart of ``pauxy_tpu/estimators/ekt.py``: the 1-particle and 1-hole
generalised Fock matrices from the Cholesky vectors and the spin one-body
RDMs, batched over walkers, so that they accumulate inside the
back-propagation measurement.

Conventions: chol[p, q, x]; RDMs P_s[w, p, q] = <c_p^dag c_q>. The
Cholesky tensor is promoted to the RDMs' complex type (torch.einsum does
not mix real and complex operands).
"""

from __future__ import annotations

import torch


def _xchol(chol, p_a, p_b):
    """X_s[w, q, p] = sum_x (sum_pq L[p, q, x] P_s[w, p, q]) L[p, q, x]^T."""
    xa = torch.einsum("pqx,wpq->wx", chol, p_a)
    xb = torch.einsum("pqx,wpq->wx", chol, p_b)
    return (torch.einsum("wx,pqx->wqp", xa, chol),
            torch.einsum("wx,pqx->wqp", xb, chol))


def ekt_1p_fock(h1, chol, p_a, p_b):
    """1-particle (electron attachment) generalised Fock, [w, M, M]."""
    chol = chol.to(p_a.dtype)
    h1 = h1.to(p_a.dtype)
    m = h1.shape[-1]
    eye = torch.eye(m, dtype=p_a.dtype, device=p_a.device)
    pat = p_a.transpose(-1, -2)
    pbt = p_b.transpose(-1, -2)
    gamma = 2 * eye - pat - pbt
    rdm1 = p_a + p_b
    xachol, xbchol = _xchol(chol, p_a, p_b)
    j = (2.0 * (xachol + xbchol)
         - 2.0 * torch.matmul(pat, xbchol)
         - torch.matmul(pat, xachol)
         - torch.matmul(pbt, xbchol))
    k = -torch.einsum("pax,wab,qbx->wpq", chol, rdm1.transpose(-1, -2), chol)
    k = k + torch.einsum("wpa,abx,wbc,qcx->wpq", pat, chol, pat, chol)
    k = k + torch.einsum("wpa,abx,wbc,qcx->wpq", pbt, chol, pbt, chol)
    return torch.matmul(gamma, h1) + j + k


def ekt_1h_fock(h1, chol, p_a, p_b):
    """1-hole (ionisation) generalised Fock, [w, M, M]."""
    chol = chol.to(p_a.dtype)
    h1 = h1.to(p_a.dtype)
    xachol, xbchol = _xchol(chol, p_a, p_b)
    j = (-2.0 * torch.einsum("wpa,wqa->wpq", p_a, xbchol)
         - torch.einsum("wpa,wqa->wpq", p_a, xachol)
         - torch.einsum("wpa,wqa->wpq", p_b, xbchol))
    k = torch.einsum("wpa,bax,wbc,cqx->wpq", p_a, chol, p_a, chol)
    k = k + torch.einsum("wpa,bax,wbc,cqx->wpq", p_a, chol, p_b, chol)
    gamma = p_a + p_b
    return -torch.einsum("wpa,qa->wpq", gamma, h1) + j + k
