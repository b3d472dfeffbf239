"""Extended Koopmans' theorem generalised Fock matrices.

Counterpart of ``pauxy_tpu/estimators/ekt.py``: the 1-particle and 1-hole
generalised Fock matrices from the Cholesky vectors and the spin one-body
RDMs, batched over walkers, so that they accumulate inside the
back-propagation measurement.

Conventions: chol[p, q, x]; RDMs P_s[w, p, q] = <c_p^dag c_q>. The
exchange-like terms are Cholesky sandwiches sum_x C_x A C_x^T (or
C_x^T A C_x) of a walker's [M, M] matrix A, formed in chunks of the
Cholesky axis (and of walkers) so that the [w, x, M, M] intermediate stays
within ``MAX_ELEMS``: JAX's four-operand einsums would hold a
[w, M, M, X] one, 34 GB at the Generic bench shape. A real Cholesky
tensor multiplies the real and imaginary parts as one real batch.

Every two-body term is a sum over X: on a [walker, chol] mesh each rank
forms its X slice's part and the chol group sums them; the one-body term
gamma h1 is added once (:func:`weighted_focks` sums both Focks' two-body
parts in one all_reduce).
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops.contract import cr_einsum, rc_einsum
from pauxy_tpu_torch.parallel import mesh as pmesh

# Elements of one chunk of a sandwich's [w, x, M, M] intermediate (2^26:
# 512 MB in complex64).
MAX_ELEMS = 2 ** 26


def _xchol(chol, p_a, p_b):
    """X_s[w, q, p] = sum_x (sum_pq L[p, q, x] P_s[w, p, q]) L[p, q, x]^T."""
    xa = cr_einsum("pqx,wpq->wx", chol, p_a)
    xb = cr_einsum("pqx,wpq->wx", chol, p_b)
    return (rc_einsum("wx,pqx->wqp", xa, chol),
            rc_einsum("wx,pqx->wqp", xb, chol))


def sandwich(chol, a, transpose: bool = False):
    """S[w] = sum_x C_x A[w] C_x^T, or with ``transpose`` sum_x C_x^T A[w]
    C_x, C_x = chol[:, :, x] and A [w, M, M]: for each chunk of x one
    batched product C_x A[w] and one [w M, x M] x [x M, M] product."""
    split = a.is_complex() and not chol.is_complex()
    if split:
        w0 = a.shape[0]
        a = torch.cat([a.real, a.imag])
    c = chol.to(a.dtype).permute(2, 0, 1)                  # c[x] = C_x
    if transpose:
        c = c.transpose(-1, -2)
    nw, m, nx = a.shape[0], a.shape[-1], c.shape[0]
    wc = max(1, min(nw, MAX_ELEMS // (m * m)))
    xc = max(1, min(nx, MAX_ELEMS // (wc * m * m)))
    parts = []
    for i in range(0, nw, wc):
        aw = a[i:i + wc]
        acc = torch.zeros_like(aw)
        for j in range(0, nx, xc):
            cc = c[j:j + xc]                                # [x, M, M]
            t = torch.matmul(cc[None], aw[:, None])          # [w, x, p, b]
            t = t.transpose(1, 2).reshape(aw.shape[0], m, -1)
            acc = acc + torch.matmul(t, cc.transpose(1, 2).reshape(-1, m))
        parts.append(acc)
    out = torch.cat(parts)
    if split:
        return torch.complex(out[:w0], out[w0:])
    return out


def ekt_1p_one_body(h1, p_a, p_b):
    """The 1-particle Fock's one-body term gamma h1, gamma = 2 - Pa^T -
    Pb^T, [w, M, M]."""
    h1 = h1.to(p_a.dtype)
    m = h1.shape[-1]
    eye = torch.eye(m, dtype=p_a.dtype, device=p_a.device)
    gamma = 2 * eye - p_a.transpose(-1, -2) - p_b.transpose(-1, -2)
    return torch.matmul(gamma, h1)


def ekt_1p_two_body(chol, p_a, p_b):
    """The 1-particle Fock's J and K terms, sums over the X of ``chol``,
    [w, M, M]: K = -S(Pa^T) - S(Pb^T) + Pa^T S(Pa^T) + Pb^T S(Pb^T) with
    S the sandwich sum_x C_x A C_x^T."""
    pat = p_a.transpose(-1, -2)
    pbt = p_b.transpose(-1, -2)
    xachol, xbchol = _xchol(chol, p_a, p_b)
    j = (2.0 * (xachol + xbchol)
         - 2.0 * torch.matmul(pat, xbchol)
         - torch.matmul(pat, xachol)
         - torch.matmul(pbt, xbchol))
    sa = sandwich(chol, pat)
    sb = sandwich(chol, pbt)
    k = torch.matmul(pat, sa) + torch.matmul(pbt, sb) - sa - sb
    return j + k


def ekt_1h_one_body(h1, p_a, p_b):
    """The 1-hole Fock's one-body term -(Pa + Pb) h1^T, [w, M, M]."""
    h1 = h1.to(p_a.dtype)
    return -torch.matmul(p_a + p_b, h1.transpose(-1, -2))


def ekt_1h_two_body(chol, p_a, p_b):
    """The 1-hole Fock's J and K terms, sums over the X of ``chol``,
    [w, M, M]: K = Pa S'(Pa + Pb) with S' the sandwich sum_x C_x^T A C_x."""
    xachol, xbchol = _xchol(chol, p_a, p_b)
    j = (-2.0 * torch.matmul(p_a, xbchol.transpose(-1, -2))
         - torch.matmul(p_a, xachol.transpose(-1, -2))
         - torch.matmul(p_b, xbchol.transpose(-1, -2)))
    k = torch.matmul(p_a, sandwich(chol, p_a + p_b, transpose=True))
    return j + k


def ekt_1p_fock(h1, chol, p_a, p_b):
    """1-particle (electron attachment) generalised Fock, [w, M, M]."""
    return ekt_1p_one_body(h1, p_a, p_b) + pmesh.chol_sum(
        ekt_1p_two_body(chol, p_a, p_b))


def ekt_1h_fock(h1, chol, p_a, p_b):
    """1-hole (ionisation) generalised Fock, [w, M, M]."""
    return ekt_1h_one_body(h1, p_a, p_b) + pmesh.chol_sum(
        ekt_1h_two_body(chol, p_a, p_b))


def weighted_focks(h1, chol, p_a, p_b, w):
    """(sum_w w F1p[w], sum_w w F1h[w]), [M, M] each; on a [walker, chol]
    mesh the two weighted two-body parts are summed over the chol group
    together."""
    def wsum(f):
        return torch.einsum("w,wmn->mn", w, f)

    two = pmesh.chol_sum(torch.stack([
        wsum(ekt_1p_two_body(chol, p_a, p_b)),
        wsum(ekt_1h_two_body(chol, p_a, p_b))]))
    return (wsum(ekt_1p_one_body(h1, p_a, p_b)) + two[0],
            wsum(ekt_1h_one_body(h1, p_a, p_b)) + two[1])
