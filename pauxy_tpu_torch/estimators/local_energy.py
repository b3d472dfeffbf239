"""Hubbard, Generic and UEG local energies: walker-batched and host-side.

Counterpart of ``local_energy_hubbard``, ``local_energy_generic_opt``,
``_exx``, ``local_energy_generic_cholesky_G``, the UEG gather kernels
(``coulomb_greens_function_ueg``, ``exchange_greens_function_ueg``,
``local_energy_ueg``) and ``local_energy_G_host`` in
``pauxy_tpu/estimators/local_energy.py``. The lanes block of
``qmc/hubbard_fast.py`` keeps its own fused energy.
"""

from __future__ import annotations

import numpy as np
import torch

from pauxy_tpu_torch.ops import exx_cuda
from pauxy_tpu_torch.ops.contract import cr_einsum, rc_einsum

# Elements of one chunk of the dense-G exchange intermediate
# t[w, l, k, x] = sum_i G[w, i, l] L[i, k, x] (2^26: 512 MB in complex64).
CHOLESKY_G_MAX_ELEMS = 2 ** 26


def local_energy_hubbard(ham, Ga: torch.Tensor, Gb: torch.Tensor):
    """(etot, e1b, e2b), each [w], from G [w, M, M] of both spins:
    ke = sum T_s * G_s; pe = U sum_i G_up[ii] G_dn[ii], or
    -U/2 (tr G_up + tr G_dn) in the symmetric form."""
    t = ham.T.to(Ga.dtype)
    ke = (torch.einsum("mn,wmn->w", t[0], Ga)
          + torch.einsum("mn,wmn->w", t[1], Gb))
    da = torch.diagonal(Ga, dim1=-2, dim2=-1)
    db = torch.diagonal(Gb, dim1=-2, dim2=-1)
    if ham.symmetric:
        pe = -0.5 * ham.U * (da.sum(-1) + db.sum(-1))
    else:
        pe = ham.U * torch.sum(da * db, dim=-1)
    return ke + pe, ke, pe


def local_energy_generic_opt(trial, Ghalfa: torch.Tensor,
                             Ghalfb: torch.Tensor, ecore: float):
    """(etot, e1b, e2b), each [w], from the half-rotated Green's functions
    Ghalf_s [w, n_s, M] and the trial's half-rotated tensors:
      e1b = sum_{i m} rh1_s[i, m] Ghalf_s[w, i, m] + ecore,
      X_s[w, x] = sum_{i m} rchol_s[x, i, m] Ghalf_s[w, i, m],
      e2b = 0.5 ((Xa + Xb).(Xa + Xb) - exx_a - exx_b)."""
    e1b = (cr_einsum("im,wim->w", trial.rh1a, Ghalfa)
           + cr_einsum("im,wim->w", trial.rh1b, Ghalfb))
    x = (cr_einsum("xim,wim->wx", trial.rchola, Ghalfa)
         + cr_einsum("xim,wim->wx", trial.rcholb, Ghalfb))
    ecoul = torch.sum(x * x, dim=-1)
    exx = (_exx(trial.rchola, Ghalfa, trial.exx_supera)
           + _exx(trial.rcholb, Ghalfb, trial.exx_superb))
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ecore, e1b + ecore, e2b


def _exx(rchol: torch.Tensor, ghalf: torch.Tensor,
         exx_super: torch.Tensor | None = None) -> torch.Tensor:
    """exx[w] = sum_x tr(T_x(w) T_x(w)), T_x(w) = rchol_x Ghalf_w^T, by
    JAX's three routes in JAX's order: the exchange supermatrix (one GEMM,
    exx_w = vec(Ghalf_w)^T C vec(Ghalf_w)); the exchange kernel for a real
    rchol and complex ghalf (``ops/exx_cuda``; its plain version on a CPU
    tensor); else the einsum route, chunked over the Cholesky axis
    (``exx_cuda.exx_plain``)."""
    w = ghalf.shape[0]
    if exx_super is not None:
        gv = ghalf.reshape(w, -1)
        return torch.sum(gv * cr_einsum("pq,wq->wp", exx_super, gv), dim=-1)
    if not rchol.is_complex() and ghalf.is_complex():
        return exx_cuda.exx(rchol, ghalf.contiguous())
    return exx_cuda.exx_plain(rchol, ghalf)


def local_energy_generic_cholesky_G(ham, Ga: torch.Tensor, Gb: torch.Tensor,
                                    max_elems: int | None = None):
    """(etot, e1b, e2b), each [w], of the Generic Hamiltonian from full
    Green's functions G_s [w, M, M] (no trial half-rotation: the
    back-propagated bra is not the trial):
      e1b = sum H1_s * G_s + ecore,
      X[w, x] = sum_ik L[i, k, x] (Ga + Gb)[w, i, k],
      exx = sum_s sum_x tr((G_s^T L_x)^2),
      e2b = 0.5 (X.X - exx).
    The exchange's [w, M, M, X] intermediate is formed in chunks of the
    Cholesky axis (and of walkers when one vector is already too large)
    of at most ``max_elems`` elements, so it fits the card at the bench
    shape."""
    if max_elems is None:
        max_elems = CHOLESKY_G_MAX_ELEMS
    h1 = ham.H1
    chol = ham.chol                                       # [M, M, X]
    e1b = (cr_einsum("mn,wmn->w", h1[0], Ga)
           + cr_einsum("mn,wmn->w", h1[1], Gb))
    x = cr_einsum("ikx,wik->wx", chol, Ga + Gb)
    ecoul = torch.einsum("wx,wx->w", x, x)
    w, m = Ga.shape[0], Ga.shape[-1]
    nx = chol.shape[-1]
    wc = max(1, min(w, max_elems // (m * m)))
    xc = max(1, min(nx, max_elems // (wc * m * m)))
    exx = torch.zeros_like(ecoul)
    for g in (Ga, Gb):
        parts = []
        for w0 in range(0, w, wc):
            gw = g[w0:w0 + wc]
            acc = torch.zeros(gw.shape[0], dtype=ecoul.dtype,
                              device=ecoul.device)
            for x0 in range(0, nx, xc):
                t = rc_einsum("wil,ikx->wlkx", gw, chol[:, :, x0:x0 + xc])
                acc = acc + torch.einsum("wlkx,wklx->w", t, t)
            parts.append(acc)
        exx = exx + torch.cat(parts)
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b


def coulomb_greens_function_ueg(ham, G: torch.Tensor):
    """(Gkpq, Gpmq) [w, nq]: sum_i G[i, idx(k_i +/- q)] over valid pairs,
    as one masked gather and reduction each."""
    m = G.shape[-1]
    rows = torch.arange(m, device=G.device)[None, :]
    gkpq = torch.sum(G[:, rows, ham.kpq_idx] * ham.kpq_mask[None], dim=-1)
    gpmq = torch.sum(G[:, rows, ham.pmq_idx] * ham.pmq_mask[None], dim=-1)
    return gkpq, gpmq


def exchange_greens_function_ueg(ham, G: torch.Tensor,
                                 q_chunk: int | None = None,
                                 max_elems: int = 2 ** 26) -> torch.Tensor:
    """Gprod[w, q] = sum_{ij} G[j, idx(k_i + q)] G[i, idx(k_j - q)]: per q an
    elementwise trace of two gathered matrices, in chunks of q (and, when
    one q exceeds the budget, of walkers) so that the [w, M, qc, M]
    intermediates stay under ``max_elems``, as in JAX."""
    m = G.shape[-1]
    w = G.shape[0]
    if q_chunk is None:
        q_chunk = max(1, max_elems // max(1, 2 * w * m * m))
    if w * m * m * 2 > max_elems and w > 1:
        half = w // 2
        return torch.cat([
            exchange_greens_function_ueg(ham, G[:half], None, max_elems),
            exchange_greens_function_ueg(ham, G[half:], None, max_elems)])
    nq = ham.kpq_idx.shape[0]
    rdt = G.real.dtype
    out = []
    for q0 in range(0, nq, q_chunk):
        kpq_i = ham.kpq_idx[q0:q0 + q_chunk]
        pmq_i = ham.pmq_idx[q0:q0 + q_chunk]
        a = G[:, :, kpq_i] * ham.kpq_mask[q0:q0 + q_chunk].to(rdt)[None, None]
        b = G[:, :, pmq_i] * ham.pmq_mask[q0:q0 + q_chunk].to(rdt)[None, None]
        out.append(torch.einsum("wjqi,wiqj->wq", a, b))
    return torch.cat(out, dim=-1)


def local_energy_ueg(ham, Ga: torch.Tensor, Gb: torch.Tensor):
    """(etot, e1b, e2b), each [w]:
    pe = 1/(2 vol) sum_q v(q) [sum over spin pairs Gkpq_s Gpmq_s'
    - Gprod_up - Gprod_dn]; the Madelung ecore is not added (as in the
    reference kernel)."""
    h1 = ham.H1.to(Ga.dtype)
    ke = (torch.einsum("mn,wmn->w", h1[0], Ga)
          + torch.einsum("mn,wmn->w", h1[1], Gb))
    gkpq_a, gpmq_a = coulomb_greens_function_ueg(ham, Ga)
    gkpq_b, gpmq_b = coulomb_greens_function_ueg(ham, Gb)
    gprod_a = exchange_greens_function_ueg(ham, Ga)
    gprod_b = exchange_greens_function_ueg(ham, Gb)
    vq = ham.vqvec.to(Ga.dtype)
    ess = (torch.einsum("q,wq->w", vq, gkpq_a * gpmq_a - gprod_a)
           + torch.einsum("q,wq->w", vq, gkpq_b * gpmq_b - gprod_b))
    eos = (torch.einsum("q,wq->w", vq, gkpq_a * gpmq_b)
           + torch.einsum("q,wq->w", vq, gkpq_b * gpmq_a))
    fac = 1.0 / (2.0 * ham.vol)
    pe = fac * (ess + eos)
    return ke + pe, ke, pe


def _exx_host(chol: np.ndarray, g: np.ndarray, max_elems: int = 1 << 22):
    """sum_x sum_ij t_ijx t_jix with t[:, :, x] = L_x g^T, as batched
    [M, M] products over chunks of the Cholesky axis (no [M, M, X]
    intermediate)."""
    m, _, nx = chol.shape
    chunk = max(1, max_elems // (m * m))
    total = 0.0
    for x0 in range(0, nx, chunk):
        t = np.moveaxis(chol[:, :, x0:x0 + chunk], 2, 0) @ g.T
        total = total + np.sum(t * np.swapaxes(t, 1, 2))
    return total


def local_energy_G_host(ham, G: np.ndarray):
    """(etot, e1b, e2b) of one Green's function G [2, M, M], host-side."""
    if ham.name == "Generic":
        # Dense contraction from the Cholesky factors,
        # (ik|jl) = sum_x L[i,k,x] L[j,l,x].
        h1 = ham.H1.cpu().numpy()
        chol = ham.chol.cpu().numpy()                     # [M, M, X]
        m = chol.shape[0]
        e1b = np.sum(h1[0] * G[0]) + np.sum(h1[1] * G[1])
        xv = (G[0] + G[1]).reshape(-1) @ chol.reshape(m * m, -1)
        ecoul = 0.5 * np.dot(xv, xv)
        exx = 0.5 * (_exx_host(chol, G[0]) + _exx_host(chol, G[1]))
        e2b = ecoul - exx
        return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b
    if ham.name == "UEG":
        # The batched kernel on one walker, in complex128.
        g = torch.from_numpy(np.asarray(G, dtype=np.complex128)).to(
            ham.H1.device)
        return tuple(x[0].item() for x in local_energy_ueg(ham, g[0][None],
                                                            g[1][None]))
    if ham.name != "Hubbard":
        raise NotImplementedError(f"no host local energy for {ham.name!r}")
    t = ham.T.cpu().numpy()
    ke = np.sum(t[0] * G[0] + t[1] * G[1])
    if ham.symmetric:
        pe = -0.5 * ham.U * (np.trace(G[0]) + np.trace(G[1]))
    else:
        pe = ham.U * np.dot(np.diagonal(G[0]), np.diagonal(G[1]))
    return ke + pe, ke, pe
