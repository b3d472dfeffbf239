"""Finite-temperature estimator kernels, batched.

Counterpart of ``pauxy_tpu/estimators/thermal.py``: the stable Green's
function G = (1 + B_L ... B_1)^-1 from a stack of propagator products by
column-pivoted QDT stratification (``ops/cpqr``), batched over walkers and
spins, with log det G from the QDT factors (never from an assembled G);
the one-RDM and particle number; and the host numpy versions used by the
trial set-up (with the mean-field entropy). The Db/Ds overflow splitting
is applied as intended (the reference's is dead code, as the JAX
docstring notes).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pauxy_tpu_torch.ops import clinalg, cpqr


def fermi_factor(ek, beta, mu):
    return 1.0 / (np.exp(beta * (ek - mu)) + 1.0)


def qdt_identity(batch_shape, m: int, dtype, device=None):
    """The empty QDT fold carry: Q = I, d = 1, T = I (folding a bin into it
    reproduces a direct factorization of that bin)."""
    eye = torch.eye(m, dtype=dtype, device=device).expand(
        *batch_shape, m, m).clone()
    return eye, torch.ones((*batch_shape, m), dtype=dtype,
                           device=device), eye.clone()


def qdt_fold(stack: torch.Tensor, carry, start: int, stop: int):
    """Fold bins [start, stop) of ``stack [..., nbins, m, m]`` into a QDT
    carry (q, d, t): C = (B_i Q) D -> pivoted QR -> new (Q, D, T)."""
    q, d, t = carry
    for i in range(start, stop):
        b = stack[..., i, :, :]
        c2 = torch.matmul(b, q) * d[..., None, :]
        q, r, perm = cpqr.cpqr(c2)
        d = torch.diagonal(r, dim1=-2, dim2=-1)
        tmp = cpqr.unpermute_columns(r / d[..., :, None], perm)
        t = torch.matmul(tmp, t)
    return q, d, t


def qdt_product(stack: torch.Tensor):
    """Stable QDT factorization of A = B[n-1] ... B[1] B[0] for
    ``stack [..., nbins, m, m]`` (index 0 applied first). Returns (q, d, t)
    with A ~= Q diag(d) T."""
    nbins = stack.shape[-3]
    q, r, perm = cpqr.cpqr(stack[..., 0, :, :])
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    t = cpqr.unpermute_columns(r / d[..., :, None], perm)
    return qdt_fold(stack, (q, d, t), 1, nbins)


def _assemble_qdt(q, d, t, want_logdet: bool):
    """G = T^-1 (Db Q^dag T^-1 + Ds)^-1 Db Q^dag from a QDT factorization
    of A, and optionally log det G = sum log db - slogdet(Q) - slogdet(C) -
    slogdet(T) with C = Db Q^dag T^-1 + Ds, from the same well-conditioned
    factors. The inverses and log-dets go through ``ops/clinalg`` (kernel B
    on the card)."""
    m = q.shape[-1]
    absd = d.abs()
    big = absd > 1.0
    one = torch.ones_like(absd)
    db = torch.where(big, 1.0 / absd, one).to(d.dtype)
    ds = torch.where(big, d / absd.to(d.dtype), d)
    eye = torch.eye(m, dtype=q.dtype, device=q.device)
    qh = q.conj().transpose(-1, -2)
    tinv = clinalg.inv(t)
    c = db[..., :, None] * torch.matmul(qh, tinv) + ds[..., :, None] * eye
    cinv_db_qdag = clinalg.solve(c, db[..., :, None] * qh)
    g = torch.matmul(tinv, cinv_db_qdag)
    if not want_logdet:
        return g, None
    logdet_g = (torch.log(db).sum(-1) - clinalg.slogdet(q)
                - clinalg.slogdet(c) - clinalg.slogdet(t))
    # Wrap the summed phases back to the principal branch.
    im = torch.remainder(logdet_g.imag + math.pi, 2 * math.pi) - math.pi
    return g, torch.complex(logdet_g.real, im)


def inverse_one_plus_qdt(q, d, t):
    """G = (1 + Q D T)^-1, stabilized (see :func:`_assemble_qdt`)."""
    return _assemble_qdt(q, d, t, want_logdet=False)[0]


def inverse_one_plus_qdt_logdet(q, d, t):
    """(G, log det G) = stabilized (1 + Q D T)^-1 from explicit factors
    (the prefix-cached per-slice path, propagation/thermal.py)."""
    return _assemble_qdt(q, d, t, want_logdet=True)


def greens_function_qdt(stack: torch.Tensor):
    """G = (1 + A)^-1 for A = product of the stack (rightmost index 0)."""
    return inverse_one_plus_qdt(*qdt_product(stack))


def greens_function_qdt_logdet(stack: torch.Tensor):
    """(G, log det G) from the stack's QDT factors."""
    return _assemble_qdt(*qdt_product(stack), want_logdet=True)


def one_rdm_from_G(g: torch.Tensor) -> torch.Tensor:
    """P = 1 - G^T per spin; g [..., m, m]."""
    m = g.shape[-1]
    return torch.eye(m, dtype=g.dtype, device=g.device) - g.transpose(-1, -2)


def particle_number(p: torch.Tensor) -> torch.Tensor:
    """<N> = tr P_up + tr P_dn; p [..., 2, m, m]."""
    tr = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1)
    return tr[..., 0] + tr[..., 1]


# ----------------------------------------------------------------------------
# Host-side (numpy/scipy) versions for trial set-up
# ----------------------------------------------------------------------------

def one_rdm_stable_host(bt: np.ndarray, num_slices: int) -> np.ndarray:
    """P for A = bt^num_slices per spin, host-side with scipy's pivoted QR
    (the chemical-potential search of the trial set-up)."""
    import scipy.linalg

    nb = bt.shape[-1]
    out = []
    for spin in (0, 1):
        q, r, p = scipy.linalg.qr(bt[spin], pivoting=True, check_finite=False)
        d = r.diagonal().copy()
        t = r / d[:, None]
        inv = np.argsort(p)
        t = t[:, inv]
        for _ in range(num_slices - 1):
            c2 = (bt[spin] @ q) * d[None, :]
            q, r, p = scipy.linalg.qr(c2, pivoting=True, check_finite=False)
            d = r.diagonal().copy()
            tmp = (r / d[:, None])[:, np.argsort(p)]
            t = tmp @ t
        absd = np.abs(d)
        db = np.where(absd > 1.0, 1.0 / absd, 1.0)
        ds = np.where(absd > 1.0, d / absd, d)
        tinv = scipy.linalg.inv(t, check_finite=False)
        c = db[:, None] * (q.conj().T @ tinv) + np.diag(ds)
        g = tinv @ scipy.linalg.solve(c, db[:, None] * q.conj().T)
        out.append(np.eye(nb) - g.T)
    return np.array(out)


def particle_number_host(p: np.ndarray) -> float:
    return (p[0].trace() + p[1].trace()).real


def entropy(beta: float, mu: float, h1: np.ndarray) -> float:
    """Mean-field (grand-canonical, one-body, spin-restricted) entropy
    S = -2 sum_i [p_i ln p_i + (1 - p_i) ln(1 - p_i)], p_i the Fermi
    factors of the eigenvalues of h1 (the thermal Hartree-Fock trial's
    grand-potential logging)."""
    h1 = np.asarray(h1)
    if np.linalg.norm(h1[0] - h1[1]) >= 1e-12:
        raise ValueError("entropy needs a spin-restricted one-body matrix")
    eigs = np.linalg.eigvalsh(h1[0])
    p = np.clip(fermi_factor(eigs, beta, mu), 1e-300, 1.0 - 1e-16)
    return float(-2.0 * np.sum(p * np.log(p) + (1 - p) * np.log1p(-p)))
