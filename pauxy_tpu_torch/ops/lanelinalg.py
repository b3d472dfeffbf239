"""Lane-parallel small-matrix linear algebra (walker axis LAST).

Counterpart of ``pauxy_tpu/ops/lanelinalg.py``. Matrices are [n, m, W] with
W the walker batch; factorizations are unrolled over the small static
matrix dimension as chains of elementwise [rows, W] tensor ops. On the card
the walker-last layout also makes one-thread-per-walker kernels read
coalesced (``csrc/``); these functions are the plain versions those kernels
are checked against, and the plain code of the main path.
"""

from __future__ import annotations

import math

import torch

from pauxy_tpu_torch import config


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """[w, ...] -> [..., w] (walker axis last), contiguous."""
    return torch.movedim(x, 0, -1).contiguous()


def from_lanes(x: torch.Tensor) -> torch.Tensor:
    """[..., w] -> [w, ...], contiguous."""
    return torch.movedim(x, -1, 0).contiguous()


def matmul_left(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [p, m] @ x [m, n, W] -> [p, n, W] as one 2-D product
    [p, m] @ [m, n*W] (the kinetic/B-matrix application)."""
    m, n, w = x.shape
    return (a @ x.reshape(m, n * w)).reshape(a.shape[0], n, w)


def overlap_lanes(psi: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """S[i, j, W] = sum_m conj(psi)[m, i] phi[m, j, W]."""
    return matmul_left(psi.conj().T, phi)


def gauss(s: torch.Tensor, rhs: torch.Tensor | None = None):
    """Partial-pivot Gaussian elimination, unrolled over the static n.

    s [n, n, W]; rhs [n, k, W] or None. Returns (logdet [W] complex,
    x [n, k, W] or None) with s @ x = rhs. The pivot is the first row
    attaining max |s_ik|; every swap adds i*pi to the log-determinant.
    """
    n = s.shape[0]
    w = s.shape[-1]
    cdtype = config.get_precision(s.dtype).cplx
    if n == 0:
        zero = torch.zeros(w, dtype=cdtype, device=s.device)
        return zero, (None if rhs is None else rhs.to(cdtype))
    aug = s if rhs is None else torch.cat([s, rhs], dim=1)
    aug = aug.to(cdtype)
    ncol = aug.shape[1]
    logdet = torch.zeros(w, dtype=cdtype, device=s.device)
    ipi = torch.tensor(1j * math.pi, dtype=cdtype, device=s.device)
    zero = torch.zeros((), dtype=cdtype, device=s.device)
    done_rows = []
    for k in range(n):
        rows = aug                                   # [r, ncol, W], r = n - k
        r = rows.shape[0]
        piv = torch.argmax(rows[:, k].abs(), dim=0)  # [W], first maximum
        sel = torch.gather(rows, 0, piv[None, None, :].expand(1, ncol, w))
        # Put the old top row where the pivot came from (masked select).
        mask = (torch.arange(r, device=s.device)[:, None, None]
                == piv[None, None, :])
        swapped = torch.where(mask, rows[0:1], rows)
        rows = torch.cat([sel, swapped[1:]], dim=0)
        logdet = logdet + torch.where(piv > 0, ipi, zero)
        pivval = rows[0, k]                          # [W]
        logdet = logdet + torch.log(pivval)
        if r > 1:
            factors = rows[1:, k] / pivval           # [r-1, W]
            rows = torch.cat(
                [rows[0:1], rows[1:] - factors[:, None, :] * rows[0:1]], dim=0
            )
        done_rows.append(rows[0])
        aug = rows[1:]
    if rhs is None:
        return logdet, None
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = done_rows[i][n:]                       # [k, W]
        for j in range(i + 1, n):
            acc = acc - done_rows[i][j][None, :] * xs[j]
        xs[i] = acc / done_rows[i][i][None, :]
    return logdet, torch.stack(xs, dim=0)


def slogdet(s: torch.Tensor) -> torch.Tensor:
    """Complex log-determinant of [n, n, W] (lane-parallel LU)."""
    return gauss(s)[0]


def _chol_r(g: torch.Tensor) -> torch.Tensor:
    """Upper-triangular R with R^dag R = g (Hermitian PD [n, n, W]),
    strictly-lower part zero."""
    n = g.shape[0]
    rows = []
    for i in range(n):
        # R[i, j] = (g[i, j] - sum_{k<i} conj(R[k, i]) R[k, j]) / R[i, i]
        acc = g[i]                                   # [n, W]
        for k in range(i):
            acc = acc - rows[k][i].conj()[None, :] * rows[k]
        dii = torch.sqrt(acc[i].real).to(g.dtype)    # [W]
        row = acc / dii[None, :]                     # fresh tensor
        row[i] = dii
        row[:i] = 0
        rows.append(row)
    return torch.stack(rows, dim=0)


def _solve_upper_right(phi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X = phi @ R^-1 for upper-triangular R [n, n, W], phi [m, n, W], by
    column forward substitution."""
    n = r.shape[0]
    cols = []
    for j in range(n):
        acc = phi[:, j]                              # [m, W]
        for k in range(j):
            acc = acc - cols[k] * r[k, j][None, :]
        cols.append(acc / r[j, j][None, :])
    return torch.stack(cols, dim=1)


def gram(phi: torch.Tensor) -> torch.Tensor:
    """G[i, j, W] = sum_m conj(phi)[m, i, W] phi[m, j, W]."""
    n = phi.shape[1]
    return torch.stack(
        [torch.sum(phi[:, i:i + 1].conj() * phi, dim=0) for i in range(n)],
        dim=0,
    )


def cholesky_qr2(phi: torch.Tensor):
    """CholeskyQR2 re-orthogonalisation in lanes layout.

    phi [m, n, W] -> (q [m, n, W], log_detr [W] real) with q^dag q = I and
    det(R) real positive (R = R2 R1, upper, positive diagonal).
    """
    if phi.shape[1] == 0:
        return phi, torch.zeros(phi.shape[-1:], dtype=phi.real.dtype,
                                device=phi.device)
    r1 = _chol_r(gram(phi))
    q1 = _solve_upper_right(phi, r1)
    r2 = _chol_r(gram(q1))
    q = _solve_upper_right(q1, r2)
    d1 = torch.diagonal(r1, dim1=0, dim2=1).real     # [W, n]
    d2 = torch.diagonal(r2, dim1=0, dim2=1).real
    return q, torch.sum(torch.log(d1) + torch.log(d2), dim=-1)
