"""Batched linear algebra: log-determinant, inverse, solve, CholeskyQR.

Counterpart of ``slogdet``, ``inv``, ``solve``, ``cholesky_qr`` and
``cholesky_qr2`` in ``pauxy_tpu/ops/clinalg.py``. Kernel B
(``batchla_cuda.inv_logdet_lanes``) and the Cholesky-inverse kernel
(``batchla_cuda.chol_inv_lanes``) run on a CUDA tensor, their plain
versions on a CPU tensor. Each function chooses its route by shape, before
any launch: n up to what the kernel launches for the type (and, for kernel
B, with or without the inverse) goes to the kernel wrapper, a larger n to
``torch.linalg``, on either device. The JAX module's real-embedding and
Schur-complement machinery worked around the TPU and is not ported.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import batchla_cuda


def uses_kernel_b(s: torch.Tensor, want_inv: bool) -> bool:
    """Whether ``s [..., n, n]`` goes to kernel B's wrapper (else to
    torch.linalg): n up to ``batchla_cuda.inv_max_n`` for its type and
    mode."""
    return s.shape[-1] <= batchla_cuda.inv_max_n(s.dtype, want_inv)


def _slogdet_linalg(s: torch.Tensor) -> torch.Tensor:
    sign, logabs = torch.linalg.slogdet(s)
    cdtype = config.get_precision(s.dtype).cplx
    return torch.complex(logabs, torch.angle(sign).to(logabs.dtype)).to(
        cdtype)


def slogdet(s: torch.Tensor) -> torch.Tensor:
    """Batched complex log-determinant (log|det| + i arg det), [...]."""
    if s.shape[-1] == 0:
        # det of the 0x0 matrix is 1 (fully spin-polarized blocks).
        return torch.zeros(s.shape[:-2], dtype=s.dtype, device=s.device)
    if not uses_kernel_b(s, want_inv=False):
        return _slogdet_linalg(s)
    return batchla_cuda.slogdet_lanes(s)


def inv_logdet(s: torch.Tensor):
    """(complex log det [...], inverse [..., n, n] of s.dtype), one pass
    of kernel B over the flattened batch."""
    if not uses_kernel_b(s, want_inv=True):
        return _slogdet_linalg(s), torch.linalg.inv(s)
    flat = s.reshape((-1,) + tuple(s.shape[-2:]))
    ld, inv = batchla_cuda.inv_logdet_lanes(flat)
    return ld.reshape(s.shape[:-2]), inv.reshape(s.shape)


def inv(s: torch.Tensor) -> torch.Tensor:
    """Batched explicit inverse of ``s [..., n, n]``, real or complex."""
    return inv_logdet(s)[1]


def solve(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched solve S X = Y, s [..., n, n], y [..., n, m]: the inverse
    from kernel B times y. The solution's type follows both operands (a real
    S with a complex Y has a complex solution)."""
    out_dtype = torch.promote_types(s.dtype, y.dtype)
    if s.shape[-1] == 0:
        return y.to(out_dtype)
    return torch.matmul(inv(s).to(out_dtype), y.to(out_dtype))


def cholesky_qr(phi: torch.Tensor):
    """One CholeskyQR pass: phi = Q R, Q orthonormal, diag(R) real positive.

    phi [..., M, n] -> (Q, log det R [..., 1]). With S = phi^H phi = L L^H,
    Q = phi L^-H. For n up to ``batchla_cuda.chol_max_n`` (what the
    Cholesky-inverse kernel can launch) L^-1 comes from that kernel; above
    it from torch.linalg, as the JAX package takes XLA's route above its
    kernel's cap. The route is chosen by shape, before any launch.
    """
    lead = phi.shape[:-2]
    if phi.shape[-1] == 0:
        return phi, torch.zeros(lead + (1,), dtype=phi.real.dtype,
                                device=phi.device)
    s = torch.matmul(phi.conj().transpose(-1, -2), phi)
    n = s.shape[-1]
    if n <= batchla_cuda.chol_max_n(s.dtype):
        flat = s.reshape((-1, n, n))
        ld, linv = batchla_cuda.chol_inv_lanes(flat)
        linv = linv.reshape(s.shape)
        # Q = phi L^-H; (L^-H)[j, i] = conj(linv[i, j]).
        q = torch.matmul(phi, linv.conj().transpose(-1, -2))
        return q, ld.reshape(lead + (1,))
    l = torch.linalg.cholesky(s)
    qh = torch.linalg.solve_triangular(l, phi.conj().transpose(-1, -2),
                                       upper=False)
    q = qh.conj_physical().transpose(-1, -2)
    return q, torch.log(torch.diagonal(l, dim1=-2, dim2=-1).real).sum(
        -1, keepdim=True)


def cholesky_qr2(phi: torch.Tensor):
    """CholeskyQR2: two passes for float32-grade stability. Returns
    (Q, log det R) with log det R real, [batch]."""
    q, d1 = cholesky_qr(phi)
    q, d2 = cholesky_qr(q)
    return q, (d1 + d2).sum(-1)
