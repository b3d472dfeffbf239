"""Batched column-pivoted Householder QR (complex or real).

Counterpart of ``cpqr`` and ``unpermute_columns`` in
``pauxy_tpu/ops/cpqr.py``: the finite-temperature QDT stratification's
pivoted QR, batched over walkers and spins. A CUDA tensor with
``pivot=True`` and m up to what the kernel launches (``cpqr_cuda.max_m``)
takes the kernel of ``csrc/cpqr.cu``; a larger m, and ``pivot=False``, take
the plain version, chosen by shape before any launch (as
``clinalg.cholesky_qr`` does with ``chol_max_n``). A CPU tensor takes the
plain version, the mirror of JAX's ``_cpqr_xla``. JAX's A/B machinery
(``_cpqr_xla_swaps``, ``PAUXY_TPU_CPQR``, the ``impl=`` names) and the
sharded variant are not ported.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import cpqr_cuda


def uses_kernel(a: torch.Tensor, pivot: bool = True) -> bool:
    """Whether :func:`cpqr` sends ``a`` to the kernel's wrapper: a pivoted
    CUDA tensor up to the kernel's cap (or of a type the kernel does not
    take, which the wrapper refuses)."""
    if not pivot or a.device.type != "cuda":
        return False
    return (a.dtype not in cpqr_cuda.DTYPES
            or a.shape[-1] <= cpqr_cuda.max_m(a.dtype))


def cpqr(a: torch.Tensor, pivot: bool = True):
    """Column-pivoted QR: a[..., :, perm] = q @ r.

    Returns (q, r, perm) with q unitary [..., m, m], r upper triangular,
    perm [..., m] (int64) such that column j of the pivoted a is original
    column perm[j] (scipy.linalg.qr(pivoting=True) convention). Any batch
    shape; real input gives a real factorization.
    """
    *batch, mrow, m = a.shape
    if mrow != m:
        raise ValueError(f"cpqr: square matrices only, got {tuple(a.shape)}")
    flat = a.reshape((-1, m, m))
    if uses_kernel(a, pivot):
        q, r, perm = cpqr_cuda.cpqr_lanes(flat)
    else:
        q, r, perm = cpqr_cuda.cpqr_lanes_plain(flat, pivot)
    return q.reshape(a.shape), r.reshape(a.shape), perm.reshape((*batch, m))


def unpermute_columns(t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """T' with T'[..., :, perm[j]] = T[..., :, j] (undo the pivoting), an
    exact index scatter."""
    idx = perm.unsqueeze(-2).expand(t.shape)
    return torch.empty_like(t).scatter_(-1, idx, t)
