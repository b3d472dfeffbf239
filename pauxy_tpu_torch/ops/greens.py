"""Batched Slater-determinant overlaps on the [w, M, n] layout.

Counterpart of ``overlap_matrix`` / ``log_overlap`` in
``pauxy_tpu/ops/greens.py``. ``phi`` is [w, M, n], ``psi`` [M, n]; the
overlap is S = phi^T conj(psi), kept in log space.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import clinalg


def overlap_matrix(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """S = phi^T conj(psi), shape [w, n, n]."""
    return torch.einsum("wmi,mj->wij", phi, psi.conj())


def log_overlap(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Batched complex log det(phi^T conj(psi)), shape [w]."""
    return clinalg.slogdet(overlap_matrix(phi, psi)).to(phi.dtype)
