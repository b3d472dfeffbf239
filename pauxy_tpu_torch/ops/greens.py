"""Batched Slater-determinant overlaps and Green's functions, [w, M, n].

Counterpart of ``overlap_matrix``, ``log_overlap``, ``SpinGreens``,
``greens_function``, ``gab`` and ``reortho`` in ``pauxy_tpu/ops/greens.py``.
``phi`` is [w, M, n], ``psi`` [M, n]; the overlap is S = phi^T conj(psi),
kept in log space. The inverse and log-determinant of S come from kernel B
in one pass; the two products around it are plain batched matmuls, as they
are plain XLA products outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pauxy_tpu_torch.ops import clinalg


class SpinGreens(NamedTuple):
    """Green's function of one spin sector, batched over walkers."""

    G: torch.Tensor | None  # [w, M, M] full Green's function
    Ghalf: torch.Tensor     # [w, n, M] half-rotated Green's function
    log_ovlp: torch.Tensor  # [w] complex log det(phi^T conj(psi))
    # Multi-determinant trials: Ghalf is [w, D, n, M] per determinant, G
    # the det-weighted one, and these the weights [w, D].
    det_weights: torch.Tensor | None = None


def overlap_matrix(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """S = phi^T conj(psi), shape [w, n, n]."""
    return torch.einsum("wmi,mj->wij", phi, psi.conj())


def log_overlap(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Batched complex log det(phi^T conj(psi)), shape [w]."""
    return clinalg.slogdet(overlap_matrix(phi, psi)).to(phi.dtype)


def greens_function(phi: torch.Tensor, psi: torch.Tensor,
                    want_g: bool = True) -> SpinGreens:
    """G = conj(psi) S^-1 phi^T and Ghalf = S^-1 phi^T with their log
    overlap; S^-1 and log det S from one launch of kernel B. With
    ``want_g=False`` only Ghalf is formed (G is None), for the
    half-rotated Generic energy and force bias."""
    log_det, inv = clinalg.inv_logdet(overlap_matrix(phi, psi))
    ghalf = torch.matmul(inv, phi.transpose(-1, -2))      # [w, n, M]
    g = (torch.einsum("mi,win->wmn", psi.conj(), ghalf) if want_g
         else None)
    return SpinGreens(G=g, Ghalf=ghalf, log_ovlp=log_det.to(phi.dtype))


def gab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-particle Green's function between two batched determinants,
    G = B (A^H B)^-1 A^H with a, b [..., M, n]; the solve is kernel B's
    inverse on the card."""
    adag = a.conj().transpose(-1, -2)                     # [..., n, M]
    return torch.matmul(b, clinalg.solve(torch.matmul(adag, b), adag))


def reortho(phi: torch.Tensor):
    """Re-orthogonalised ``phi`` and log det R (real, [w]) by CholeskyQR2,
    det R real positive by construction."""
    return clinalg.cholesky_qr2(phi)
