"""Mixed real/complex contractions.

Counterpart of ``pauxy_tpu/ops/contract.py``. Ab-initio Cholesky tensors and
their half-rotations are real for molecular Hamiltonians; contracting a real
weight against complex walker data as two real einsums (against the real and
imaginary parts) halves the work of the promoted complex product. Unlike
jnp.einsum, torch.einsum does not promote a real operand against a complex
one, it raises: every mixed contraction of the port goes through here.
"""

from __future__ import annotations

import torch


def _promoted(w: torch.Tensor, z: torch.Tensor):
    dtype = torch.promote_types(w.dtype, z.dtype)
    return w.to(dtype), z.to(dtype)


def cr_einsum(eq: str, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """einsum(eq, w, z) where the weight ``w`` may be real while ``z`` is
    complex: two real einsums recombined. Otherwise one einsum at the
    promoted type."""
    if w.is_complex() or not z.is_complex():
        return torch.einsum(eq, *_promoted(w, z))
    w = w.to(z.real.dtype)
    return torch.complex(torch.einsum(eq, w, z.real),
                         torch.einsum(eq, w, z.imag))


def rc_einsum(eq: str, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum(eq, z, w) with the possibly real weight second."""
    if w.is_complex() or not z.is_complex():
        return torch.einsum(eq, *reversed(_promoted(w, z)))
    w = w.to(z.real.dtype)
    return torch.complex(torch.einsum(eq, z.real, w),
                         torch.einsum(eq, z.imag, w))
