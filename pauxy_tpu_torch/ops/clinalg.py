"""Batched complex linear algebra: the log-determinant.

Counterpart of ``slogdet`` in ``pauxy_tpu/ops/clinalg.py``: kernel B
(``batchla_cuda``) on a CUDA tensor, its plain version on a CPU tensor. The
JAX module's real-embedding and Schur-complement machinery worked around
the TPU and is not ported.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import batchla_cuda


def slogdet(s: torch.Tensor) -> torch.Tensor:
    """Batched complex log-determinant (log|det| + i arg det), [...]."""
    if s.shape[-1] == 0:
        # det of the 0x0 matrix is 1 (fully spin-polarized blocks).
        return torch.zeros(s.shape[:-2], dtype=s.dtype, device=s.device)
    return batchla_cuda.slogdet_lanes(s)
