"""The fused Taylor exp(VHS)-apply kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas``:
phi <- sum_{k <= order} VHS^k phi / k! per walker, VHS read once per
column chunk instead of once per order. ``apply_taylor`` launches the CUDA
kernel of ``csrc/taylor.cu`` on a CUDA tensor and calls
``apply_taylor_plain`` on a CPU tensor; any other device, or a CUDA tensor
the kernel does not take, raises. The bf16 multiplicand option of the TPU
kernel is not ported.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import cuda_build

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

# Largest M the kernel takes: a 1024-thread block holds 32 columns x 8 rows
# a thread in complex64 and 16 x 4 in complex128.
MAX_M = 256

_SYMBOLS = {torch.complex64: "pauxy_taylor_c64",
            torch.complex128: "pauxy_taylor_c128"}


def apply_taylor_plain(vhs: torch.Tensor, phi: torch.Tensor,
                       order: int = 6) -> torch.Tensor:
    """Plain version, also the Generic propagator's "xla" route: the
    series as batched matmuls, each term scaled by 1/k as the kernel
    scales it. vhs [w, M, M], phi [w, M, C]."""
    term = out = phi
    for k in range(1, order + 1):
        term = torch.matmul(vhs, term) * (1.0 / k)
        out = out + term
    return out


def apply_taylor(vhs: torch.Tensor, phi: torch.Tensor,
                 order: int = 6) -> torch.Tensor:
    """exp(vhs) phi to ``order``: vhs [w, M, M], phi [w, M, C], complex64
    or complex128, contiguous, on one device. Returns [w, M, C]."""
    global launches
    if phi.device.type == "cpu":
        return apply_taylor_plain(vhs, phi, order)
    if phi.device.type != "cuda" or vhs.device != phi.device:
        raise ValueError(f"apply_taylor: tensors on {vhs.device} and "
                         f"{phi.device}, want one CUDA device")
    if phi.dtype not in _SYMBOLS or vhs.dtype != phi.dtype:
        raise TypeError(f"apply_taylor: needs complex64 or complex128 for "
                        f"both, got {vhs.dtype} and {phi.dtype}")
    if (vhs.dim() != 3 or phi.dim() != 3 or vhs.shape[1] != vhs.shape[2]
            or vhs.shape[:2] != phi.shape[:2]):
        raise ValueError(f"apply_taylor: shapes {tuple(vhs.shape)} and "
                         f"{tuple(phi.shape)}, want [w, M, M] and [w, M, C]")
    if not (vhs.is_contiguous() and phi.is_contiguous()):
        raise ValueError("apply_taylor: needs contiguous tensors")
    w, m, ncol = phi.shape
    if m > MAX_M or order < 0:
        raise ValueError(f"apply_taylor: M = {m} > {MAX_M} or order "
                         f"{order} < 0")
    out = torch.empty_like(phi)
    if w == 0 or ncol == 0:
        return out
    fn = getattr(cuda_build.library(), _SYMBOLS[phi.dtype])
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vhs.data_ptr(), phi.data_ptr(), out.data_ptr(), w, m, ncol,
                order, stream)
    cuda_build.check(rc, "apply_taylor")
    launches += 1
    return out
