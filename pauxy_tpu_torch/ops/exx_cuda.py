"""The exchange-contraction kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/exx_pallas.py:exx_pallas``:
exx[w] = sum_x tr(T_wx T_wx), T_wx = rchol_x Ghalf_w^T, for a real rchol.
``exx`` launches the CUDA kernel of ``csrc/exx.cu`` on a CUDA tensor of
any shape (the kernel stages its inputs in column chunks) and calls
``exx_plain`` on a CPU tensor; any other device, or a CUDA tensor of a type
or layout the kernel does not take, raises. ``exx_plain`` is also the
einsum route of ``estimators/local_energy._exx`` (any rchol, chunked over
the Cholesky axis).
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops.contract import cr_einsum

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

_SYMBOLS = {torch.complex64: "pauxy_exx_c64",
            torch.complex128: "pauxy_exx_c128"}


def _chunks(nx: int, w: int, n: int, max_elems: int) -> int:
    """Cholesky vectors per chunk so [w, chunk, n, n] stays <= max_elems."""
    return max(1, max_elems // max(1, w * n * n))


def exx_plain(rchol: torch.Tensor, ghalf: torch.Tensor,
              max_elems: int = 1 << 27) -> torch.Tensor:
    """Plain version: T = einsum('xim,wjm->wxij') and its transpose trace,
    one einsum when [w, X, n, n] has at most ``max_elems`` elements, else
    summed over chunks of the Cholesky axis. rchol real or complex."""
    nx, n, _ = rchol.shape
    w = ghalf.shape[0]
    chunk = _chunks(nx, w, n, max_elems)
    acc = None
    for x0 in range(0, nx, chunk):
        t = cr_einsum("xim,wjm->wxij", rchol[x0:x0 + chunk], ghalf)
        part = torch.einsum("wxij,wxji->w", t, t)
        acc = part if acc is None else acc + part
    if acc is None:
        return torch.zeros(w, dtype=ghalf.dtype, device=ghalf.device)
    return acc


def exx_magnitude(rchol: torch.Tensor, ghalf: torch.Tensor,
                  max_elems: int = 1 << 25) -> torch.Tensor:
    """S[w] = sum_x sum_ij |T_ij| |T_ji| in float64: the scale a kernel's
    error is held to (exx sums X n^2 products that may cancel)."""
    rchol = rchol.to(torch.float64 if not rchol.is_complex()
                     else torch.complex128)
    ghalf = ghalf.to(torch.complex128)
    nx, n, _ = rchol.shape
    w = ghalf.shape[0]
    chunk = _chunks(nx, w, n, max_elems)
    acc = torch.zeros(w, dtype=torch.float64, device=ghalf.device)
    for x0 in range(0, nx, chunk):
        t = cr_einsum("xim,wjm->wxij", rchol[x0:x0 + chunk], ghalf).abs()
        acc = acc + torch.einsum("wxij,wxji->w", t, t)
    return acc


def exx(rchol: torch.Tensor, ghalf: torch.Tensor) -> torch.Tensor:
    """exx [w] of ghalf's complex type: rchol [X, n, M] real, ghalf
    [w, n, M] complex of the same precision, contiguous, on one device."""
    global launches
    if ghalf.device.type == "cpu":
        return exx_plain(rchol, ghalf)
    if ghalf.device.type != "cuda" or rchol.device != ghalf.device:
        raise ValueError(f"exx: tensors on {rchol.device} and "
                         f"{ghalf.device}, want one CUDA device")
    if (ghalf.dtype not in _SYMBOLS or rchol.is_complex()
            or rchol.dtype != config.real_dtype(ghalf.dtype)):
        raise TypeError(f"exx: needs real rchol and complex ghalf of one "
                        f"precision, got {rchol.dtype} and {ghalf.dtype}")
    if (rchol.dim() != 3 or ghalf.dim() != 3
            or rchol.shape[1:] != ghalf.shape[1:]):
        raise ValueError(f"exx: shapes {tuple(rchol.shape)} and "
                         f"{tuple(ghalf.shape)}, want [X, n, M] and "
                         f"[w, n, M]")
    if not (rchol.is_contiguous() and ghalf.is_contiguous()):
        raise ValueError("exx: needs contiguous tensors")
    nx, n, m = rchol.shape
    w = ghalf.shape[0]
    out = torch.zeros(w, dtype=ghalf.dtype, device=ghalf.device)
    if w == 0 or n == 0 or m == 0:
        return out
    fn = getattr(cuda_build.library(), _SYMBOLS[ghalf.dtype])
    with torch.cuda.device(ghalf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(rchol.data_ptr(), ghalf.data_ptr(), out.data_ptr(), nx, n, m,
                w, stream)
    cuda_build.check(rc, "exx")
    launches += 1
    return out
