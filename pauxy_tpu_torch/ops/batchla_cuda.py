"""Kernel B (batched inverse + log-determinant) and the Cholesky-inverse
kernel.

Counterparts of ``inv_logdet_lanes`` / ``slogdet_lanes`` and
``chol_inv_lanes`` in ``pauxy_tpu/ops/batchla_pallas.py``. Matrices arrive
as [w, n, n]; each wrapper moves the batch axis last ([n, n, W], one thread
per matrix reads coalesced), launches its CUDA kernel (``csrc/batchla.cu``,
``csrc/chol_inv.cu``) on a CUDA tensor and calls the plain PyTorch version
on a CPU tensor; any other device, or a CUDA tensor the kernel does not
take, raises.
"""

from __future__ import annotations

import math

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far (kernel B, the Cholesky kernel); a run can show
# that its path used the kernels.
launches = 0
chol_launches = 0

# Shared memory one block may use on sm_90 (kSmemMax in gauss_jordan.cuh).
SMEM_MAX = 232448

_INV_SYMBOLS = {
    torch.complex64: "pauxy_inv_logdet_lanes_c64",
    torch.complex128: "pauxy_inv_logdet_lanes_c128",
    torch.float32: "pauxy_inv_logdet_lanes_f32",
    torch.float64: "pauxy_inv_logdet_lanes_f64",
}
_CHOL_SYMBOLS = {
    torch.complex64: "pauxy_chol_inv_lanes_c64",
    torch.complex128: "pauxy_chol_inv_lanes_c128",
}


def _check(s: torch.Tensor, what: str, symbols: dict) -> None:
    if s.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {s.device}")
    if s.dtype not in symbols:
        raise TypeError(f"{what}: needs one of {list(symbols)}, got "
                        f"{s.dtype}")
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"{what}: shape {tuple(s.shape)}, want [w, n, n]")


def inv_logdet_lanes_plain(s: torch.Tensor, want_inv: bool = True):
    """Plain version: lanelinalg.gauss on the lanes layout. Real input is
    eliminated as complex with zero imaginary parts; its inverse comes back
    real."""
    w, n, _ = s.shape
    lanes = ll.to_lanes(s)                                # [n, n, W]
    if not want_inv:
        return ll.slogdet(lanes), None
    eye = torch.eye(n, dtype=s.dtype, device=s.device)[:, :, None]
    logdet, inv = ll.gauss(lanes, eye.expand(n, n, w))
    if not s.is_complex():
        inv = inv.real
    return logdet, ll.from_lanes(inv)


def inv_logdet_lanes(s: torch.Tensor, want_inv: bool = True):
    """(logdet [w] complex, inverse [w, n, n] of s.dtype or None) of
    s [w, n, n], complex or real. The imaginary part of logdet is defined
    modulo 2 pi (0 or pi for real input)."""
    global launches
    if s.device.type == "cpu":
        return inv_logdet_lanes_plain(s, want_inv)
    _check(s, "inv_logdet_lanes", _INV_SYMBOLS)
    w, n, _ = s.shape
    cdtype = config.get_precision(s.dtype).cplx
    logdet = torch.zeros(w, dtype=cdtype, device=s.device)
    if n == 0 or w == 0:
        return logdet, (torch.empty_like(s) if want_inv else None)
    lanes = ll.to_lanes(s)                                # contiguous copy
    inv = torch.empty_like(lanes) if want_inv else None
    fn = getattr(cuda_build.library(), _INV_SYMBOLS[s.dtype])
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(lanes.data_ptr(), logdet.data_ptr(),
                inv.data_ptr() if want_inv else None, n, w, int(want_inv),
                stream)
    cuda_build.check(rc, "inv_logdet_lanes")
    launches += 1
    return logdet, (ll.from_lanes(inv) if want_inv else None)


def slogdet_lanes(s: torch.Tensor) -> torch.Tensor:
    """Batched complex log-determinant of [..., n, n]."""
    batch = s.shape[:-2]
    flat = s.reshape((-1,) + tuple(s.shape[-2:]))
    ld, _ = inv_logdet_lanes(flat, want_inv=False)
    return ld.reshape(batch)


def inv_max_n(dtype: torch.dtype, want_inv: bool = True) -> int:
    """Largest n kernel B can launch for ``dtype``: one walker's n x n
    matrix (n x 2n with the inverse beside it) must fit in a block's shared
    memory (walkers_per_block in gauss_jordan.cuh). With the inverse: 170
    float32, 120 float64 and complex64, 85 complex128; log-det only: 241,
    170, 170, 120. ops/clinalg sends larger n to torch.linalg."""
    per_entry = dtype.itemsize * (2 if want_inv else 1)
    return math.isqrt(SMEM_MAX // per_entry)


def chol_max_n(dtype: torch.dtype) -> int:
    """Largest n the Cholesky kernel can launch: one walker's n x n complex
    matrix must fit in a block's shared memory (170 in complex64, 120 in
    complex128). ops/clinalg.cholesky_qr sends larger n to torch.linalg."""
    return math.isqrt(SMEM_MAX // config.get_precision(dtype).cplx.itemsize)


def chol_inv_lanes_plain(s: torch.Tensor):
    """Plain version: the TPU kernel's right-looking Cholesky with the
    1e-30 guard, then L^-1 by forward substitution, lane-parallel."""
    w, n, _ = s.shape
    a = ll.to_lanes(s)                                    # [n, n, W] copy
    log_l = torch.zeros(w, dtype=s.real.dtype, device=s.device)
    for k in range(n):
        dk = torch.sqrt(torch.clamp_min(a[k, k].real, 1e-30))
        log_l = log_l + torch.log(dk)
        col = a[:, k] / dk
        col[:k] = 0
        col[k] = dk
        a[k + 1:, k + 1:] -= col[k + 1:, None] * col[None, k + 1:].conj()
        a[:, k] = col
    x = torch.eye(n, dtype=s.dtype, device=s.device)[:, :, None]
    x = x.expand(n, n, w).clone()
    for k in range(n):
        x[k] = x[k] / a[k, k].real
        x[k + 1:] -= a[k + 1:, k, None] * x[k][None]
    return log_l, ll.from_lanes(x)


def chol_inv_lanes(s: torch.Tensor):
    """(log det L [w] real, L^-1 [w, n, n]) of Hermitian positive-definite
    s [w, n, n] = L L^H with diag(L) real positive; complex input on the
    card."""
    global chol_launches
    if s.device.type == "cpu":
        return chol_inv_lanes_plain(s)
    _check(s, "chol_inv_lanes", _CHOL_SYMBOLS)
    w, n, _ = s.shape
    log_l = torch.zeros(w, dtype=s.real.dtype, device=s.device)
    if n == 0 or w == 0:
        return log_l, torch.empty_like(s)
    lanes = ll.to_lanes(s)
    linv = torch.empty_like(lanes)
    fn = getattr(cuda_build.library(), _CHOL_SYMBOLS[s.dtype])
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(lanes.data_ptr(), log_l.data_ptr(), linv.data_ptr(), n, w,
                stream)
    cuda_build.check(rc, "chol_inv_lanes")
    chol_launches += 1
    return log_l, ll.from_lanes(linv)
