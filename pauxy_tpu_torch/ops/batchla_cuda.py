"""Kernel B (batched inverse + log-determinant) and the Cholesky-inverse
kernel.

Counterparts of ``inv_logdet_lanes`` / ``slogdet_lanes`` and
``chol_inv_lanes`` in ``pauxy_tpu/ops/batchla_pallas.py``. Matrices arrive
as [w, n, n] and both kernels take them as they come: kernel B
(``csrc/batchla.cu``) one thread block per matrix, up to ``inv_max_n``; the
Cholesky kernel (``csrc/chol_inv.cu``) a group of lanes per matrix up to
n = 32 and a block per matrix above, up to ``chol_max_n`` (``chol_plan``).
Each wrapper launches its CUDA kernel on a CUDA tensor and calls its plain
PyTorch version on a CPU tensor; any other device, or a CUDA tensor the
kernel does not take, raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far (kernel B and the Cholesky kernel); a run can
# show that its path used the kernels.
launches = 0
chol_launches = 0

# Shared memory one block may use on sm_90 (kSmemMax in gauss_jordan.cuh),
# and what a block of kernel B keeps beside its matrix (kBlockStaticBytes
# in batchla.cu).
SMEM_MAX = cuda_build.SMEM_MAX
BLOCK_STATIC_BYTES = 64

_INV_SYMBOLS = {
    torch.complex64: "pauxy_inv_logdet_c64",
    torch.complex128: "pauxy_inv_logdet_c128",
    torch.float32: "pauxy_inv_logdet_f32",
    torch.float64: "pauxy_inv_logdet_f64",
}
_CHOL_SYMBOLS = {
    torch.complex64: "pauxy_chol_inv_c64",
    torch.complex128: "pauxy_chol_inv_c128",
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
    """Augmented Gauss-Jordan on [S | I] in the lanes layout
    (lanelinalg.gauss, the TPU kernel's order): an elimination independent
    of kernel B's, against which the card's checks also hold it. Real input
    is eliminated as complex with zero imaginary parts; its inverse comes
    back real."""
    w, n, _ = s.shape
    lanes = ll.to_lanes(s)                                # [n, n, W]
    if not want_inv:
        return ll.slogdet(lanes), None
    eye = torch.eye(n, dtype=s.dtype, device=s.device)[:, :, None]
    logdet, inv = ll.gauss(lanes, eye.expand(n, n, w))
    if not s.is_complex():
        inv = inv.real
    return logdet, ll.from_lanes(inv)


def _mag2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 with each product and the sum rounded, as the kernel's."""
    if x.is_complex():
        return x.real * x.real + x.imag * x.imag
    return x * x


def inv_logdet_plain(s: torch.Tensor, want_inv: bool = True):
    """Plain version of kernel B, in its order on [w, n, n]: the pivot is
    the lowest row attaining the largest |a_ik|^2; with the inverse,
    in-place Gauss-Jordan (column k of the working matrix becomes column k
    of the inverse, the row swaps undone as a column permutation at the
    end); without it, LU below the diagonal only. Real input stays real.
    A zero pivot adds -inf to log|det|, leaves the phase unchanged and
    eliminates nothing (its reciprocal is taken as 0)."""
    w, n, _ = s.shape
    cdtype = config.get_precision(s.dtype).cplx
    a = s.clone(memory_format=torch.contiguous_format)
    rows = torch.arange(w, device=s.device)
    ldr = torch.zeros(w, dtype=s.real.dtype, device=s.device)
    phase = torch.ones(w, dtype=s.dtype, device=s.device)
    pos = torch.arange(n, device=s.device).expand(w, n)
    for k in range(n):
        piv = k + torch.argmax(_mag2(a[:, k:, k]), dim=1)       # first max
        top = a[:, k].clone()
        a[:, k] = a[rows, piv]
        a[rows, piv] = top
        p = a[:, k, k]
        den = _mag2(p)
        ldr = ldr + 0.5 * torch.log(den)
        # A zero pivot keeps the phase (log 0 = -inf goes to ldr alone).
        unit = torch.where(den == 0, torch.ones_like(p), p * torch.rsqrt(den))
        phase = phase * torch.where(piv != k, -unit, unit)
        pinv = p.conj() / den if p.is_complex() else 1.0 / p
        pinv = torch.where(den == 0, torch.zeros_like(pinv), pinv)
        if want_inv:
            rowk = a[:, k] * pinv[:, None]
            rowk[:, k] = pinv
            f = a[:, :, k].clone()
            f[:, k] = 0
            a[:, :, k] = 0
            a -= f[:, :, None] * rowk[:, None, :]
            a[:, k] = rowk
            kk = torch.full_like(pos, k)
            pos = torch.where(pos == k, piv[:, None],
                              torch.where(pos == piv[:, None], kk, pos))
        else:
            f = a[:, k + 1:, k] * pinv[:, None]
            a[:, k + 1:, k + 1:] -= f[:, :, None] * a[:, k, None, k + 1:]
    if phase.is_complex():
        arg = torch.atan2(phase.imag, phase.real)
    else:
        arg = torch.atan2(torch.zeros_like(phase), phase)
    logdet = torch.complex(ldr, arg).to(cdtype)
    if not want_inv:
        return logdet, None
    # Column c of S^-1 is column pos[c] of the working matrix.
    return logdet, torch.gather(a, 2, pos[:, None, :].expand(w, n, n))


def inv_logdet_lanes(s: torch.Tensor, want_inv: bool = True):
    """(logdet [w] complex, inverse [w, n, n] of s.dtype or None) of
    s [w, n, n], complex or real. The imaginary part of logdet is defined
    modulo 2 pi (0 or pi for real input). n up to ``inv_max_n``."""
    global launches
    if s.device.type == "cpu":
        return inv_logdet_plain(s, want_inv)
    _check(s, "inv_logdet_lanes", _INV_SYMBOLS)
    w, n, _ = s.shape
    cdtype = config.get_precision(s.dtype).cplx
    if n == 0 or w == 0:
        logdet = torch.zeros(w, dtype=cdtype, device=s.device)
        return logdet, (torch.empty_like(s) if want_inv else None)
    s = s.contiguous()
    logdet = torch.empty(w, dtype=cdtype, device=s.device)
    inv = torch.empty_like(s) if want_inv else None
    fn = getattr(cuda_build.library(), _INV_SYMBOLS[s.dtype])
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(s.data_ptr(), logdet.data_ptr(),
                inv.data_ptr() if want_inv else None, n, w, int(want_inv),
                stream)
    cuda_build.check(rc, "inv_logdet_lanes")
    launches += 1
    return logdet, inv


def slogdet_lanes(s: torch.Tensor) -> torch.Tensor:
    """Batched complex log-determinant of [..., n, n]."""
    batch = s.shape[:-2]
    flat = s.reshape((-1,) + tuple(s.shape[-2:]))
    ld, _ = inv_logdet_lanes(flat, want_inv=False)
    return ld.reshape(batch)


@functools.lru_cache(maxsize=None)
def inv_max_n(dtype: torch.dtype) -> int:
    """Largest n kernel B can launch for ``dtype``, in either mode: the
    n x n matrix, rows padded to the odd stride n | 1, must fit one block's
    shared memory beside BLOCK_STATIC_BYTES. 120 in complex128, 169 in
    complex64 and float64, 241 in float32; derived once per type.
    ops/clinalg sends larger n to torch.linalg."""
    size = dtype.itemsize
    n = math.isqrt((SMEM_MAX - BLOCK_STATIC_BYTES) // size)
    while n * (n | 1) * size + BLOCK_STATIC_BYTES > SMEM_MAX:
        n -= 1
    return n


def chol_max_n(dtype: torch.dtype) -> int:
    """Largest n the Cholesky kernel can launch: one n x n complex matrix
    (rows unpadded at the cap) must fit a block's shared memory (170 in
    complex64, 120 in complex128). ops/clinalg.cholesky_qr sends larger n
    to torch.linalg. A closed form, nothing to cache."""
    return math.isqrt(SMEM_MAX // config.get_precision(dtype).cplx.itemsize)


# csrc/chol_inv.cu: threads a block on each route, and the largest n of the
# lanes route (one warp's lanes a matrix at most).
CHOL_LANE_THREADS = 64
CHOL_BLOCK_THREADS = 256
CHOL_LANES_MAX_N = 32


class CholPlan(NamedTuple):
    """The Cholesky kernel's launch, which csrc/chol_inv.cu checks and
    takes: ``threads`` a block, ``group`` threads a matrix, the thread of
    row tg mod ``rows`` (and, on the block route, of the columns
    tg // rows mod group // rows), the row stride ``ld``."""
    route: str
    threads: int
    group: int
    rows: int
    ld: int


@functools.lru_cache(maxsize=None)
def chol_plan(n: int, dtype: torch.dtype) -> CholPlan:
    """The launch for s [w, n, n] of ``dtype`` (n <= ``chol_max_n``):
    n <= 32 the "lanes" route, a group of G lanes a matrix (the next power
    of two >= n), lane r owning row r, CHOL_LANE_THREADS / G matrices a
    block; n > 32 the "block" route, CHOL_BLOCK_THREADS threads a matrix,
    thread t owning row t mod n and every (t // n)-th column of it. Rows
    padded to the odd stride n | 1 where the block's matrices still fit.
    Raises ValueError past the cap, where no launch exists."""
    cap = chol_max_n(dtype)
    if not 1 <= n <= cap:
        raise ValueError(f"chol_inv_lanes: n = {n} outside 1..{cap}, what "
                         f"the kernel takes in {dtype}")
    size = config.get_precision(dtype).cplx.itemsize
    if n <= CHOL_LANES_MAX_N:
        group = 1 << (n - 1).bit_length()
        route, threads, rows = "lanes", CHOL_LANE_THREADS, group
    else:
        route, threads = "block", CHOL_BLOCK_THREADS
        group, rows = threads, n
    ld = n | 1
    if threads // group * n * ld * size > SMEM_MAX:
        ld = n
    return CholPlan(route, threads, group, rows, ld)


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
    s [w, n, n] = L L^H with diag(L) real positive (its lower triangle is
    read); complex input on the card, n up to ``chol_max_n``."""
    global chol_launches
    if s.device.type == "cpu":
        return chol_inv_lanes_plain(s)
    _check(s, "chol_inv_lanes", _CHOL_SYMBOLS)
    w, n, _ = s.shape
    if n == 0 or w == 0:
        return (torch.zeros(w, dtype=s.real.dtype, device=s.device),
                torch.empty_like(s))
    pl = chol_plan(n, s.dtype)
    s = s.contiguous()
    # The kernel writes every matrix's log-determinant and every entry.
    log_l = torch.empty(w, dtype=s.real.dtype, device=s.device)
    linv = torch.empty_like(s)
    fn = getattr(cuda_build.library(), _CHOL_SYMBOLS[s.dtype])
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(s.data_ptr(), log_l.data_ptr(), linv.data_ptr(), n, w,
                pl.threads, pl.group, pl.rows, pl.ld, stream)
    cuda_build.check(rc, "chol_inv_lanes")
    chol_launches += 1
    return log_l, linv
