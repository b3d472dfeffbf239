"""The exchange-contraction kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/exx_pallas.py:exx_pallas``:
exx[w] = sum_x tr(T_wx T_wx), T_wx = rchol_x Ghalf_w^T, for a real rchol.
``exx`` launches the CUDA kernels of ``csrc/exx.cu`` on a CUDA tensor of
any shape (the T builds of all walkers as one tiled GEMM with the
transpose-trace in its epilogue; ``plan`` chooses the tile and sizes the
scratch) and calls ``exx_plain`` on a CPU tensor; any other device, or a
CUDA tensor of a type or layout the kernel does not take, raises.
``exx_plain`` is also the einsum route of ``estimators/local_energy._exx``
(any rchol, chunked over the Cholesky axis).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops.cuda_build import round_up
from pauxy_tpu_torch.ops.contract import cr_einsum

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

_SYMBOLS = {torch.complex64: "pauxy_exx_c64",
            torch.complex128: "pauxy_exx_c128"}

# csrc/exx.cu's tiles: rows (TM) and columns (TN) a thread owns, depth of a
# k-slab (KS), and the tile aimed at (rows x complex columns); the largest
# index block, ring stages and threads a block.
TILES = {torch.complex64: (8, 4, 16, 128, 128),
         torch.complex128: (4, 4, 8, 84, 84)}
MAX_BLOCK = 48
STAGES = 3
MAX_THREADS = 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """Tiles of one exx call: index blocks of ``bsz`` rows (``nb``),
    ``xg`` Cholesky vectors and ``wg`` walkers a block of threads, an
    ``rt`` x ``ct`` tile, depth ``kp`` (M padded to KS); the scratch
    sizes in elements (packed rchol, real; packed Ghalf, complex;
    partials, complex128)."""
    bsz: int
    nb: int
    xg: int
    wg: int
    rt: int
    ct: int
    kp: int
    ng: int
    nh: int
    threads: int
    smem: int
    apack: int
    bpack: int
    part: int


def smem_bytes(rt: int, ct: int, xg: int, wg: int, nb: int,
               dtype: torch.dtype) -> int:
    """Shared memory of the GEMM block (ExxLayout in csrc/exx.cu)."""
    c = dtype.itemsize
    ks = TILES[dtype][2]
    stage = rt * (ct + 1) * c
    ring = STAGES * ks * (rt * c // 2 + ct * c)
    second = round_up(stage, 16) if nb > 1 else 0
    return round_up(second + max(ring, stage), 16) + xg * wg * 16


def _score(xg: int, wg: int, bsz: int, tm: int, tn: int) -> float:
    """What share of a block's issue slots does useful multiply-adds: the
    tile's used rows and columns, times how evenly its warps spread over
    the SM's four schedulers (a block of 10 warps runs at the pace of the
    schedulers that hold 3)."""
    rt, ct = round_up(xg * bsz, tm), round_up(wg * bsz, tn)
    warps = -(-(rt // tm) * (ct // tn) // 32)
    return (xg * bsz * wg * bsz) / (rt * ct) * (warps / 4) / -(-warps // 4)


@functools.lru_cache(maxsize=None)
def plan(nx: int, n: int, m: int, w: int, dtype: torch.dtype) -> Plan:
    """The tile of an exx call: index blocks of at most MAX_BLOCK rows; then,
    among the tiles of up to the aimed-at rows and columns (at least one
    vector and one walker, at most all) that fit the thread and
    shared-memory budgets, the one with the best ``_score``; on a tie one of
    at most 8 warps (two blocks share an SM), then the larger. Derived once
    per shape and type."""
    tm, tn, ks, want_r, want_c = TILES[dtype]
    nb = -(-n // MAX_BLOCK)
    bsz = -(-n // nb)
    best = None
    for xg in range(1, max(1, min(nx, want_r // bsz)) + 1):
        for wg in range(1, max(1, min(w, want_c // bsz)) + 1):
            rt, ct = round_up(xg * bsz, tm), round_up(wg * bsz, tn)
            threads = round_up(rt // tm * (ct // tn), 32)
            smem = smem_bytes(rt, ct, xg, wg, nb, dtype)
            if threads > MAX_THREADS or smem > cuda_build.SMEM_MAX:
                continue
            key = (_score(xg, wg, bsz, tm, tn), threads <= 256, xg * wg,
                   xg)
            if best is None or key > best[0]:
                best = (key, xg, wg, rt, ct, threads, smem)
    if best is None:
        raise ValueError(f"exx: no tile fits n = {n}")
    _, xg, wg, rt, ct, threads, smem = best
    kp = round_up(m, ks)
    ng, nh = -(-nx // xg), -(-w // wg)
    return Plan(bsz=bsz, nb=nb, xg=xg, wg=wg, rt=rt, ct=ct, kp=kp, ng=ng,
                nh=nh, threads=threads, smem=smem, apack=ng * nb * kp * rt,
                bpack=nh * nb * kp * ct, part=ng * nb * (nb + 1) // 2 * w)


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
    if w == 0 or n == 0 or m == 0 or nx == 0:
        return out
    pl = plan(nx, n, m, w, ghalf.dtype)
    dev = ghalf.device
    apack = torch.empty(pl.apack, dtype=rchol.dtype, device=dev)
    bpack = torch.empty(pl.bpack, dtype=ghalf.dtype, device=dev)
    part = torch.empty(pl.part, dtype=torch.complex128, device=dev)
    fn = getattr(cuda_build.library(), _SYMBOLS[ghalf.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(rchol.data_ptr(), ghalf.data_ptr(), apack.data_ptr(),
                bpack.data_ptr(), part.data_ptr(), out.data_ptr(), nx, n, m,
                w, pl.bsz, pl.nb, pl.xg, pl.wg, pl.rt, pl.ct, pl.kp, stream)
    cuda_build.check(rc, "exx")
    launches += 1
    return out
