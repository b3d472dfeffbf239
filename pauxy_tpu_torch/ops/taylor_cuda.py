"""The fused Taylor exp(VHS)-apply kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/taylor_pallas.py:apply_taylor_pallas``:
phi <- sum_{k <= order} VHS^k phi / k! per walker, the term kept on chip and
VHS streamed once per order. ``apply_taylor`` launches the CUDA kernel of
``csrc/taylor.cu`` on a CUDA tensor with M up to ``max_m(dtype)`` and calls
``apply_taylor_plain`` on a CPU tensor; any other device, a larger M, or a
CUDA tensor the kernel does not take, raises. The Generic propagator
chooses by shape (``fits``) before any launch and sends a larger M to the
plain series. The bf16 multiplicand option of the TPU kernel is not ported.
"""

from __future__ import annotations

import functools

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops.cuda_build import round_up

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

_SYMBOLS = {torch.complex64: "pauxy_taylor_c64",
            torch.complex128: "pauxy_taylor_c128"}

# csrc/taylor.cu's tiles: rows (TM) and columns (TN) a thread owns, VHS
# columns a slab holds (KS) and a slab row's stride (KSP); ring stages;
# threads a block at most, by type.
TILES = {torch.complex64: (4, 4, 16, 18), torch.complex128: (4, 4, 8, 9)}
STAGES = 2
MAX_THREADS = {torch.complex64: 640, torch.complex128: 320}


def smem_bytes(m: int, cb: int, dtype: torch.dtype) -> int:
    """Shared memory of a block of ``cb`` columns (TaylorLayout in
    csrc/taylor.cu): the term [TR, cb], the running sum [MP, cb] and the
    VHS ring [STAGES, MP, KSP], MP = M padded to TM, TR = max(MP, M padded
    to KS)."""
    tm, _, ks, ksp = TILES[dtype]
    mp = round_up(m, tm)
    tr = max(mp, round_up(m, ks))
    return (tr * cb + mp * cb + STAGES * mp * ksp) * dtype.itemsize


def threads(m: int, cb: int, dtype: torch.dtype) -> int:
    """Threads of a block of ``cb`` columns: one per TM x TN tile, rounded
    up to whole warps."""
    tm, tn, _, _ = TILES[dtype]
    return round_up(round_up(m, tm) // tm * (cb // tn), 32)


@functools.lru_cache(maxsize=None)
def plan(m: int, ncol: int, dtype: torch.dtype) -> int:
    """Columns of a part, a multiple of TN: all C columns (padded to TN) in
    one block when the threads and shared memory allow, else the fewest
    equal parts that fit. Raises ValueError when not even one column group
    fits (M > ``max_m``). Derived once per shape and type."""
    _, tn, _, _ = TILES[dtype]
    parts = 1
    while True:
        cb = round_up(-(-ncol // parts), tn)
        if (threads(m, cb, dtype) <= MAX_THREADS[dtype]
                and smem_bytes(m, cb, dtype) <= cuda_build.SMEM_MAX):
            return cb
        if cb == tn:
            raise ValueError(f"apply_taylor: M = {m} > {max_m(dtype)}, the "
                             f"largest the kernel takes in {dtype}")
        parts += 1


@functools.lru_cache(maxsize=None)
def max_m(dtype: torch.dtype) -> int:
    """Largest M the kernel launches for ``dtype``: one column group and the
    VHS ring fit a block (656 in complex64, 556 in complex128). Derived
    once per type."""
    _, tn, _, _ = TILES[dtype]
    m = 1
    while (smem_bytes(m + 1, tn, dtype) <= cuda_build.SMEM_MAX
           and threads(m + 1, tn, dtype) <= MAX_THREADS[dtype]):
        m += 1
    return m


def fits(m: int, dtype: torch.dtype) -> bool:
    """Whether the Generic propagator sends an [.., M, M] VHS of ``dtype``
    to ``apply_taylor`` (a type the kernel does not take goes there too,
    and is refused)."""
    return dtype not in TILES or m <= max_m(dtype)


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
    if order < 0:
        raise ValueError(f"apply_taylor: order {order} < 0")
    w, m, ncol = phi.shape
    # 16-byte copies of VHS rows: complex128 always, complex64 when its
    # rows start on 16 bytes.
    aligned = vhs.data_ptr() % 16 == 0
    if phi.dtype == torch.complex128 and not aligned:
        raise ValueError("apply_taylor: complex128 VHS not 16-byte aligned")
    vec = int(phi.dtype == torch.complex128 or (aligned and m % 2 == 0))
    out = torch.empty_like(phi)
    if w == 0 or m == 0 or ncol == 0:
        return out
    cb = plan(m, ncol, phi.dtype)
    fn = getattr(cuda_build.library(), _SYMBOLS[phi.dtype])
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vhs.data_ptr(), phi.data_ptr(), out.data_ptr(), w, m, ncol,
                order, cb, vec, stream)
    cuda_build.check(rc, "apply_taylor")
    launches += 1
    return out
