"""Kernel A: walker Green's functions + log-overlaps, lanes layout.

Counterpart of ``pauxy_tpu/ops/greens_pallas.py``. ``greens_lanes`` launches
the CUDA kernel of ``csrc/greens.cu`` on a CUDA tensor with n up to
``max_n(dtype, want_gh)`` and calls the plain PyTorch version
``greens_lanes_plain`` on a CPU tensor. A walker is a group of lanes (lane
g owns rows g, g + lanes, ... of [S | I]; ``plan``), so a block holds
several walkers and the main path's 1024 walkers spread over the card. A
CUDA tensor with a larger n, whose walker does not fit one block's shared
memory, runs the plain version
on the card: the route is chosen by shape before any launch, as JAX's
``greens_pallas.vmem_ok`` sends such lattices to its XLA lanes path. Any
other device, or a CUDA tensor the kernel does not take, raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far; a run can show that the main path used the kernel.
launches = 0


# csrc/greens.cu: threads a block (kGreensThreads) and the largest staged
# block (kStageMax, bytes).
THREADS = 64
STAGE_MAX = 48 * 1024


def max_n(dtype: torch.dtype, want_gh: bool = True) -> int:
    """Largest n the kernel launches: one walker's n x (2n with the Green's
    function, else n) complex entries must fit one block's shared memory
    (csrc/greens.cu). 85 / 120 in complex128, 120 / 170 in complex64. A
    closed form, nothing to cache."""
    per = (2 if want_gh else 1) * dtype.itemsize
    return math.isqrt(cuda_build.SMEM_MAX // per)


class Plan(NamedTuple):
    """Kernel A's launch, which csrc/greens.cu checks and takes: ``lanes``
    threads a walker (lane g owns rows g, g + lanes, ...), ``walkers``
    walkers a block, the row stride ``ld`` of [S | I], and whether the
    block stages phi and psi in shared memory."""
    lanes: int
    walkers: int
    ld: int
    staged: bool


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, dtype: torch.dtype, want_gh: bool = True) -> Plan:
    """The launch of the kernel for psi [M, n] and phi [M, n, W] of
    ``dtype`` (n <= ``max_n``): the next power of two >= n lanes, at most
    32; the row stride ncol | 1 where it fits; THREADS / lanes walkers
    (fewer when their matrices do not fit); staged when the block's phi
    slabs, psi and matrices fit STAGE_MAX bytes. Raises ValueError past
    ``max_n``, where no launch exists."""
    if n > max_n(dtype, want_gh):
        raise ValueError(f"greens_lanes: n = {n} > {max_n(dtype, want_gh)}, "
                         f"the largest the kernel takes in {dtype}")
    c = dtype.itemsize
    ncol = 2 * n if want_gh else n
    lanes = 1
    while lanes < n and lanes < 32:
        lanes *= 2

    def elems(ld):          # one walker's matrix, rounded to 16 bytes
        e = n * ld
        return e + (e % 2) if c == 8 else e

    ld = ncol | 1
    if elems(ld) * c > cuda_build.SMEM_MAX:
        ld = ncol
    per = elems(ld) * c
    walkers = THREADS // lanes
    if walkers * per > cuda_build.SMEM_MAX:
        walkers = cuda_build.SMEM_MAX // per
    slab = m * n * c
    return Plan(lanes, walkers, ld, walkers * (per + slab) + slab <= STAGE_MAX)


def uses_kernel(phi: torch.Tensor, want_gh: bool = True) -> bool:
    """Whether ``greens_lanes`` launches the kernel for ``phi`` [M, n, W]:
    a CUDA tensor with n <= ``max_n`` (a type or shape the kernel does not
    take is refused by the wrapper, not routed)."""
    if phi.device.type != "cuda":
        return False
    if (phi.dtype not in (torch.complex64, torch.complex128)
            or len(phi.shape) != 3):
        return True
    return phi.shape[1] <= max_n(phi.dtype, want_gh)


def greens_lanes_plain(psi: torch.Tensor, phi: torch.Tensor,
                       want_gh: bool = True):
    """Plain version: overlap_lanes + lanelinalg.gauss + a transpose (the
    'xla' branch of ``pauxy_tpu/qmc/hubbard_fast._greens_lanes``). Both
    modes eliminate S = phi^T conj(psi), as the kernel does: an exactly
    singular S and its transpose give other phases to log 0. The log-det
    only mode therefore differs from the 'xla' branch of
    ``_log_overlap_lanes``, which eliminates S^T, in rounding and in
    multiples of 2 pi in the imaginary part."""
    s = ll.overlap_lanes(psi, phi).transpose(0, 1)       # [n, n, W]
    if not want_gh:
        return ll.slogdet(s), None
    logdet, gh = ll.gauss(s, phi.transpose(0, 1))         # gh [n, M, W]
    return logdet, gh.transpose(0, 1)


def greens_lanes(psi: torch.Tensor, phi: torch.Tensor, want_gh: bool = True):
    """Green's function of one spin sector, walker axis last.

    psi [M, n] complex trial; phi [M, n, W] complex walkers. Returns
    (logdet [W] complex, ghT [M, n, W] or None) with S = phi^T conj(psi),
    logdet = log det S and ghT[q, i, w] = (S^-1 phi^T)[i, q] for walker w.
    The imaginary part of logdet is defined modulo 2 pi.
    """
    global launches
    if phi.device.type == "cpu":
        return greens_lanes_plain(psi, phi, want_gh)
    if phi.device.type == "cuda" and not uses_kernel(phi, want_gh):
        return greens_lanes_plain(psi, phi, want_gh)
    if phi.device.type != "cuda" or psi.device != phi.device:
        raise ValueError(f"greens_lanes: psi on {psi.device}, phi on "
                         f"{phi.device}; both must be on one CUDA device")
    if phi.dtype not in (torch.complex64, torch.complex128) \
            or psi.dtype != phi.dtype:
        raise TypeError(f"greens_lanes: needs complex64/complex128, got "
                        f"psi {psi.dtype}, phi {phi.dtype}")
    if phi.dim() != 3 or psi.dim() != 2 or tuple(psi.shape) != phi.shape[:2]:
        raise ValueError(f"greens_lanes: shapes psi {tuple(psi.shape)}, "
                         f"phi {tuple(phi.shape)}; want [M, n], [M, n, W]")
    if not (psi.is_contiguous() and phi.is_contiguous()):
        raise ValueError("greens_lanes: psi and phi must be contiguous")
    m, n, w = phi.shape
    ght = torch.empty_like(phi) if want_gh else None
    if n == 0 or w == 0:
        return torch.zeros(w, dtype=phi.dtype, device=phi.device), ght
    # The kernel writes every walker's log-determinant.
    logdet = torch.empty(w, dtype=phi.dtype, device=phi.device)
    lib = cuda_build.library()
    fn = (lib.pauxy_greens_lanes_c64 if phi.dtype == torch.complex64
          else lib.pauxy_greens_lanes_c128)
    pl = plan(m, n, phi.dtype, want_gh)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(psi.data_ptr(), phi.data_ptr(), logdet.data_ptr(),
                ght.data_ptr() if want_gh else None, m, n, w, int(want_gh),
                pl.lanes, pl.walkers, pl.ld, int(pl.staged), stream)
    cuda_build.check(rc, "greens_lanes")
    launches += 1
    return logdet, ght
