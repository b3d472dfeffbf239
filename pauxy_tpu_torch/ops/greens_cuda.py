"""Kernel A: walker Green's functions + log-overlaps, lanes layout.

Counterpart of ``pauxy_tpu/ops/greens_pallas.py``. ``greens_lanes`` launches
the CUDA kernel of ``csrc/greens.cu`` on a CUDA tensor with n up to
``max_n(dtype, want_gh)`` and calls the plain PyTorch version
``greens_lanes_plain`` on a CPU tensor. A CUDA tensor with a larger n,
whose walker does not fit one block's shared memory, runs the plain version
on the card: the route is chosen by shape before any launch, as JAX's
``greens_pallas.vmem_ok`` sends such lattices to its XLA lanes path. Any
other device, or a CUDA tensor the kernel does not take, raises.
"""

from __future__ import annotations

import math

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far; a run can show that the main path used the kernel.
launches = 0


def max_n(dtype: torch.dtype, want_gh: bool = True) -> int:
    """Largest n the kernel launches: one walker's n x (2n with the Green's
    function, else n) complex entries must fit one block's shared memory
    (csrc/greens.cu). 85 / 120 in complex128, 120 / 170 in complex64."""
    per = (2 if want_gh else 1) * dtype.itemsize
    return math.isqrt(cuda_build.SMEM_MAX // per)


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
    'xla' branch of ``pauxy_tpu/qmc/hubbard_fast._greens_lanes``)."""
    if not want_gh:
        return ll.slogdet(ll.overlap_lanes(psi, phi)), None
    s = ll.overlap_lanes(psi, phi).transpose(0, 1)       # [n, n, W]
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
    logdet = torch.zeros(w, dtype=phi.dtype, device=phi.device)
    ght = torch.empty_like(phi) if want_gh else None
    if n == 0 or w == 0:
        return logdet, ght
    lib = cuda_build.library()
    fn = (lib.pauxy_greens_lanes_c64 if phi.dtype == torch.complex64
          else lib.pauxy_greens_lanes_c128)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(psi.data_ptr(), phi.data_ptr(), logdet.data_ptr(),
                ght.data_ptr() if want_gh else None, m, n, w, int(want_gh),
                stream)
    cuda_build.check(rc, "greens_lanes")
    launches += 1
    return logdet, ght
