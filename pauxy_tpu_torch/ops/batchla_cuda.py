"""Kernel B: batched complex inverse + log-determinant.

Counterpart of ``inv_logdet_lanes`` / ``slogdet_lanes`` in
``pauxy_tpu/ops/batchla_pallas.py``. Matrices arrive as [w, n, n]; the
wrapper moves the batch axis last ([n, n, W], one thread per matrix reads
coalesced), launches the CUDA kernel of ``csrc/batchla.cu`` on a CUDA
tensor and calls the plain PyTorch version on a CPU tensor; any other
device, or a CUDA tensor the kernel does not take, raises.
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far; a run can show that the main path used the kernel.
launches = 0


def inv_logdet_lanes_plain(s: torch.Tensor, want_inv: bool = True):
    """Plain version: lanelinalg.gauss on the lanes layout."""
    w, n, _ = s.shape
    lanes = ll.to_lanes(s)                                # [n, n, W]
    if not want_inv:
        return ll.slogdet(lanes), None
    eye = torch.eye(n, dtype=s.dtype, device=s.device)[:, :, None]
    logdet, inv = ll.gauss(lanes, eye.expand(n, n, w))
    return logdet, ll.from_lanes(inv)


def inv_logdet_lanes(s: torch.Tensor, want_inv: bool = True):
    """(logdet [w] complex, inverse [w, n, n] or None) of s [w, n, n].
    The imaginary part of logdet is defined modulo 2 pi."""
    global launches
    if s.device.type == "cpu":
        return inv_logdet_lanes_plain(s, want_inv)
    if s.device.type != "cuda":
        raise ValueError(f"inv_logdet_lanes: tensor on {s.device}")
    if s.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"inv_logdet_lanes: needs complex64/complex128, "
                        f"got {s.dtype}")
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"inv_logdet_lanes: shape {tuple(s.shape)}, "
                         "want [w, n, n]")
    w, n, _ = s.shape
    logdet = torch.zeros(w, dtype=s.dtype, device=s.device)
    if n == 0 or w == 0:
        return logdet, (torch.empty_like(s) if want_inv else None)
    lanes = ll.to_lanes(s)                                # contiguous copy
    inv = torch.empty_like(lanes) if want_inv else None
    lib = cuda_build.library()
    fn = (lib.pauxy_inv_logdet_lanes_c64 if s.dtype == torch.complex64
          else lib.pauxy_inv_logdet_lanes_c128)
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
