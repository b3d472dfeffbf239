"""The Hirsch site-sweep kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/sweep_pallas.py:hirsch_sweep_real``, with the
same inputs and outputs (walker-major, real). ``hirsch_sweep_real`` launches
the CUDA kernel of ``csrc/sweep.cu`` on CUDA tensors as they come (a group
of lanes per walker, ``plan``; any strides, so the real part of a complex
tensor is read in place) and calls ``hirsch_sweep_real_plain`` on CPU
tensors; any other device, or a CUDA tensor the kernel does not take,
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.ops import lanelinalg as ll

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

# Largest electron count per spin the kernel is chosen for, as in
# pauxy_tpu/propagation/hirsch.py:656.
MAX_N = 32

_SYMBOLS = {torch.float32: "pauxy_hirsch_sweep_f32",
            torch.float64: "pauxy_hirsch_sweep_f64"}

# csrc/sweep.cu: threads a block.
THREADS = 64


class Plan(NamedTuple):
    """The sweep kernel's launch, which csrc/sweep.cu checks and takes:
    ``lanes`` threads a walker (lane r owns row r of both inverses),
    ``walkers`` walkers a block, the inverses' row strides ``lda``,
    ``ldb``."""
    lanes: int
    walkers: int
    lda: int
    ldb: int


@functools.lru_cache(maxsize=None)
def plan(na: int, nb: int) -> Plan:
    """The launch for na and nb electrons per spin (1..MAX_N): the next
    power of two >= max(na, nb) lanes, THREADS / lanes walkers a block, the
    odd strides na | 1 and nb | 1 (a block's inverses stay well under 48 KB
    at MAX_N in float64). Raises ValueError outside 1..MAX_N."""
    if not (1 <= na <= MAX_N and 1 <= nb <= MAX_N):
        raise ValueError(f"hirsch_sweep_real: (na, nb) = {(na, nb)} outside "
                         f"1..{MAX_N}, what the kernel takes")
    lanes = 1 << (max(na, nb) - 1).bit_length()
    return Plan(lanes, THREADS // lanes, na | 1, nb | 1)


def _gdiag(inv, row, psi_row):
    """G_ii [W] = sum_a psi[a] sum_b inv[b, a] row[b]; inv [n, n, W],
    row [n, W], psi_row [n]."""
    q = torch.sum(inv * row[:, None, :], dim=0)           # [n, W]
    return torch.sum(psi_row[:, None] * q, dim=0)


def _sherman_morrison(inv, psi_row, vt):
    """(S + psi vt^T)^-1 from inv = S^-1 [n, n, W], vt [n, W]."""
    t1 = torch.sum(psi_row[None, :, None] * inv, dim=1)  # [n, W]
    t2 = torch.sum(vt[:, None, :] * inv, dim=0)           # [n, W]
    denom = 1.0 + torch.sum(vt * t1, dim=0)
    return inv - t1[:, None, :] * t2[None, :, :] / denom


def hirsch_sweep_real_plain(psia, psib, delta, wfac, phia, phib, inva, invb,
                            rs, weight):
    """Plain version: the sweep as a loop over sites of lane-parallel real
    tensor operations (arguments and results as ``hirsch_sweep_real``)."""
    m = phia.shape[1]
    pa = ll.to_lanes(phia)                                # [M, na, W] copy
    pb = ll.to_lanes(phib)
    ia = ll.to_lanes(inva)                                # [na, na, W]
    ib = ll.to_lanes(invb)
    (d00, d01), (d10, d11) = delta
    wf0, wf1 = wfac
    w = weight.clone()
    dlog = torch.zeros_like(w)
    fields = []
    for i in range(m):
        rowa = pa[i].clone()                              # [na, W]
        rowb = pb[i].clone()
        ga = _gdiag(ia, rowa, psia[i])
        gb = _gdiag(ib, rowb, psib[i])
        p0 = 0.5 * (1.0 + d00 * ga) * (1.0 + d01 * gb) * wf0
        p1 = 0.5 * (1.0 + d10 * ga) * (1.0 + d11 * gb) * wf1
        pr0 = torch.clamp_min(p0, 0.0)
        norm = pr0 + torch.clamp_min(p1, 0.0)
        alive = (norm > 0) & (w.abs() > 0)
        safe = torch.where(alive, norm, torch.ones_like(norm))
        xi = rs[i] >= pr0 / safe
        w = torch.where(alive, w * norm, torch.zeros_like(w))
        chosen = torch.where(xi, p1, p0)
        dlog = dlog + torch.where(alive, torch.log(2.0 * chosen),
                                  torch.zeros_like(dlog))
        zero = torch.zeros_like(ga)
        da = torch.where(alive, torch.where(xi, d10, d00), zero)
        db = torch.where(alive, torch.where(xi, d11, d01), zero)
        vta = rowa * da
        vtb = rowb * db
        pa[i] = rowa + vta
        pb[i] = rowb + vtb
        ia = _sherman_morrison(ia, psia[i], vta)
        ib = _sherman_morrison(ib, psib[i], vtb)
        fields.append(xi.to(torch.int32))
    return (ll.from_lanes(pa), ll.from_lanes(pb), w, dlog,
            ll.from_lanes(torch.stack(fields)))


def hirsch_sweep_real(psia, psib, delta, wfac, phia, phib, inva, invb, rs,
                      weight):
    """Run the Hirsch sweep for a real spin-decomposed propagator.

    psia/psib [M, na/nb] trial rows; delta [2, 2] (auxf - 1); wfac [2];
    phia/phib [w, M, n] walkers; inva/invb [w, n, n] inverse overlaps
    S^-1, S = psi^T phi; rs [M, w] uniform draws; weight [w]; all real, one
    dtype. Returns (phia', phib', weight', dlog [w], fields [w, M] int32).
    """
    global launches
    if phia.device.type == "cpu":
        return hirsch_sweep_real_plain(psia, psib, delta, wfac, phia, phib,
                                       inva, invb, rs, weight)
    args = (psia, psib, delta, wfac, phia, phib, inva, invb, rs, weight)
    if any(a.device != phia.device for a in args) \
            or phia.device.type != "cuda":
        raise ValueError("hirsch_sweep_real: every tensor must be on one "
                         f"CUDA device, got {[str(a.device) for a in args]}")
    if phia.dtype not in _SYMBOLS or any(a.dtype != phia.dtype
                                         for a in args):
        raise TypeError("hirsch_sweep_real: needs float32 or float64 "
                        f"throughout, got {[a.dtype for a in args]}")
    w, m, na = phia.shape
    nb = phib.shape[-1]
    want = {"psia": (m, na), "psib": (m, nb), "delta": (2, 2), "wfac": (2,),
            "phib": (w, m, nb), "inva": (w, na, na), "invb": (w, nb, nb),
            "rs": (m, w), "weight": (w,)}
    got = dict(zip(want, (psia, psib, delta, wfac, phib, inva, invb, rs,
                          weight)))
    bad = {k: tuple(v.shape) for k, v in got.items()
           if tuple(v.shape) != want[k]}
    if bad or min(na, nb, m, w) == 0:
        raise ValueError(f"hirsch_sweep_real: shapes {bad} (want "
                         f"{ {k: want[k] for k in bad} }), (w, M, na, nb) = "
                         f"{(w, m, na, nb)} must all be positive")
    pl = plan(na, nb)
    # Element strides of the ten inputs, in order (csrc/sweep.cu kStrides).
    strides = (ctypes.c_longlong * 22)(*(st for a in args
                                          for st in a.stride()))
    phia_out = torch.empty((w, m, na), dtype=phia.dtype, device=phia.device)
    phib_out = torch.empty((w, m, nb), dtype=phia.dtype, device=phia.device)
    wt = torch.empty_like(weight, memory_format=torch.contiguous_format)
    dlog = torch.empty_like(wt)
    fields = torch.empty((w, m), dtype=torch.int32, device=phia.device)
    fn = getattr(cuda_build.library(), _SYMBOLS[phia.dtype])
    with torch.cuda.device(phia.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(a.data_ptr() for a in args + (phia_out, phib_out, wt, dlog,
                                                fields)),
                ctypes.addressof(strides), m, na, nb, w, pl.lanes,
                pl.walkers, pl.lda, pl.ldb, stream)
    cuda_build.check(rc, "hirsch_sweep_real")
    launches += 1
    return phia_out, phib_out, wt, dlog, fields
