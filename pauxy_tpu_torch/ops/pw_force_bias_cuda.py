"""The plane-wave force bias as one kernel, and its plain version.

Replaces no TPU kernel (``csrc/pw_force_bias.cu`` says why it was added
and what bounds it). For walkers' half-rotated Green's functions ``gha``
[w, na, M] and ``ghb`` [w, nb, M] it gives the propagator's force bias
before the unit-modulus clamp, -sqrt(dt) [i (t1 + t2), -(t1 - t2)] [w, 2 nq],
t1 = qfac (Gkpq_a + Gkpq_b), t2 = qfac (Gpmq_a + Gpmq_b), the Coulomb
correlations of ``estimators/local_energy.fft_coulomb_terms`` summed over
both spins before one final transform.

``force_bias`` launches the kernel on a CUDA tensor and runs
``force_bias_plain`` on a CPU tensor; a CUDA call the kernel does not
take raises. The propagator decides by shape (``fits``) before any launch
and sends a cube that does not fit to ``force_bias_plain`` (torch.fft).
``Tables`` holds what the kernel reads besides the walkers (built once a
propagator, ``make_tables``), ``trial_cubes`` the trial's transformed
orbital cubes (built once a trial).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build
from pauxy_tpu_torch.propagation.pw_fft import fft3, ifft3, neg_perm, to_cube
from pauxy_tpu_torch.utils import tracing

# Kernel launches so far; a run can show that its path used the kernel.
launches = 0

_SYMBOLS = {torch.complex64: "pauxy_pw_force_bias_c64",
            torch.complex128: "pauxy_pw_force_bias_c128"}
# The cube edges csrc/pw_force_bias.cu is instantiated for (the UEG's
# 4 nmax + 1 cubes whose working set fits a block).
MESHES = {torch.complex64: (5, 9, 13, 17, 21, 25),
          torch.complex128: (5, 9, 13, 17, 21)}


def support(ngrid: int) -> int:
    """Width S of the kernel's support box on an N-cube: frequencies
    |n| <= (N - 1) // 4 on each axis."""
    return 2 * ((ngrid - 1) // 4) + 1


def smem_bytes(ngrid: int, dtype: torch.dtype) -> int:
    """Shared memory of a block: the accumulated cube [N^3], one orbital's
    partial transform [S, N, N] and the support map [S^3] of int32."""
    s = support(ngrid)
    return (ngrid ** 3 + s * ngrid ** 2) * dtype.itemsize + 4 * s ** 3


class Tables(NamedTuple):
    """What the kernel and its plain version read besides the walkers:
    ``gmap`` [M] the basis's flat cube indices; ``box`` [S^3] int32, the
    basis index at each point of the support box (signed coordinates
    + (S - 1) / 2, x slowest), -1 off the basis, or None where the basis
    leaves the box; ``qidx`` [2, nq] int32, the flat cube index of each q
    and of -q; ``fac`` [nq] real, qfac sqrt(dt) / N^3; ``qmesh``."""
    gmap: torch.Tensor
    box: torch.Tensor | None
    qidx: torch.Tensor
    fac: torch.Tensor
    qmesh: tuple


def make_tables(gmap: torch.Tensor, qmap: torch.Tensor, qmesh,
                qfac: torch.Tensor, sqrt_dt: float) -> Tables:
    """The kernel's tables for the basis ``gmap`` [M] and the q vectors
    ``qmap`` [nq] on ``qmesh``, ``qfac`` [nq] sqrt(pi / (vol q^2)), on
    ``gmap``'s device."""
    qmesh = tuple(int(d) for d in qmesh)
    ng = int(np.prod(qmesh))
    dev = gmap.device
    qidx = torch.stack([qmap, neg_perm(qmesh, dev)[qmap]]).to(torch.int32)
    fac = qfac * (sqrt_dt / ng)
    box = None
    n = qmesh[0]
    if qmesh == (n, n, n):
        p = (n - 1) // 4
        s = 2 * p + 1
        flat = gmap.cpu().numpy()
        coords = np.stack([flat // (n * n), (flat // n) % n, flat % n], 1)
        signed = np.where(coords > n // 2, coords - n, coords)
        if len(flat) and np.abs(signed).max() <= p:
            cells = ((signed[:, 0] + p) * s + signed[:, 1] + p) * s \
                + signed[:, 2] + p
            table = -np.ones(s ** 3, dtype=np.int32)
            table[cells] = np.arange(len(flat), dtype=np.int32)
            box = torch.from_numpy(table).to(dev)
    return Tables(gmap, box, qidx.contiguous(), fac.contiguous(), qmesh)


def fits(tab: Tables, dtype: torch.dtype) -> bool:
    """Whether the kernel takes the force bias of ``tab``'s system in
    ``dtype``: a cube of an instantiated edge whose working set fits a
    block, with the basis inside the support box."""
    return (tab.box is not None and tab.qmesh[0] in MESHES.get(dtype, ())
            and smem_bytes(tab.qmesh[0], dtype) <= cuda_build.SMEM_MAX)


def trial_cubes(psia: torch.Tensor, psib: torch.Tensor, gmap: torch.Tensor,
                qmesh) -> torch.Tensor:
    """fft3 of the cubes of conj(psi)^T, both spins' orbitals stacked:
    [na + nb, N^3]."""
    ct = to_cube(torch.cat([psia, psib], dim=-1).conj().transpose(0, 1),
                 gmap, int(np.prod(qmesh)))
    return fft3(ct, qmesh) if ct.shape[0] else ct


def force_bias_plain(ct_f: torch.Tensor, gha: torch.Tensor,
                     ghb: torch.Tensor, tab: Tables) -> torch.Tensor:
    """Plain version: the kernel's function with torch.fft. Each spin's
    rows transformed (unnormalised, e^{+}), multiplied by the trial's
    cubes and summed over orbitals into one cube, one final transform,
    read at q and -q. One spin's orbital cubes are live at a time, as in
    ``fft_coulomb_terms``."""
    ng = int(np.prod(tab.qmesh))
    na = gha.shape[1]
    acc = None
    for gh, ct in ((gha, ct_f[:na]), (ghb, ct_f[na:])):
        if gh.shape[1] == 0:
            # An empty spin: nothing to correlate (and no transform of an
            # empty batch).
            continue
        u = ifft3(to_cube(gh, tab.gmap, ng), tab.qmesh).mul_(ng)
        part = torch.einsum("ig,wig->wg", ct, u)
        del u
        acc = part if acc is None else acc + part
    if acc is None:
        return gha.new_zeros((gha.shape[0], 2 * tab.fac.shape[0]))
    cu = ifft3(acc, tab.qmesh) * ng
    a = cu[:, tab.qidx[0].long()]
    b = cu[:, tab.qidx[1].long()]
    fac = tab.fac.to(cu.dtype)
    return torch.cat([-1j * fac * (a + b), fac * (a - b)], dim=-1)


def force_bias(ct_f: torch.Tensor, gha: torch.Tensor, ghb: torch.Tensor,
               tab: Tables) -> torch.Tensor:
    """The force bias before its clamp, [w, 2 nq]: ``gha`` [w, na, M],
    ``ghb`` [w, nb, M] (rows contiguous), ``ct_f`` [na + nb, N^3]
    (``trial_cubes``), complex64 or complex128 on one device."""
    global launches
    if gha.device.type == "cpu":
        return force_bias_plain(ct_f, gha, ghb, tab)
    dev = gha.device
    if dev.type != "cuda" or any(x.device != dev for x in
                                 (ghb, ct_f, tab.qidx, tab.fac)):
        raise ValueError(f"pw force_bias: tensors on {gha.device}, "
                         f"{ghb.device}, {ct_f.device}; want one CUDA "
                         f"device")
    dtype = gha.dtype
    if dtype not in _SYMBOLS or ghb.dtype != dtype or ct_f.dtype != dtype:
        raise TypeError(f"pw force_bias: needs complex64 or complex128, got "
                        f"{gha.dtype}, {ghb.dtype}, {ct_f.dtype}")
    if not fits(tab, dtype):
        raise ValueError(f"pw force_bias: cube {tab.qmesh} in {dtype} is "
                         f"not one the kernel takes")
    ng = int(np.prod(tab.qmesh))
    if gha.dim() != 3 or ghb.dim() != 3:
        raise ValueError(f"pw force_bias: shapes {tuple(gha.shape)}, "
                         f"{tuple(ghb.shape)}, want [w, n, M]")
    w, na, m = gha.shape
    nb = ghb.shape[1]
    if (ghb.shape[0] != w or ghb.shape[2] != m
            or ct_f.shape != (na + nb, ng) or m != tab.gmap.shape[0]):
        raise ValueError(f"pw force_bias: shapes {tuple(gha.shape)}, "
                         f"{tuple(ghb.shape)}, {tuple(ct_f.shape)}")
    if (gha.stride(-1) != 1 or ghb.stride(-1) != 1
            or not ct_f.is_contiguous()):
        raise ValueError("pw force_bias: needs rows with unit stride and a "
                         "contiguous ct_f")
    if tab.fac.dtype != config.real_dtype(dtype):
        raise TypeError(f"pw force_bias: fac {tab.fac.dtype} for {dtype}")
    nq = tab.fac.shape[0]
    out = torch.empty((w, 2 * nq), dtype=dtype, device=dev)
    if w == 0:
        return out
    fn = getattr(cuda_build.library(), _SYMBOLS[dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(gha.data_ptr(), ghb.data_ptr(), ct_f.data_ptr(),
                tab.box.data_ptr(), tab.qidx.data_ptr(), tab.fac.data_ptr(),
                out.data_ptr(), w, na, nb, gha.stride(0), gha.stride(1),
                ghb.stride(0), ghb.stride(1), nq, tab.qmesh[0], stream)
    cuda_build.check(rc, "pw force_bias")
    launches += 1
    tracing.count("pw_force_bias.launches")
    return out

