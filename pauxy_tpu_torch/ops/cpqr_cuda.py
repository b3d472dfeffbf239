"""The column-pivoted QR kernel and its plain version.

Counterpart of ``pauxy_tpu/ops/cpqr_pallas.py:cpqr_lanes`` (the kernel)
and of ``pauxy_tpu/ops/cpqr.py:_cpqr_xla`` (the plain version): batched
a[:, :, perm] = q @ r for a [B, m, m]. ``cpqr_lanes`` launches the CUDA
kernel of ``csrc/cpqr.cu`` on a CUDA tensor and calls ``cpqr_lanes_plain``
on a CPU tensor; any other device, or a CUDA tensor the kernel does not
take, raises. Both use the LAPACK phase choice beta = -(alpha/|alpha|)
||x|| for the diagonal of R, so with equal pivots their factors agree
elementwise; the pivots themselves may differ on near-tied column norms
(the kernel recomputes the norms exactly every step, the plain version
downdates them between refreshes). The kernel has two routes, chosen by
its launcher from m alone (``route``): a warp per matrix, WARP_TEAMS
matrices a block, for m <= WARP_MAX_M; a 256-thread block per matrix
above. Both factor and then form Q in the same block, in place.
"""

from __future__ import annotations

import functools

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cuda_build

# Kernel launches so far (one per call); a run can show that its path used
# the kernel.
launches = 0

# Exact partial-norm recompute period of the plain version's downdated
# pivot norms (pauxy_tpu/ops/cpqr.py:CPQR_NORM_REFRESH).
CPQR_NORM_REFRESH = 16

# csrc/cpqr.cu: the form-Q panel width (kNb) and the largest m of the warp
# route (kWarpMaxM; a warp per matrix, WARP_TEAMS matrices a block). A
# larger m takes the block route, a 256-thread block per matrix.
NB = 8
WARP_MAX_M = 32
WARP_TEAMS = 4
SMEM_MAX = cuda_build.SMEM_MAX

_SYMBOLS = {torch.complex64: "pauxy_cpqr_c64",
            torch.complex128: "pauxy_cpqr_c128"}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64,
            torch.complex128: torch.complex128}
DTYPES = tuple(_COMPLEX)


def smem_bytes(m: int, dtype: torch.dtype) -> int:
    """Shared memory of one matrix's team (Layout in csrc/cpqr.cu): the
    matrix, column-major with the odd stride m | 1; form-Q's W [NB, m]; the
    Gram matrix and T [NB, NB]; tau [m]; perm [m] (int32); each piece
    rounded up to 16 bytes."""
    c = _COMPLEX[dtype].itemsize
    r16 = lambda x: cuda_build.round_up(x, 16)   # noqa: E731
    return (r16(m * (m | 1) * c) + r16(NB * m * c) + 2 * NB * NB * c
            + r16(m * (c // 2)) + r16(4 * m))


def route(m: int) -> tuple[str, int]:
    """The launcher's route for m and the matrices a block of it holds:
    ("warp", WARP_TEAMS) up to WARP_MAX_M, else ("block", 1)."""
    return ("warp", WARP_TEAMS) if m <= WARP_MAX_M else ("block", 1)


@functools.lru_cache(maxsize=None)
def max_m(dtype: torch.dtype) -> int:
    """Largest m the kernel launches for ``dtype`` (165 for complex64 and
    float32, 115 for complex128 and float64): one matrix's team fits a
    block's shared memory. Derived once per type. ops/cpqr.cpqr sends a
    larger m to the plain version by shape."""
    m = WARP_MAX_M
    while smem_bytes(m + 1, dtype) <= SMEM_MAX:
        m += 1
    return m


@config.full_precision()
def cpqr_lanes_plain(a: torch.Tensor, pivot: bool = True):
    """Plain version, the mirror of ``_cpqr_xla``: Householder with
    deferred pivots (the pivot column is selected by masking processed
    columns; the reflection is applied to all columns), norms downdated
    with an exact refresh every CPQR_NORM_REFRESH columns, unit reflectors
    with tau = 2, and Q = I - V T V^H by compact WY with T^-1 =
    diag(1/tau) + striu(V^H V), T^-1 inverted by a triangular solve
    (``torch.linalg.solve_triangular``; JAX's takes ``clinalg.inv``).
    a [B, m, m] real or complex; returns (q, r, perm [B, m] int64) in the
    input's type. Its products run in IEEE float32 under every matmul
    tier (``config.full_precision``): JAX pins HIGHEST on the Q formation
    and the permutation, and its loop's matvecs stay in float32, so the
    tier never reaches its factorization."""
    b, m, m2 = a.shape
    if m != m2:
        raise ValueError(f"cpqr: shape {tuple(a.shape)}, want [B, m, m]")
    dev, dtype = a.device, a.dtype
    rdtype = a.real.dtype if a.is_complex() else dtype
    rows = torch.arange(m, device=dev)
    bidx = torch.arange(b, device=dev)
    r = a.clone()
    vmat = torch.zeros_like(a)
    tau = torch.zeros((b, m), dtype=dtype, device=dev)
    perm = rows.expand(b, m).clone()
    done = torch.zeros((b, m), dtype=torch.bool, device=dev)
    norms = (a.abs() ** 2).sum(-2)
    neg = torch.tensor(-1.0, dtype=rdtype, device=dev)
    for k in range(m):
        if pivot:
            if k % CPQR_NORM_REFRESH == 0:
                exact = (r[:, k:].abs() ** 2).sum(-2)
                norms = torch.where(done, neg, exact)
            p = torch.argmax(norms, dim=-1)
        else:
            p = torch.full((b,), k, dtype=torch.long, device=dev)
        x = r[bidx, :, p].clone()                      # [B, m]
        x[:, :k] = 0
        normx = torch.sqrt((x.abs() ** 2).sum(-1))
        x0 = x[:, k]
        absx0 = x0.abs()
        nz = absx0 > 0
        phase = torch.where(nz, x0 / torch.where(nz, absx0,
                                                 torch.ones_like(absx0)),
                            torch.ones_like(x0))
        v = x.clone()
        v[:, k] = x0 + phase * normx.to(dtype)         # x - alpha e_k
        vsq = (v.abs() ** 2).sum(-1)
        ok = vsq > 1e-300
        rnorm = torch.where(ok, torch.rsqrt(torch.where(ok, vsq,
                                                        torch.ones_like(vsq))),
                            torch.zeros_like(vsq))
        v = v * rnorm[:, None].to(dtype)
        tk = 2.0 * ok.to(dtype)
        w = torch.einsum("bm,bmn->bn", v.conj(), r) * tk[:, None]
        r = r - v[:, :, None] * w[:, None, :]
        vmat[:, :, k] = v
        tau[:, k] = tk
        perm[:, k] = p
        done[bidx, p] = True
        if pivot:
            rowk = r[:, k, :].abs() ** 2
            norms = torch.where(done, neg, torch.clamp_min(norms - rowk, 0.0))
    # Q = H_0 ... H_{m-1} = I - V T V^H; tau = 0 columns carry v = 0, so a
    # unit diagonal entry there leaves Q untouched.
    g = torch.einsum("bmk,bmn->bkn", vmat.conj(), vmat)
    nzt = tau.abs() > 0
    safe = torch.where(nzt, 1.0 / torch.where(nzt, tau, torch.ones_like(tau)),
                       torch.ones_like(tau))
    tinv = torch.triu(g, 1) + torch.diag_embed(safe)
    tvh = torch.linalg.solve_triangular(tinv, vmat.conj().transpose(-1, -2),
                                        upper=True)
    eye = torch.eye(m, dtype=dtype, device=dev)
    q = eye - torch.matmul(vmat, tvh)
    # r_piv[:, j] = r[:, perm[j]], an exact index gather.
    r = torch.gather(r, 2, perm[:, None, :].expand(b, m, m))
    return q, torch.triu(r), perm


def cpqr_lanes(a: torch.Tensor):
    """Batched column-pivoted QR of a [B, m, m]: (q, r, perm [B, m] int64)
    with a[:, :, perm] = q @ r, q unitary, r upper triangular (exact zeros
    below the diagonal). complex64/complex128 take the kernel as they are;
    float32/float64 go in as complex with zero imaginary parts and come
    back real. m up to ``max_m(a.dtype)``."""
    global launches
    if a.device.type == "cpu":
        return cpqr_lanes_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"cpqr_lanes: tensor on {a.device}")
    if a.dtype not in DTYPES:
        raise TypeError(f"cpqr_lanes: needs complex64, complex128, float32 "
                        f"or float64, got {a.dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"cpqr_lanes: shape {tuple(a.shape)}, want "
                         f"[B, m, m]")
    b, m, _ = a.shape
    cap = max_m(a.dtype)
    if m > cap:
        raise ValueError(f"cpqr_lanes: m = {m} > {cap}, what the kernel "
                         f"launches for {a.dtype}")
    cdtype = _COMPLEX[a.dtype]
    x = a.to(cdtype).contiguous()
    q = torch.empty_like(x)
    r = torch.empty_like(x)
    perm = torch.empty((b, m), dtype=torch.long, device=a.device)
    if b == 0 or m == 0:
        return q, r, perm
    fn = getattr(cuda_build.library(), _SYMBOLS[cdtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), r.data_ptr(), perm.data_ptr(), b,
                m, stream)
    cuda_build.check(rc, "cpqr_lanes")
    launches += 1
    if not a.is_complex():
        return q.real.contiguous(), r.real.contiguous(), perm
    return q, r, perm
