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
downdates them between refreshes).
"""

from __future__ import annotations

import torch

from pauxy_tpu_torch.ops import cuda_build

# Kernel launches so far (one per call: the factor and form-Q passes); a
# run can show that its path used the kernel.
launches = 0

# Exact partial-norm recompute period of the plain version's downdated
# pivot norms (pauxy_tpu/ops/cpqr.py:CPQR_NORM_REFRESH).
CPQR_NORM_REFRESH = 16

# Shared memory one block may use on sm_90 (kSmemMax in gauss_jordan.cuh),
# and the form-Q pass's column block (kQcb in csrc/cpqr.cu).
SMEM_MAX = 232448
QCB = 16

_SYMBOLS = {torch.complex64: "pauxy_cpqr_c64",
            torch.complex128: "pauxy_cpqr_c128"}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64,
            torch.complex128: torch.complex128}
DTYPES = tuple(_COMPLEX)


def smem_bytes(m: int, dtype: torch.dtype) -> int:
    """Shared memory of the larger of the kernel's two passes at m
    (factor_bytes / formq_bytes in csrc/cpqr.cu): the form-Q pass holds the
    m x m reflectors, an m x 16 block of Q and tau."""
    c = _COMPLEX[dtype].itemsize
    factor = m * m * c + m * (c // 2) + 2 * (c // 2) + 8
    formq = m * m * c + m * QCB * c + m * (c // 2)
    return max(factor, formq)


def max_m(dtype: torch.dtype) -> int:
    """Largest m the kernel launches for ``dtype`` (162 for complex64 and
    float32, 112 for complex128 and float64): what fits one block's shared
    memory. ops/cpqr.cpqr sends a larger m to the plain version by shape."""
    m = 1
    while smem_bytes(m + 1, dtype) <= SMEM_MAX:
        m += 1
    return m


def cpqr_lanes_plain(a: torch.Tensor, pivot: bool = True):
    """Plain version, the mirror of ``_cpqr_xla``: Householder with
    deferred pivots (the pivot column is selected by masking processed
    columns; the reflection is applied to all columns), norms downdated
    with an exact refresh every CPQR_NORM_REFRESH columns, unit reflectors
    with tau = 2, and Q = I - V T V^H by compact WY with T^-1 =
    diag(1/tau) + striu(V^H V), T^-1 inverted by a triangular solve
    (``torch.linalg.solve_triangular``; JAX's takes ``clinalg.inv``).
    a [B, m, m] real or complex; returns (q, r, perm [B, m] int64) in the
    input's type."""
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
    if m > max_m(a.dtype):
        raise ValueError(f"cpqr_lanes: m = {m} > {max_m(a.dtype)}, what the "
                         f"kernel launches for {a.dtype}")
    cdtype = _COMPLEX[a.dtype]
    x = a.to(cdtype).contiguous()
    q = torch.empty_like(x)
    r = torch.empty_like(x)
    perm = torch.empty((b, m), dtype=torch.long, device=a.device)
    if b == 0 or m == 0:
        return q, r, perm
    packed = torch.empty_like(x)
    tau = torch.empty((b, m), dtype=x.real.dtype, device=a.device)
    fn = getattr(cuda_build.library(), _SYMBOLS[cdtype])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), r.data_ptr(), packed.data_ptr(),
                tau.data_ptr(), perm.data_ptr(), b, m, stream)
    cuda_build.check(rc, "cpqr_lanes")
    launches += 1
    if not a.is_complex():
        return q.real.contiguous(), r.real.contiguous(), perm
    return q, r, perm
