"""Low-rank thermal propagator stack (masked fixed-shape QDT truncation).

Counterpart of ``pauxy_tpu/walkers/low_rank.py``. The path product
A(tau) = B_T^{L-t-1} B(x_t) ... B(x_1) is kept in factored form

    A = diag(Dl) . Qr diag(Dr) Tr

with the left (trial) part diagonal (low rank requires a diagonal trial
density matrix) and the right (stochastic) part a QDT factorization
re-orthogonalized at stack boundaries. Directions whose D entry falls below
``thresh`` are dead; rank truncation is a mask, never a shape: pivoted QR
sorts |diag R| descending, dead directions are zeroed in place, and every
inverse and determinant over the active block is taken on an
identity-padded full-size matrix (inactive diagonal = 1 leaves det and
inverse of the active block unchanged). The per-spin overlap det(1 + A) is
a complex log.

The pivoted QRs go through ``ops/cpqr`` (the cpqr kernel on the card), the
padded inverses and log-dets through ``ops/clinalg`` (kernel B at n = M):
one ``inv_logdet`` pass gives both the inverse and the log-det of each
padded matrix, where JAX takes a solve against the identity and a separate
slogdet of the same matrix. JAX's ``lax.cond`` on the stack boundary is a
Python branch on the slice index.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import clinalg, cpqr


@dataclasses.dataclass
class LowRankWalkerState:
    """Thermal walker population in low-rank stack form."""

    Qr: torch.Tensor            # [w, 2, M, M] right-product Q factor
    Dr: torch.Tensor            # [w, 2, M]    right-product D
    Tr: torch.Tensor            # [w, 2, M, M] right-product T factor
    Dl: torch.Tensor            # [w, 2, M]    diagonal left (trial) product
    G: torch.Tensor             # [w, 2, M, M] current Green's function
    log_ovlp: torch.Tensor      # [w, 2] complex log det(1 + A) per spin
    weight: torch.Tensor        # [w]
    unscaled_weight: torch.Tensor
    phase: torch.Tensor         # [w] complex
    total_weight: torch.Tensor  # []
    hybrid_energy: torch.Tensor  # [w], as on ThermalWalkerState

    @property
    def nwalkers(self) -> int:
        return self.Qr.shape[0]

    @property
    def nbasis(self) -> int:
        return self.Qr.shape[-1]


def _safe_inv(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1/d where mask, else 0 (no inf or nan from dead directions)."""
    one = torch.ones_like(d)
    return torch.where(mask, 1.0 / torch.where(mask, d, one),
                       torch.zeros_like(d))


def _identity_pad(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1 on the diagonal of inactive rows and columns, so that det and inv
    of the padded matrix equal those of the active block."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return m + eye * (1.0 - mask.to(m.dtype))[..., None, :]


def _green_from_clcr(clcr: torch.Tensor, t_in: torch.Tensor,
                     mask_l: torch.Tensor, thresh: float):
    """Pivoted QR of the combined left-right core ``clcr`` [..., M, M]
    (dead rows and columns 0), the Db/Ds overflow split, G = 1 - Q D A T
    and log det(1 + A); ``t_in`` is the row factor the new T multiplies
    into, ``mask_l`` the active left directions. Returns (G, log_ovlp)."""
    cdtype = clcr.dtype
    q2, r2, p2 = cpqr.cpqr(clcr)
    d2 = torch.diagonal(r2, dim1=-2, dim2=-1)
    mask_t = d2.abs() > thresh
    d2m = d2 * mask_t.to(cdtype)
    tmp = cpqr.unpermute_columns(_safe_inv(d2, mask_t)[..., :, None] * r2,
                                 p2)
    tlcr = torch.matmul(tmp, t_in)
    # Dead rows and columns of Q2 zeroed (the explicit mL x mT embedding).
    q2m = (q2 * mask_l.to(cdtype)[..., :, None]
           * mask_t.to(cdtype)[..., None, :])
    absd = d2.abs()
    big = absd > 1.0
    one = torch.ones_like(absd)
    safe_big = torch.where(big, absd, one)
    db = torch.where(mask_t, torch.where(big, 1.0 / safe_big, one), one)
    ds = torch.where(mask_t, torch.where(big, d2 / safe_big.to(cdtype), d2),
                     torch.zeros_like(d2))
    db = db.to(cdtype)
    tq = torch.matmul(tlcr, q2m)
    eye = torch.eye(tq.shape[-1], dtype=cdtype, device=tq.device)
    ld_tq, tq_inv = clinalg.inv_logdet(_identity_pad(tq, mask_t))
    core = tq_inv * db[..., None, :] + ds[..., None] * eye
    ld_core, core_inv = clinalg.inv_logdet(core)
    # det(1 + A) = det(core) det(Db)^-1 det(TQ), assembled in the log
    # domain from the well-conditioned pieces (core times 1/db would
    # re-amplify the stabilized scales and underflow at long beta).
    log_ovlp = ld_core - torch.log(db).sum(-1) + ld_tq
    im = torch.remainder(log_ovlp.imag + math.pi, 2 * math.pi) - math.pi
    log_ovlp = torch.complex(log_ovlp.real, im)
    a = db[..., :, None] * torch.matmul(core_inv, tq_inv)
    g = eye - torch.matmul(q2m * d2m[..., None, :], torch.matmul(a, tlcr))
    return g, log_ovlp


def update_low_rank(btinv_diag: torch.Tensor, state: LowRankWalkerState,
                    b: torch.Tensor, ts: int, *, stack_size: int,
                    thresh: float) -> LowRankWalkerState:
    """Push one slice propagator b [w, 2, M, M] at time slice ``ts``.

    At a stack boundary (ts % stack_size == stack_size - 1) the right
    product is re-orthogonalized by pivoted QR before the left-right
    combine; within a stack b accumulates into Qr and only the combine
    runs. Returns the updated state with fresh G and log_ovlp."""
    cdtype = state.Qr.dtype
    dl = state.Dl * btinv_diag[None]                   # drop one left slice
    mask_l = dl.abs() > thresh
    dlm = dl * mask_l.to(cdtype)
    mask_r = state.Dr.abs() > thresh
    qrb = torch.matmul(b, state.Qr * mask_r.to(cdtype)[..., None, :])
    ccr = qrb * (state.Dr * mask_r.to(cdtype))[..., None, :]
    if ts % stack_size == stack_size - 1:
        q1, r1, p1 = cpqr.cpqr(ccr)
        d1 = torch.diagonal(r1, dim1=-2, dim2=-1)
        tmp = cpqr.unpermute_columns(
            _safe_inv(d1, d1.abs() > 0.0)[..., :, None] * r1, p1)
        t1 = torch.matmul(tmp, state.Tr)
        clcr = dlm[..., :, None] * (q1 * d1[..., None, :])
        g, log_ovlp = _green_from_clcr(clcr, t1, mask_l, thresh)
        qr_new, dr_new, tr_new = q1, d1, t1
    else:
        clcr = dlm[..., :, None] * ccr
        g, log_ovlp = _green_from_clcr(clcr, state.Tr, mask_l, thresh)
        qr_new, dr_new, tr_new = qrb, state.Dr, state.Tr
    return dataclasses.replace(state, Qr=qr_new, Dr=dr_new, Tr=tr_new, Dl=dl,
                               G=g, log_ovlp=log_ovlp)


def init_low_rank_walkers(trial, nwalkers: int) -> LowRankWalkerState:
    """All paths at the trial: A = B_T^{num_slices} (diagonal), right = 1;
    G and log det(1 + A) are closed forms of the diagonal left product."""
    m = trial.nbasis
    cdtype = trial.dmat.dtype
    rdtype = config.real_dtype(cdtype)
    dev = trial.dmat.device
    bt_diag = torch.diagonal(trial.dmat, dim1=-2, dim2=-1)     # [2, M]
    dl = (bt_diag ** trial.num_slices)[None].expand(
        nwalkers, 2, m).contiguous()
    eye = torch.eye(m, dtype=cdtype, device=dev).expand(
        nwalkers, 2, m, m)
    return LowRankWalkerState(
        Qr=eye.clone(),
        Dr=torch.ones((nwalkers, 2, m), dtype=cdtype, device=dev),
        Tr=eye.clone(),
        Dl=dl,
        G=eye * (1.0 / (1.0 + dl))[..., None, :],
        log_ovlp=torch.log(1.0 + dl).sum(-1),
        weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        unscaled_weight=torch.ones(nwalkers, dtype=rdtype, device=dev),
        phase=torch.ones(nwalkers, dtype=cdtype, device=dev),
        total_weight=torch.tensor(float(nwalkers), dtype=rdtype, device=dev),
        hybrid_energy=torch.zeros(nwalkers, dtype=cdtype, device=dev),
    )
