"""Plain phaseless AFQMC arithmetic, in PyTorch and nothing else.

The benchmark's reference for one step of the zero-temperature phaseless
block: the trial overlap and half-rotated Green's function, the
re-orthogonalisation (QR with a real positive diagonal), the one-body
half-steps, the force bias (clamped to unit modulus), the two-body
propagator exp(VHS) by its order-6 Taylor series, the hybrid weight with the
phaseless cosine and the bounded hybrid energy, the 10% weight cap, comb
population control and the mixed estimator's step sums. A model object
(``reference/generic.py``, ``reference/ueg.py``) supplies the Hamiltonian's
parts: ``psia``/``psib`` [M, n], ``apply_bh1``, ``force_bias``,
``mf_shift``, ``vhs`` and ``local_energy``.

Everything here is computed at the model's ``dtype`` (complex128 for the
reference, complex64 with TF32 products for the control) on the model's
device. Nothing of the program under test is imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TAYLOR_ORDER = 6
CAP_FRACTION = 0.10
ALIVE_WEIGHT = 1e-8


class StepIn(NamedTuple):
    """The walker state a step starts from (post population control)."""

    phia: torch.Tensor           # [w, M, na]
    phib: torch.Tensor           # [w, M, nb]
    weight: torch.Tensor         # [w] real
    hybrid_energy: torch.Tensor  # [w] complex, the previous step's
    total_weight: float          # the last population control's total


class StepOut(NamedTuple):
    phia: torch.Tensor
    phib: torch.Tensor
    weight: torch.Tensor
    hybrid_energy: torch.Tensor


def real_dtype(cd: torch.dtype) -> torch.dtype:
    return torch.float64 if cd == torch.complex128 else torch.float32


def log_overlap_greens(phi: torch.Tensor, psi: torch.Tensor):
    """(log <psi|phi> [w] complex, Ghalf [w, n, M]) with S = phi^T psi*,
    Ghalf = S^-1 phi^T and the log's phase in (-pi, pi]."""
    s = phi.transpose(-1, -2) @ psi.conj()
    sign, logabs = torch.linalg.slogdet(s)
    ghalf = torch.linalg.solve(s, phi.transpose(-1, -2))
    return torch.complex(logabs, torch.angle(sign)), ghalf


def log_overlap(phi: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    s = phi.transpose(-1, -2) @ psi.conj()
    sign, logabs = torch.linalg.slogdet(s)
    return torch.complex(logabs, torch.angle(sign))


def reortho(phi: torch.Tensor) -> torch.Tensor:
    """Q of phi = Q R with R's diagonal real and positive (unique)."""
    q, r = torch.linalg.qr(phi)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    return q * (d / d.abs())[..., None, :]


def taylor(vhs: torch.Tensor, phi: torch.Tensor,
           order: int = TAYLOR_ORDER) -> torch.Tensor:
    """sum_{k <= order} vhs^k phi / k!."""
    term = out = phi
    for k in range(1, order + 1):
        term = (vhs @ term) / k
        out = out + term
    return out


def propagate(model, st: StepIn, xi: torch.Tensor, eshift: float,
              dt: float, *, ortho: bool, cap: bool) -> StepOut:
    """One phaseless step of every walker in ``st``: optional
    re-orthogonalisation, B_{T/2} e^{VHS(x - xbar)} B_{T/2}, the hybrid
    weight update and the weight cap. ``xi`` [w, F] are the step's normal
    field draws."""
    cd = model.dtype
    rd = real_dtype(cd)
    phia, phib = st.phia.to(cd), st.phib.to(cd)
    if ortho:
        phia, phib = reortho(phia), reortho(phib)
    la, gha = log_overlap_greens(phia, model.psia)
    lb, ghb = log_overlap_greens(phib, model.psib)
    log_o = la + lb
    pa, pb = model.apply_bh1(phia, phib)
    xbar = model.force_bias(gha, ghb)
    absx = xbar.abs()
    xbar = torch.where(absx > 1.0, xbar / torch.where(absx == 0, 1.0, absx),
                       xbar)
    x = xi.to(rd)
    xs = x - xbar
    sqrt_dt = math.sqrt(dt)
    cmf = -sqrt_dt * (xs @ model.mf_shift)
    cfb = torch.sum(x * xbar, dim=-1) - 0.5 * torch.sum(xbar * xbar, dim=-1)
    na = pa.shape[-1]
    phi = taylor(model.vhs(xs), torch.cat([pa, pb], dim=-1))
    pa, pb = model.apply_bh1(phi[..., :na], phi[..., na:])
    log_o_new = log_overlap(pa, model.psia) + log_overlap(pb, model.psib)
    ehyb = -(log_o_new - log_o + cfb + cmf) / dt
    if abs(eshift) >= 1e-10:
        bound = math.sqrt(2.0 / dt)
        ehyb = torch.complex(ehyb.real.clamp(eshift - bound, eshift + bound),
                             ehyb.imag)
    ehyb_prev = st.hybrid_energy.to(cd)
    log_imp = -dt * (0.5 * (ehyb + ehyb_prev) - eshift)
    magn = torch.exp(log_imp.real)
    dtheta = (-dt * ehyb - cfb).imag
    w_in = st.weight.to(rd)
    w = w_in * magn * torch.clamp_min(torch.cos(dtheta), 0.0)
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    alive = w_in.abs() > ALIVE_WEIGHT
    w = torch.where(alive, w, w_in)
    ehyb = torch.where(alive, ehyb, ehyb_prev)
    pa = torch.where(alive[:, None, None], pa, phia)
    pb = torch.where(alive[:, None, None], pb, phib)
    if cap:
        c = CAP_FRACTION * st.total_weight
        w = torch.where(w.abs() > c, torch.full_like(w, c), w)
    return StepOut(pa, pb, w, ehyb)


def comb(weight: torch.Tensor, target: float, uniform: float,
         margin: float):
    """Comb resampling of ``weight`` [w] in float64: (parents [w], and the
    lowest and highest parent [w] a tooth reaches when moved by ``margin``
    of the teeth's spacing either way, total |weight|). Teeth at
    (i + uniform) target / w against the cumulative rescaled weights."""
    w = weight.abs().to(torch.float64)
    nw = w.shape[0]
    total = w.sum()
    cum = torch.cumsum(w * (target / total), dim=0)
    idx = torch.arange(nw, device=w.device)
    teeth = (idx.to(torch.float64) + uniform) * (target / nw)
    d = margin * target / nw

    def parent(t):
        return torch.searchsorted(cum, t, right=True).clamp(0, nw - 1)

    return parent(teeth), parent(teeth - d), parent(teeth + d), float(total)


def step_sums(model, phia, phib, weight, unscaled_weight, hybrid_energy,
              eval_energy: bool):
    """A step's mixed-estimator sums [8] float64, real parts: UWEIGHT,
    WEIGHT, ENUMER, EDENOM, E1B, E2B, EHYB, OVLP (the energy terms zero
    unless ``eval_energy``), and with ``eval_energy`` each walker's (etot,
    e1b, e2b), else None; the energies in blocks of walkers."""
    cd = model.dtype
    w = weight.to(torch.float64)
    out = torch.zeros(8, dtype=torch.float64, device=w.device)
    out[0] = unscaled_weight.to(torch.float64).sum()
    out[1] = w.sum()
    out[6] = (w * hybrid_energy.real.to(torch.float64)).sum()
    nw = w.shape[0]
    chunk = model.walker_chunk
    ovlp = torch.zeros((), dtype=torch.float64, device=w.device)
    parts = []
    for w0 in range(0, nw, chunk):
        sl = slice(w0, min(w0 + chunk, nw))
        pa, pb = phia[sl].to(cd), phib[sl].to(cd)
        la, gha = log_overlap_greens(pa, model.psia)
        lb, ghb = log_overlap_greens(pb, model.psib)
        ovlp = ovlp + (w[sl] * torch.exp((la + lb).real.to(torch.float64))
                       ).sum()
        if eval_energy:
            parts.append(model.local_energy(gha, ghb))
    energies = None
    if eval_energy:
        energies = tuple(torch.cat([p[k] for p in parts]) for k in range(3))
        for k, e in ((2, energies[0]), (4, energies[1]), (5, energies[2])):
            out[k] = (w * e.real.to(torch.float64)).sum()
        out[3] = w.sum()
    out[7] = ovlp
    return out, energies


def block_row(sums: torch.Tensor, nsteps: int) -> dict:
    """The block's output row from its summed step sums, by name."""
    s = sums.tolist()
    denom = s[3] if abs(s[3]) > 0 else 1.0
    wsum = s[1] if abs(s[1]) > 0 else 1.0
    return {"Weight": s[1] / nsteps, "WeightFactor": s[0] / nsteps,
            "ENumer": s[2], "EDenom": s[3], "ETotal": s[2] / denom,
            "E1Body": s[4] / denom, "E2Body": s[5] / denom,
            "EHybrid": s[6] / wsum, "Overlap": s[7] / wsum}
