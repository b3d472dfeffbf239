"""Lanes-layout phaseless block for the Hubbard model (the main path).

Counterpart of ``pauxy_tpu/qmc/hubbard_fast.py``. The whole block runs in
the walker-last layout [M, n, W]: one layout change per block, every
per-walker small-matrix operation either kernel A (``ops/greens_cuda``) or
unrolled lane-parallel tensor code (``ops/lanelinalg``). Same step schedule,
same random-draw shapes and same accumulator layout as the JAX block, so a
test that injects JAX's draws through ``noise`` follows its trajectory.

Supported: continuous HS (charge or spin decomposition), single-determinant
trial, hybrid phaseless, with or without force bias, comb or pair_branch
population control, mixed estimator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import mixed
from pauxy_tpu_torch.ops import greens_cuda
from pauxy_tpu_torch.ops import lanelinalg as ll
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.propagation.continuous import (Continuous, _bound_hybrid,
                                                    is_single_det)
from pauxy_tpu_torch.propagation.hubbard import HubbardContinuous
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.utils.tracing import span


# The spellings of kernel A's route (JAX's "pallas" and per-shard "shard").
GREENS_IMPLS = (None, "pallas", "shard")


class BlockNoise(NamedTuple):
    """Random draws of one block, for tests: ``xi`` [nsteps, ...] the
    propagator's draws (normal HS fields [M, W] here; in the generic block
    of ``qmc/afqmc.py`` the site sweep's uniforms [M, w] or the Generic HS
    fields [w, X]); ``pop`` [nsteps, k]
    population-control uniforms (k = 1 for comb, W // 2 for pair_branch),
    read on population-control steps; ``est`` [nsteps, X, S] the
    stochastic-RI energy's probes (that variant only)."""

    xi: torch.Tensor
    pop: torch.Tensor
    est: torch.Tensor | None = None


def eligible(ham, trial, prop, *, free_projection, nbp, nitcf,
             calc_one_rdm, calc_two_rdm, pop_method) -> bool:
    """Whether this block supports the configuration."""
    return (
        ham.name == "Hubbard"
        and isinstance(prop, Continuous)
        and isinstance(prop.inner, HubbardContinuous)
        and prop.hybrid
        and not prop.stochastic_ri
        and not free_projection
        and not (nbp or nitcf or calc_one_rdm or calc_two_rdm)
        and is_single_det(trial)
        and pop_method in ("comb", "pair_branch")
    )


def _greens_lanes(psi, phi):
    """(logdet [W], ghT [M, n, W], diag(G) [M, W]) of one spin sector;
    diag(G)_q = sum_i conj(psi[q, i]) ghT[q, i]."""
    logdet, ght = greens_cuda.greens_lanes(psi, phi, want_gh=True)
    diag = torch.sum(psi.conj()[:, :, None] * ght, dim=1)
    return logdet, ght, diag


def _log_overlap_lanes(psi, phi):
    return greens_cuda.greens_lanes(psi, phi, want_gh=False)[0]


def run_block_lanes(ham, trial, prop, state, generator, eshift: float,
                    step0: int, *, nsteps: int, nstblz: int,
                    npop_control: int, pop_method: str, target_weight: float,
                    energy_eval_freq: int, noise: BlockNoise | None = None,
                    greens_impl: str | None = None):
    """Advance ``state`` by one block of ``nsteps`` steps.

    Every Green's function and overlap goes through kernel A
    (``greens_cuda.greens_lanes``) on the walkers this rank holds; on a
    walker mesh that is JAX's per-shard ``"shard"`` route, and
    ``greens_impl`` takes that spelling (or ``"pallas"``, or None) for it.
    Each step's phases are the spans ``ortho``, ``propagate`` (the step
    and the weight cap), ``pop_control`` and ``measure``
    (``utils/tracing``).

    Returns (state, accumulator [2, NACC] real: the block sums of the
    mixed-estimator columns, real and imaginary parts). Draws come from
    ``generator`` on the walkers' device unless ``noise`` is given.
    """
    if greens_impl not in GREENS_IMPLS:
        raise ValueError(f"greens_impl {greens_impl!r}, want one of "
                         f"{GREENS_IMPLS}")
    if greens_impl == "shard" and pmesh.active_mesh() is None:
        raise ValueError("greens_impl 'shard' needs an active walker mesh")
    inner = prop.inner
    psia = trial.psia
    psib = trial.psib
    cdtype = state.log_ovlp.dtype
    rdtype = config.real_dtype(cdtype)
    dev = state.phia.device
    m = state.nbasis
    nw = state.nwalkers
    dt = prop.dt
    sqrt_dt = prop.sqrt_dt
    sqrt_u = inner.U ** 0.5
    mf_shift = inner.mf_shift[:, None]
    # Trial-rotated kinetic contraction A_s = (psi_s^dag T_s)^T so that
    # ke = sum_qi A[q, i] ghT[q, i, W] without building the full G.
    t = ham.T.to(cdtype)
    ea = (psia.conj().T @ t[0]).T[:, :, None]               # [M, n, 1]
    eb = (psib.conj().T @ t[1]).T[:, :, None]

    phia = ll.to_lanes(state.phia)
    phib = ll.to_lanes(state.phib)
    weight = state.weight
    uw = state.unscaled_weight
    log_ovlp = state.log_ovlp
    ehyb_prev = state.hybrid_energy
    ldetr = state.log_detr
    tw = state.total_weight
    accs = []
    for i in range(nsteps):
        step = step0 + 1 + i
        if step % nstblz == 0:
            with span("ortho"):
                qa, la = ll.cholesky_qr2(phia)
                qb, lb = ll.cholesky_qr2(phib)
                log_r = la + lb
                phia, phib = qa, qb
                log_ovlp = log_ovlp - log_r.to(cdtype)
                ldetr = ldetr + log_r

        # ---- propagate ---------------------------------------------------
        with span("propagate"):
            log_a, _, da = _greens_lanes(psia, phia)
            log_b, _, db = _greens_lanes(psib, phib)
            log_o = log_a + log_b
            phia1 = ll.matmul_left(inner.BH1[0], phia)
            phib1 = ll.matmul_left(inner.BH1[1], phib)
            if noise is None:
                xi = pmesh.draw(lambda shape: torch.randn(
                    shape, generator=generator, dtype=rdtype, device=dev),
                    (m, nw), walker_dim=1)
            else:
                xi = noise.xi[i]
            if prop.force_bias:
                vbias = 1j * sqrt_u * (da + db) if inner.charge \
                    else sqrt_u * (da - db)
                xbar = -sqrt_dt * (vbias - mf_shift)
                absx = xbar.abs()
                # Clamp components with |xbar| > 1 to unit modulus.
                xbar = torch.where(absx > 1.0, xbar / absx, xbar)
            else:
                xbar = torch.zeros(m, nw, dtype=cdtype, device=dev)
            xshifted = xi - xbar
            cmf = -sqrt_dt * torch.sum(xshifted * mf_shift, dim=0)   # [W]
            cfb = (torch.sum(xi * xbar, dim=0)
                   - 0.5 * torch.sum(xbar * xbar, dim=0))
            if inner.charge:
                gauge = torch.exp(sqrt_dt * 1j * sqrt_u
                                  * xshifted)[:, None, :]
                phia1 = phia1 * gauge
                phib1 = phib1 * gauge
            else:
                gauge = torch.exp((dt * inner.U) ** 0.5
                                  * xshifted)[:, None, :]
                phia1 = phia1 / gauge
                phib1 = phib1 * gauge
            phia1 = ll.matmul_left(inner.BH1[0], phia1)
            phib1 = ll.matmul_left(inner.BH1[1], phib1)
            log_new = (_log_overlap_lanes(psia, phia1)
                       + _log_overlap_lanes(psib, phib1))
            ehyb = -(log_new - log_o + cfb + cmf) / dt
            ehyb = _bound_hybrid(ehyb, eshift, prop.ebound)
            log_imp = -dt * (0.5 * (ehyb + ehyb_prev) - eshift)
            magn = torch.exp(log_imp.real)
            dtheta = (-dt * ehyb - cfb).imag
            new_w = weight * magn * torch.clamp_min(torch.cos(dtheta), 0.0)
            new_w = torch.where(torch.isfinite(new_w), new_w,
                                torch.zeros_like(new_w))
            # Walkers with negligible weight are frozen.
            alive = weight.abs() > 1e-8
            phia = torch.where(alive, phia1, phia)
            phib = torch.where(alive, phib1, phib)
            weight = torch.where(alive, new_w, weight)
            log_ovlp = torch.where(alive, log_new, log_ovlp)
            ehyb_prev = torch.where(alive, ehyb, ehyb_prev)

            # ---- weight cap at 10% of the total --------------------------
            if step > 1:
                cap = 0.10 * tw
                weight = torch.where(weight.abs() > cap, cap, weight)

        # ---- population control ------------------------------------------
        if step % npop_control == 0:
            with span("pop_control"):
                parents, new_w, total = pc.global_parents(
                    weight, target_weight, pop_method,
                    None if noise is None else noise.pop[i], generator)
                phia, phib = pmesh.exchange([phia, phib], parents, dim=-1)
                log_ovlp, ehyb_prev, ldetr = pmesh.exchange(
                    [log_ovlp, ehyb_prev, ldetr], parents)
                uw = weight
                weight = new_w
                tw = total

        # ---- mixed estimator ---------------------------------------------
        with span("measure"):
            wfac = weight.to(cdtype)
            if step % energy_eval_freq == 0:
                _, gha, da = _greens_lanes(psia, phia)
                _, ghb, db = _greens_lanes(psib, phib)
                ke = (torch.sum(ea * gha, dim=(0, 1))
                      + torch.sum(eb * ghb, dim=(0, 1)))
                if ham.symmetric:
                    pe = -0.5 * ham.U * torch.sum(da + db, dim=0)
                else:
                    pe = ham.U * torch.sum(da * db, dim=0)
                enumer = torch.sum(wfac * (ke + pe).real)
                edenom = torch.sum(wfac)
                e1b = torch.sum(wfac * ke.real)
                e2b = torch.sum(wfac * pe.real)
            else:
                enumer = edenom = e1b = e2b = torch.zeros((), dtype=cdtype,
                                                          device=dev)
            acc = [None] * mixed.NACC
            acc[mixed.UWEIGHT] = torch.sum(uw).to(cdtype)
            acc[mixed.WEIGHT] = torch.sum(wfac)
            acc[mixed.ENUMER] = enumer
            acc[mixed.EDENOM] = edenom
            acc[mixed.E1B] = e1b
            acc[mixed.E2B] = e2b
            acc[mixed.EHYB] = torch.sum(wfac * ehyb_prev)
            acc[mixed.OVLP] = torch.sum(weight * torch.exp(log_ovlp.real)
                                        ).to(cdtype)
            accs.append(torch.stack(acc))

    state = dataclasses.replace(
        state,
        phia=ll.from_lanes(phia),
        phib=ll.from_lanes(phib),
        weight=weight,
        unscaled_weight=uw,
        log_ovlp=log_ovlp,
        hybrid_energy=ehyb_prev,
        log_detr=ldetr,
        total_weight=tw,
    )
    s = pmesh.walker_sum(torch.stack(accs).sum(dim=0))
    return state, torch.stack([s.real, s.imag])
