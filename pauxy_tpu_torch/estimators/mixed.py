"""Mixed estimator: per-step accumulation and host-side block reporting.

Counterpart of the header, accumulator layout, ``energy_estimator``,
``energy_estimator_G`` (the thermal path's and back propagation's),
``dms_size``, ``update`` and ``MixedReporter`` of
``pauxy_tpu/estimators/mixed.py``. ``update`` is the generic block's
per-step accumulation: phaseless or free projection; a single-determinant
trial (Hubbard, Hubbard-Holstein, Generic with its energy variants, UEG or
PW_FFT), a multi-determinant one (the det-weighted energy:
per-determinant half-rotated for a Generic system, else the dense-G
energy of each determinant), a GHF one (Hubbard) or a multi-coherent one
(Hubbard-Holstein, component-weighted); and
the optional density-matrix tail, the weighted 1-RDM [2, M, M] and the
UEG's structure factor S(k) [2, 2, nq], summed on energy steps. The lanes
block of ``qmc/hubbard_fast.py`` keeps its own. ``MixedReporter`` turns a
block's sums into an output row, prints it and pushes it (and the
density matrices, normalised by EDenom) to the HDF5 file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.models import ghf
from pauxy_tpu_torch.models import multi_coherent as mcoh
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.ops import greens
from pauxy_tpu_torch.utils.tracing import span

# Accumulator column indices.
UWEIGHT, WEIGHT, ENUMER, EDENOM, E1B, E2B, EHYB, OVLP = range(8)
NACC = 8

HEADER = [
    "Iteration",
    "WeightFactor",
    "Weight",
    "ENumer",
    "EDenom",
    "ETotal",
    "E1Body",
    "E2Body",
    "EHybrid",
    "Overlap",
    "Time",
]


def energy_estimator(ham, trial, ri_theta=None, x=None):
    """Batched ``(ga, gb) -> (etot, e1b, e2b)`` local energy from the two
    spins' ``SpinGreens``: Hubbard from G, Hubbard-Holstein from G and the
    phonon coordinates ``x`` [w, M] about the trial's shift, Generic from
    Ghalf (the half-rotated Cholesky energy, per determinant and
    det-weighted for a multi-determinant trial; else the system's variant,
    in JAX's order: PNO, exact ERIs, stochastic RI with the probes
    ``ri_theta`` [X, S]),
    the UEG from Ghalf by FFT correlations when the system has its cube
    maps (else from G by the gather kernels), PW_FFT from Ghalf."""
    if ham.name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga.G, gb.G)
    if ham.name == "HubbardHolstein":
        if x is None:
            raise ValueError(
                "the Hubbard-Holstein local energy needs the phonon "
                "coordinates")
        return lambda ga, gb: le.local_energy_hubbard_holstein(
            ham, ga.G, gb.G, x, trial.shift)
    if ham.name == "Generic":
        if isinstance(trial, msd.MultiSlaterTrial):
            return lambda ga, gb: le.local_energy_generic_opt_multi(
                trial, ga.Ghalf, gb.Ghalf, ga.det_weights, ham.ecore)
        if ham.pno:
            return lambda ga, gb: le.local_energy_generic_pno(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore)
        if ham.exact_eri:
            return lambda ga, gb: le.local_energy_generic_exact_eri(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore)
        if ham.stochastic_ri:
            if ri_theta is None:
                raise ValueError(
                    "the stochastic-RI local energy needs its probes")
            return lambda ga, gb: le.local_energy_generic_stochastic_ri(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore, ri_theta,
                ham.control_variate)
        return lambda ga, gb: le.local_energy_generic_opt(
            trial, ga.Ghalf, gb.Ghalf, ham.ecore)
    if ham.name == "UEG":
        if getattr(ham, "gmap", None) is not None:
            return lambda ga, gb: le.local_energy_ueg_half(
                ham, trial, ga.Ghalf, gb.Ghalf)
        return lambda ga, gb: le.local_energy_ueg(ham, ga.G, gb.G)
    if ham.name == "PW_FFT":
        return lambda ga, gb: le.local_energy_pw_fft(ham, trial, ga.Ghalf,
                                                     gb.Ghalf)
    raise NotImplementedError(
        f"no ported local energy for system {ham.name!r}")


def needs_full_g(ham) -> bool:
    """Whether the system's local energy reads the full G (else only the
    half-rotated one is formed)."""
    return ham.name in ("Hubbard", "HubbardHolstein") or (
        ham.name == "UEG" and getattr(ham, "gmap", None) is None)


def energy_estimator_G(ham):
    """Dense-G local energy ``(Ga, Gb) -> (etot, e1b, e2b)`` (the thermal
    measurement's and the back-propagated one's): Hubbard, Generic (from
    the Cholesky factors) and UEG."""
    if ham.name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga, gb)
    if ham.name == "Generic":
        return lambda ga, gb: le.local_energy_generic_cholesky_G(ham, ga, gb)
    if ham.name == "UEG":
        return lambda ga, gb: le.local_energy_ueg(ham, ga, gb)
    raise NotImplementedError(
        f"no ported dense-G energy kernel for {ham.name!r}")


def dms_size(ham, calc_one_rdm: bool, calc_two_rdm: str | None) -> int:
    """Length of the accumulator's density-matrix tail: 2 M^2 for the
    1-RDM, 4 nq for the structure factor (``two_rdm="structure_factor"``,
    the UEG only; any other ``two_rdm`` raises)."""
    n = 0
    if calc_one_rdm:
        n += 2 * ham.nbasis * ham.nbasis
    if calc_two_rdm is not None:
        if calc_two_rdm != "structure_factor" or ham.name != "UEG":
            raise NotImplementedError(
                "two_rdm accumulation supports only 'structure_factor' on "
                "the UEG")
        n += 4 * ham.nq
    return n


def check_dms(ham, trial, free_projection: bool, calc_one_rdm: bool,
              calc_two_rdm: str | None) -> int:
    """``dms_size`` with the refusals JAX keeps: no density matrices with
    free projection or with a GHF trial (its G is 2M x 2M), no S(k) with a
    multi-coherent trial."""
    ndms = dms_size(ham, calc_one_rdm, calc_two_rdm)
    if ndms and free_projection:
        raise NotImplementedError("RDM accumulation not defined for FP")
    if ndms and isinstance(trial, ghf.GHFTrial):
        raise NotImplementedError(
            "GHF G is 2M x 2M; one_rdm output is spin-blocked")
    if calc_two_rdm is not None and isinstance(trial,
                                               mcoh.MultiCoherentTrial):
        raise NotImplementedError(
            "two_rdm (S(k)) is UEG-only; multi-coherent trials are "
            "Hubbard-Holstein")
    return ndms


def _energies(ham, trial, state, want_g2: bool, ri_theta=None):
    """(etot, e1b, e2b, g2) of every walker: the local energies [w] and,
    with ``want_g2``, its (det- or component-weighted) Green's functions
    [w, 2, M, M] with the half-rotated factors of a single determinant
    (None otherwise). The span ``energy``."""
    with span("energy"):
        if isinstance(trial, mcoh.MultiCoherentTrial):
            gi, comp_w = mcoh.mc_greens_function(trial, state.phia,
                                                 state.phib, state.X)
            _, lap = mcoh.phonon_terms(trial, comp_w, state.X)
            g2 = None
            if want_g2:
                g2 = (torch.einsum("wp,wpsmn->wsmn", comp_w, gi), None)
            return (*le.local_energy_multi_coherent(ham, gi, comp_w,
                                                    state.X, lap), g2)
        if isinstance(trial, ghf.GHFTrial):
            gi, det_weights = ghf.ghf_greens_function(trial, state.phia,
                                                      state.phib)
            return (*le.local_energy_hubbard_ghf(ham, gi, det_weights),
                    None)
        if isinstance(trial, msd.MultiSlaterTrial):
            fast = ham.name == "Generic" and trial.rchola is not None
            md = msd.greens_function_multi_det(trial, state.phia,
                                               state.phib,
                                               want_g=want_g2 or not fast)
            g2 = (md.G, None) if want_g2 else None
            if fast:
                return (*le.local_energy_generic_opt_multi(
                    trial, md.Ghalfa, md.Ghalfb, md.det_weights, ham.ecore),
                    g2)
            nw, nd = md.det_weights.shape
            m = state.nbasis
            gi = md.Gi.reshape(nw * nd, 2, m, m)
            per_det = energy_estimator_G(ham)(gi[:, 0], gi[:, 1])
            return (*(torch.sum(md.det_weights * x.reshape(nw, nd), dim=-1)
                      for x in per_det), g2)
        want_g = needs_full_g(ham) or want_g2
        ga = greens.greens_function(state.phia, trial.psia, want_g)
        gb = greens.greens_function(state.phib, trial.psib, want_g)
        g2 = (torch.stack([ga.G, gb.G], dim=1), (ga.Ghalf, gb.Ghalf)) \
            if want_g2 else None
        return (*energy_estimator(ham, trial, ri_theta, state.X)(ga, gb),
                g2)


def _dms_flat(ham, trial, wfac, g2, calc_one_rdm: bool,
              calc_two_rdm: str | None) -> torch.Tensor:
    """The step's weighted density-matrix tail: sum_w wfac_w Re G_w
    [2, M, M], then sum_w wfac_w Re S_w(k) [2, 2, nq], flattened. S(k)
    takes the FFT route from the half-rotated G of a single-determinant
    trial on a system with its cube maps, else the dense route from G."""
    cdtype = wfac.dtype
    g, halves = g2
    parts = []
    if calc_one_rdm:
        parts.append(torch.einsum("w,wsmn->smn", wfac,
                                  g.real.to(cdtype)).reshape(-1))
    if calc_two_rdm is not None:
        if halves is not None and getattr(ham, "gmap", None) is not None:
            factors = ((trial.psia, halves[0]), (trial.psib, halves[1]))
        else:
            factors = ((g[:, 0], None), (g[:, 1], None))
        sk = le.structure_factor_ueg(ham, factors)         # [w, 2, 2, nq]
        parts.append(torch.einsum("w,wabq->abq", wfac,
                                  sk.real.to(cdtype)).reshape(-1))
    return torch.cat(parts)


def update(ham, trial, state, eval_energy: bool,
           free_projection: bool = False, calc_one_rdm: bool = False,
           calc_two_rdm: str | None = None, ri_theta=None) -> torch.Tensor:
    """One step's contribution to the block accumulator, [NACC + ndms]
    complex: UWEIGHT, WEIGHT, ENUMER, EDENOM, E1B, E2B, EHYB, OVLP, then
    the density-matrix tail (``_dms_flat``). The energy terms and the tail
    are zero unless ``eval_energy``. Free projection weighs each walker by
    weight x overlap x phase and keeps the energies complex. ``ri_theta``
    [X, S] are the stochastic-RI energy's probes (that variant only)."""
    ndms = check_dms(ham, trial, free_projection, calc_one_rdm, calc_two_rdm)
    cdtype = state.log_ovlp.dtype
    if free_projection:
        ot = torch.exp(state.log_ovlp)
        wfac = state.weight * ot * state.phase
        ovlp = state.weight * ot.abs()
    else:
        wfac = state.weight.to(cdtype)
        ovlp = state.weight * torch.exp(state.log_ovlp.real)
    zero = torch.zeros((), dtype=cdtype, device=wfac.device)
    enumer = edenom = e1b = e2b = zero
    dms = torch.zeros(ndms, dtype=cdtype, device=wfac.device)
    if eval_energy:
        etot, ke, pe, g2 = _energies(ham, trial, state, bool(ndms),
                                     ri_theta)
        if not free_projection:
            etot, ke, pe = etot.real, ke.real, pe.real
        enumer = torch.sum(wfac * etot)
        edenom = torch.sum(wfac)
        e1b = torch.sum(wfac * ke)
        e2b = torch.sum(wfac * pe)
        if ndms:
            dms = _dms_flat(ham, trial, wfac, g2, calc_one_rdm,
                            calc_two_rdm)
    acc = [None] * NACC
    acc[UWEIGHT] = torch.sum(state.unscaled_weight).to(cdtype)
    acc[WEIGHT] = torch.sum(wfac)
    acc[ENUMER] = enumer
    acc[EDENOM] = edenom
    acc[E1B] = e1b
    acc[E2B] = e2b
    acc[EHYB] = torch.sum(wfac * state.hybrid_energy)
    acc[OVLP] = torch.sum(ovlp).to(cdtype)
    return torch.cat([torch.stack(acc), dms])


class MixedReporter:
    """Block normalization, stdout table and HDF5 push. ``dms_shapes`` are
    the (dataset name, shape) of the accumulator's density-matrix tail, in
    order (``one_rdm`` [2, M, M], ``two_rdm`` [2, 2, nq])."""

    def __init__(self, nsteps: int, output=None, verbose: bool = True,
                 dms_shapes=()):
        self.nsteps = nsteps
        self.output = output
        self.verbose = verbose
        self._t0 = time.time()
        self.eshift_hybrid = 0.0
        self.eshift_proj = 0.0
        self.dms_shapes = list(dms_shapes)

    def print_header(self):
        if self.verbose:
            print("".join(f"{h:>17s}" for h in HEADER))

    def block_row(self, step: int, acc: np.ndarray) -> np.ndarray:
        """Normalize a summed block accumulator [NACC + ndms] into an
        output row; the density matrices go to the file divided by EDenom
        (the weight of the energy steps they were summed on)."""
        acc = np.asarray(acc)
        now = time.time()
        elapsed = now - self._t0
        self._t0 = now
        edenom = acc[EDENOM]
        # Guard a row where no energy was accumulated.
        denom = edenom if abs(edenom) > 0 else 1.0
        etotal = acc[ENUMER] / denom
        wsum = acc[WEIGHT] if abs(acc[WEIGHT]) > 0 else 1.0
        self.eshift_hybrid = acc[EHYB] / wsum
        self.eshift_proj = etotal
        row = np.array(
            [
                step,
                acc[UWEIGHT] / self.nsteps,
                acc[WEIGHT] / self.nsteps,
                acc[ENUMER],
                edenom,
                etotal,
                acc[E1B] / denom,
                acc[E2B] / denom,
                self.eshift_hybrid,
                acc[OVLP] / wsum,
                elapsed,
            ],
            dtype=np.complex128,
        )
        if self.verbose:
            print("".join(f"{v.real: 16.8e} " for v in row))
        if self.output is not None:
            self.output.push(row, "energies")
            off = NACC
            for name, shape in self.dms_shapes:
                size = int(np.prod(shape))
                self.output.push(acc[off:off + size].reshape(shape) / denom,
                                 name)
                off += size
            self.output.increment()
        return row

    def get_shift(self, hybrid: bool = True) -> float:
        """New eshift after a block."""
        e = self.eshift_hybrid if hybrid else self.eshift_proj
        return float(np.real(e))
