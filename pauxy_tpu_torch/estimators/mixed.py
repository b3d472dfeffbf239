"""Mixed estimator: per-step accumulation and host-side block reporting.

Counterpart of the header, accumulator layout, ``energy_estimator``,
``energy_estimator_G`` (the thermal path's), ``update`` and
``MixedReporter`` of ``pauxy_tpu/estimators/mixed.py``.
``update`` is the generic block's per-step accumulation (single-determinant
trial, phaseless, Hubbard or Generic, no density matrices); the lanes block of
``qmc/hubbard_fast.py`` keeps its own. ``MixedReporter`` turns a block's
sums into an output row, prints it and pushes it to the HDF5 file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.ops import greens

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


def energy_estimator(ham, trial):
    """Batched ``(ga, gb) -> (etot, e1b, e2b)`` local energy from the two
    spins' ``SpinGreens``: Hubbard from G, Generic from Ghalf (the
    half-rotated Cholesky energy; its exact-ERI, PNO, stochastic-RI and
    multi-determinant variants are not ported)."""
    if ham.name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga.G, gb.G)
    if ham.name == "Generic":
        return lambda ga, gb: le.local_energy_generic_opt(
            trial, ga.Ghalf, gb.Ghalf, ham.ecore)
    raise NotImplementedError(
        f"no ported local energy for system {ham.name!r}")


def energy_estimator_G(ham):
    """Dense-G local energy ``(Ga, Gb) -> (etot, e1b, e2b)`` (the thermal
    measurement's): Hubbard and UEG; the Generic dense-G energy is not
    ported."""
    if ham.name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga, gb)
    if ham.name == "UEG":
        return lambda ga, gb: le.local_energy_ueg(ham, ga, gb)
    raise NotImplementedError(
        f"no ported dense-G energy kernel for {ham.name!r}")


def update(ham, trial, state, eval_energy: bool,
           free_projection: bool = False) -> torch.Tensor:
    """One step's contribution to the block accumulator, [NACC] complex, in
    the order UWEIGHT, WEIGHT, ENUMER, EDENOM, E1B, E2B, EHYB, OVLP. The
    energy terms are zero unless ``eval_energy``."""
    if free_projection:
        raise NotImplementedError(
            "the free-projection mixed estimator is not ported yet")
    cdtype = state.log_ovlp.dtype
    wfac = state.weight.to(cdtype)
    zero = torch.zeros((), dtype=cdtype, device=wfac.device)
    enumer = edenom = e1b = e2b = zero
    if eval_energy:
        want_g = ham.name != "Generic"
        ga = greens.greens_function(state.phia, trial.psia, want_g)
        gb = greens.greens_function(state.phib, trial.psib, want_g)
        etot, ke, pe = energy_estimator(ham, trial)(ga, gb)
        enumer = torch.sum(wfac * etot.real)
        edenom = torch.sum(wfac)
        e1b = torch.sum(wfac * ke.real)
        e2b = torch.sum(wfac * pe.real)
    acc = [None] * NACC
    acc[UWEIGHT] = torch.sum(state.unscaled_weight).to(cdtype)
    acc[WEIGHT] = torch.sum(wfac)
    acc[ENUMER] = enumer
    acc[EDENOM] = edenom
    acc[E1B] = e1b
    acc[E2B] = e2b
    acc[EHYB] = torch.sum(wfac * state.hybrid_energy)
    acc[OVLP] = torch.sum(state.weight * torch.exp(state.log_ovlp.real)
                          ).to(cdtype)
    return torch.stack(acc)


class MixedReporter:
    """Block normalization, stdout table and HDF5 push."""

    def __init__(self, nsteps: int, output=None, verbose: bool = True):
        self.nsteps = nsteps
        self.output = output
        self.verbose = verbose
        self._t0 = time.time()
        self.eshift_hybrid = 0.0
        self.eshift_proj = 0.0

    def print_header(self):
        if self.verbose:
            print("".join(f"{h:>17s}" for h in HEADER))

    def block_row(self, step: int, acc: np.ndarray) -> np.ndarray:
        """Normalize a summed block accumulator [NACC] into an output row."""
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
            self.output.increment()
        return row

    def get_shift(self, hybrid: bool = True) -> float:
        """New eshift after a block."""
        e = self.eshift_hybrid if hybrid else self.eshift_proj
        return float(np.real(e))
