"""Mixed estimator: host-side block reporting.

Counterpart of the header, accumulator layout and ``MixedReporter`` of
``pauxy_tpu/estimators/mixed.py``. The per-step accumulation of the main
path is inside ``qmc/hubbard_fast.py``; this module turns a block's sums
into an output row, prints it and pushes it to the HDF5 file.
"""

from __future__ import annotations

import time

import numpy as np

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
