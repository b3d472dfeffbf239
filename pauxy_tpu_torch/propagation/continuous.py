"""Continuous Hubbard-Stratonovich propagation settings.

Counterpart of ``Continuous`` and ``_bound_hybrid`` in
``pauxy_tpu/propagation/continuous.py``. The phaseless step itself, for the
supported configurations, is ``qmc/hubbard_fast.run_block_lanes``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Continuous:
    """Propagation configuration around the model's inner propagator."""

    inner: object
    dt: float
    free_projection: bool = False
    hybrid: bool = True
    force_bias: bool = True
    stochastic_ri: bool = False
    ri_nsamples: int = 20

    @property
    def sqrt_dt(self) -> float:
        return self.dt ** 0.5

    @property
    def ebound(self) -> float:
        """Hybrid-energy bound sqrt(2/dt)."""
        return (2.0 / self.dt) ** 0.5


def _bound_hybrid(ehyb: torch.Tensor, eshift: float, ebound: float
                  ) -> torch.Tensor:
    """Cap Re(ehyb) to eshift +/- ebound; no-op while eshift ~ 0."""
    if abs(eshift) < 1e-10:
        return ehyb
    re = ehyb.real.clamp(eshift - ebound, eshift + ebound)
    return torch.complex(re, ehyb.imag)
