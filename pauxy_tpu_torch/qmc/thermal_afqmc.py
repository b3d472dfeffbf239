"""Finite-temperature AFQMC driver.

Counterpart of ``pauxy_tpu/qmc/thermal_afqmc.py`` for the full-rank stack
with the continuous Hubbard or UEG propagator. Each measurement block
samples one full imaginary-time path (a Python loop over the beta/dt
slices with per-slice weight capping and population control), then a
mixed thermal measurement (energy and particle number from the 1-RDM) and
a reset of the walkers to the trial density matrix. The discrete thermal
propagator, the low-rank walkers and the tau-averaged Green's function
(``average_gf``) are not ported and raise.
"""

from __future__ import annotations

import dataclasses
import platform
import sys
import time
import uuid

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import mixed
from pauxy_tpu_torch.estimators.thermal import one_rdm_from_G, particle_number
from pauxy_tpu_torch.propagation.thermal import make_thermal_propagator
from pauxy_tpu_torch.qmc.afqmc import check_population_alive
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils.io import H5EstimatorHelper, create_estimates_file
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.walkers import thermal_state as tws

# Full float32 products everywhere (no TF32), as in the JAX driver.
config.set_matmul_precision()

THERMAL_HEADER = [
    "Iteration", "WeightFactor", "Weight", "ENumer", "EDenom", "ETotal",
    "E1Body", "E2Body", "EHybrid", "Overlap", "Nav", "Time",
]


@dataclasses.dataclass
class PathNoise:
    """Injected draws of one path: the HS fields xi [nslices, w, nfields]
    and the population-control uniforms pop [nslices, k] (k = 1 for comb,
    w // 2 for pair_branch); slice ts uses xi[ts] and pop[ts]."""

    xi: torch.Tensor
    pop: torch.Tensor


def run_path(ham, trial, prop, state, generator, *, ntime_slices: int,
             npop_control: int, pop_method: str, target_weight: float,
             calc_one_rdm: bool = False, noise: PathNoise | None = None):
    """Propagate one full beta path and measure: per slice ts, propagate;
    cap weights at 10% of the total weight for ts > 0; population control
    when ts % npop_control == 0 and ts != 0. Returns (state, accumulator
    [2, NACC + 1 (+ 2 M^2)] real)."""
    for ts in range(ntime_slices):
        state = prop.propagate(trial, state, ts,
                               None if noise is None else noise.xi[ts],
                               generator)
        if ts > 0:
            cap = 0.10 * state.total_weight
            state = dataclasses.replace(
                state, weight=torch.where(state.weight.abs() > cap, cap,
                                          state.weight))
        if ts % npop_control == 0 and ts != 0:
            state = pc.pop_control(
                state, target_weight, pop_method,
                uniforms=None if noise is None else noise.pop[ts],
                generator=generator)
    return state, measure_state(ham, trial, state, calc_one_rdm)


def measure_state(ham, trial, state,
                  calc_one_rdm: bool = False) -> torch.Tensor:
    """Mixed thermal measurement from the current Green's function: the
    energy from the 1-RDM P = 1 - G^T, EHybrid the tracked per-slice hybrid
    energy, Overlap sum w (ot = 1 at T > 0), and with ``calc_one_rdm`` the
    weighted P appended flat. Returns [2, len] (real and imaginary
    parts). JAX's tau-averaged ``average_gf`` is not ported (the driver
    refuses it)."""
    e_fn = mixed.energy_estimator_G(ham)
    p = one_rdm_from_G(state.G)
    etot, e1b, e2b = e_fn(p[:, 0], p[:, 1])
    nav = particle_number(p)
    w = state.weight
    cdtype = state.G.dtype
    wsum = torch.sum(w)
    acc = torch.stack([
        torch.sum(state.unscaled_weight).to(cdtype),
        wsum.to(cdtype),
        torch.sum(w * etot.real).to(cdtype),
        wsum.to(cdtype),
        torch.sum(w * e1b.real).to(cdtype),
        torch.sum(w * e2b.real).to(cdtype),
        torch.sum(w * state.hybrid_energy).to(cdtype),
        wsum.to(cdtype),
        torch.sum(w * nav).to(cdtype),
    ])
    if calc_one_rdm:
        rdm = torch.einsum("w,wsmn->smn", w.to(cdtype), p)
        acc = torch.cat([acc, rdm.reshape(-1)])
    return torch.stack([acc.real, acc.imag])


class ThermalAFQMC:
    """Finite-temperature AFQMC simulation on ``device``. The trial fixes
    the precision; ``ham`` and ``trial`` are moved to ``device``. With
    ``filename`` the rows go to an HDF5 file in the JAX package's layout;
    without it nothing is written."""

    def __init__(self, ham, trial, qmc: QMCOpts,
                 propagator_options: dict | None = None,
                 estimator_options: dict | None = None,
                 walker_options: dict | None = None,
                 verbose: bool = False, filename: str | None = None, *,
                 device=None):
        if qmc.beta is None:
            raise ValueError("a thermal run needs qmc.beta")
        self.device = config.resolve_device(device)
        self.uuid = str(uuid.uuid1())
        self.ham = ham.to(self.device)
        self.trial = trial.to(self.device)
        self.qmc = qmc
        self.verbose = verbose
        self.ntime_slices = self.trial.num_slices
        popts = dict(propagator_options or {})
        wopts = dict(walker_options or {})
        if wopts.get("low_rank", False) or popts.get("low_rank", False):
            raise NotImplementedError("the low-rank thermal walkers are not "
                                      "ported")
        if "discrete" in popts.get("hubbard_stratonovich", ""):
            raise NotImplementedError("the discrete thermal propagator is "
                                      "not ported")
        self.prop = make_thermal_propagator(
            self.ham, self.trial, qmc.dt, options=popts, device=self.device,
            dtype=self.trial.dmat.dtype)
        mixed_opts = dict(estimator_options or {}).get("mixed", {})
        self.calc_one_rdm = bool(mixed_opts.get("one_rdm", False))
        if mixed_opts.get("average_gf", False):
            raise NotImplementedError("average_gf is not ported")
        if qmc.pop_control_method not in ("comb", "pair_branch"):
            raise ValueError(f"unknown population control method "
                             f"{qmc.pop_control_method!r}")
        self.state = tws.init_thermal_walkers(self.trial, qmc.nwalkers)
        self.filename = filename
        self.output = None
        if filename is not None:
            create_estimates_file(filename, THERMAL_HEADER,
                                  metadata=self._metadata())
            self.output = H5EstimatorHelper(filename, "basic")
        seed = qmc.rng_seed if qmc.rng_seed is not None else 7
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.block = 0
        # Wall-clock seconds of each path, ending with its host readback.
        self.block_seconds: list[float] = []
        self._t0 = time.time()

    def _metadata(self) -> dict:
        q = self.qmc
        return {
            "uuid": self.uuid,
            "sys_info": {"hostname": platform.node(),
                         "python": sys.version.split()[0],
                         "numpy": np.__version__,
                         "torch": torch.__version__,
                         "device": str(self.device)},
            "system": {"name": self.ham.name, "nbasis": self.ham.nbasis},
            "qmc": {"beta": q.beta, "dt": q.dt, "nwalkers": q.nwalkers,
                    "mu": self.trial.mu},
            "propagators": {"free_projection": self.prop.free_projection},
            "estimators": {},
        }

    def _emit_row(self, acc, iteration: int) -> np.ndarray:
        ri = acc.cpu().numpy()
        acc = ri[0] + 1j * ri[1]
        uweight, weight, enum, edenom, e1b, e2b, ehyb, ovlp = acc[:8]
        navw = acc[8]
        now = time.time()
        elapsed, self._t0 = now - self._t0, now
        # A dead block reports zeros (the driver then aborts) instead of
        # pushing a NaN row.
        denom = edenom if abs(edenom) > 0 else 1.0
        wsum = weight if abs(weight) > 0 else 1.0
        row = np.array([iteration, uweight, weight, enum, edenom,
                        enum / denom, e1b / denom, e2b / denom,
                        ehyb / wsum, ovlp / wsum, navw / denom, elapsed],
                       dtype=np.complex128)
        if self.verbose:
            print("".join(f"{v.real: 16.8e} " for v in row))
        if self.output is not None:
            self.output.push(row, "energies")
            if self.calc_one_rdm:
                m = self.ham.nbasis
                rdm = acc[9:9 + 2 * m * m].reshape(2, m, m) / denom
                self.output.push(rdm, "one_rdm")
            self.output.increment()
        return row

    def run_block(self, noise: PathNoise | None = None) -> np.ndarray:
        """One path and its row; then the reset to the trial."""
        t0 = time.perf_counter()
        self.state, acc = run_path(
            self.ham, self.trial, self.prop, self.state, self.generator,
            ntime_slices=self.ntime_slices,
            npop_control=self.qmc.npop_control,
            pop_method=self.qmc.pop_control_method,
            target_weight=float(self.qmc.nwalkers),
            calc_one_rdm=self.calc_one_rdm, noise=noise)
        acc = acc.cpu()
        self.block_seconds.append(time.perf_counter() - t0)
        self.block += 1
        # Liveness before the reset (the reference's abort on sum |w|).
        check_population_alive(self.state.weight, "reduce dt or beta")
        row = self._emit_row(acc, self.block)
        self.state = tws.init_thermal_walkers(self.trial, self.qmc.nwalkers)
        return row

    def run(self) -> np.ndarray:
        """The iteration-0 row of the initial state, then one row per path;
        returns [nblocks + 1, 12] complex."""
        if self.verbose:
            print("".join(f"{h:>17s}" for h in THERMAL_HEADER))
        rows = [self._emit_row(measure_state(self.ham, self.trial,
                                             self.state, self.calc_one_rdm),
                               0)]
        rows += [self.run_block() for _ in range(self.qmc.nblocks)]
        return np.array(rows)
