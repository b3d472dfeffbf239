"""Zero-temperature AFQMC driver (the supported subset).

Counterpart of ``pauxy_tpu/qmc/afqmc.py``. Two blocks, each the JAX
package's counterpart:

* ``hubbard_fast.run_block_lanes``, the lanes fast block, for the
  configurations ``hubbard_fast.eligible`` covers (Hubbard continuous-HS
  hybrid phaseless);
* ``run_block`` below, the generic [w, M, n] block, for the discrete-HS
  (Hirsch) propagator (constrained-path CPMC) and for the Generic
  ab-initio continuous-HS hybrid phaseless propagator.

Block boundaries touch the host for the output row, the HDF5 push and the
eshift update. Any other configuration raises ``NotImplementedError``.
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
from pauxy_tpu_torch.propagation.continuous import Continuous, is_single_det
from pauxy_tpu_torch.propagation.generic import (GenericContinuous,
                                                 make_generic_continuous)
from pauxy_tpu_torch.propagation.hirsch import Hirsch, make_hirsch
from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
from pauxy_tpu_torch.qmc import hubbard_fast
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils.io import H5EstimatorHelper, create_estimates_file
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.walkers.state import init_walkers, orthogonalise

# Full float32 products everywhere (no TF32), as in the JAX driver.
config.set_matmul_precision()


def check_population_alive(weight: torch.Tensor, hint: str):
    """Raise when the population's total |weight| has vanished."""
    total = float(weight.abs().sum())
    if total < 1e-8:
        raise RuntimeError(
            f"Total weight is {total:13.8e}: the walker population died. "
            f"Something is seriously wrong — {hint}."
        )


def run_block(ham, trial, prop, state, generator, eshift: float,
              step0: int, *, nsteps: int, nstblz: int, npop_control: int,
              pop_method: str, target_weight: float, energy_eval_freq: int,
              noise: BlockNoise | None = None):
    """Advance ``state`` by one phaseless block of ``nsteps`` steps in the
    [w, M, n] layout, in the JAX step order
    (``pauxy_tpu/qmc/afqmc.py:117-156``): re-orthogonalise on
    ``step % nstblz == 0`` before propagating; propagate; cap weights at
    10% of the total weight from step 2 on;
    population control on ``step % npop_control == 0``; the mixed
    estimator, with energies on ``step % energy_eval_freq == 0``.

    Returns (state, accumulator [2, NACC] real: the block sums' real and
    imaginary parts). Draws come from ``generator`` unless ``noise`` is
    given (``noise.xi[i]`` is step i's propagator draw: the site sweep's
    uniforms [M, w], or the Generic HS fields [w, X]).
    """
    accs = []
    for i in range(nsteps):
        step = step0 + 1 + i
        if step % nstblz == 0:
            state = orthogonalise(state)
        state = prop.propagate(trial, state, generator, eshift,
                               None if noise is None else noise.xi[i])
        if step > 1:
            cap = 0.10 * state.total_weight
            state = dataclasses.replace(
                state, weight=torch.where(state.weight.abs() > cap, cap,
                                          state.weight))
        if step % npop_control == 0:
            state = pc.pop_control(
                state, target_weight, pop_method,
                uniforms=None if noise is None else noise.pop[i],
                generator=generator)
        accs.append(mixed.update(ham, trial, state,
                                 step % energy_eval_freq == 0))
    s = torch.stack(accs).sum(dim=0)
    return state, torch.stack([s.real, s.imag])


class AFQMC:
    """Zero-temperature AFQMC simulation on ``device``.

    The trial fixes the precision; ``ham`` and ``trial`` are moved to
    ``device``. With ``filename`` the block rows go to an HDF5 file in the
    JAX package's layout; without it nothing is written.
    """

    def __init__(self, ham, trial, qmc: QMCOpts,
                 propagator_options: dict | None = None,
                 estimator_options: dict | None = None,
                 verbose: bool = False, filename: str | None = None, *,
                 device=None):
        self.device = config.resolve_device(device)
        self.uuid = str(uuid.uuid1())
        self.ham = ham.to(self.device)
        self.trial = trial.to(self.device)
        self.qmc = qmc
        self.verbose = verbose
        popts = dict(propagator_options or {})
        eopts = dict(estimator_options or {})
        self.matmul_precision = config.check_matmul_precision(
            popts.get("matmul_precision"))
        self.free_projection = popts.get("free_projection", False)
        self.hybrid = popts.get("hybrid", True)
        self.prop = self._build_propagator(popts)
        # The discrete propagator reports the projected energy as the
        # shift during equilibration (its hybrid is False), as in JAX.
        self.hybrid = getattr(self.prop, "hybrid", self.hybrid)
        mixed_opts = eopts.get("mixed", {})
        self.energy_eval_freq = mixed_opts.get("energy_eval_freq", qmc.nsteps)
        extras = dict(
            nbp=eopts.get("back_propagation",
                          eopts.get("back_propagated")) is not None,
            nitcf=eopts.get("itcf") is not None,
            calc_one_rdm=bool(mixed_opts.get("one_rdm", False)),
            calc_two_rdm=mixed_opts.get("two_rdm") is not None,
        )
        self.use_fast_block = hubbard_fast.eligible(
            self.ham, self.trial, self.prop,
            free_projection=self.free_projection,
            pop_method=qmc.pop_control_method, **extras,
        )
        generic_prop = isinstance(self.prop, Hirsch) or (
            isinstance(self.prop, Continuous)
            and isinstance(self.prop.inner, GenericContinuous)
            and self.prop.hybrid and not self.prop.free_projection
            and not self.prop.stochastic_ri and is_single_det(self.trial))
        generic = (generic_prop and not any(extras.values())
                   and qmc.pop_control_method in ("comb", "pair_branch"))
        if not (self.use_fast_block or generic):
            raise NotImplementedError(
                "this configuration is not ported yet: the port runs Hubbard "
                "continuous-HS hybrid phaseless AFQMC, discrete-HS "
                "constrained-path CPMC and Generic (Cholesky ab-initio) "
                "continuous-HS hybrid phaseless AFQMC, with a "
                "single-determinant trial, comb or pair_branch population "
                "control and the mixed energy estimator"
            )

        self.state = init_walkers(self.trial, qmc.nwalkers,
                                  total_weight=float(qmc.nwalkers))
        self.eshift = 0.0
        self.filename = filename
        output = None
        if filename is not None:
            create_estimates_file(filename, mixed.HEADER,
                                  metadata=self._metadata())
            output = H5EstimatorHelper(filename, "basic")
        self.reporter = mixed.MixedReporter(qmc.nsteps, output=output,
                                            verbose=verbose)
        seed = qmc.rng_seed if qmc.rng_seed is not None else 7
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0
        # Wall-clock seconds of each block, ending with its host readback.
        self.block_seconds: list[float] = []

    def _build_propagator(self, popts: dict) -> Continuous | Hirsch:
        hs = popts.get("hubbard_stratonovich", "continuous")
        if self.ham.name not in ("Hubbard", "Generic") or (
                self.ham.name == "Generic" and "discrete" in hs):
            raise NotImplementedError(
                f"no ported propagator for {self.ham.name!r} with {hs!r} HS"
            )
        if "discrete" in hs:
            return make_hirsch(
                self.ham, self.trial, self.qmc.dt,
                charge_decomposition=popts.get("charge_decomposition",
                                               False),
                free_projection=self.free_projection,
                # 'single_site_update': false is the reference's spelling
                # of the whole-lattice update.
                two_body_mode=popts.get(
                    "two_body_update",
                    "single_site" if popts.get("single_site_update", True)
                    else "direct"),
                kinetic_kspace=popts.get("kinetic_kspace", False),
                mesh=popts.get("mesh"),
                device=self.device, dtype=self.trial.psia.dtype,
            )
        if self.ham.name == "Generic":
            inner = make_generic_continuous(
                self.ham, self.trial, self.qmc.dt,
                taylor_impl=popts.get("taylor_impl"),
                device=self.device, dtype=self.trial.psia.dtype,
            )
        else:
            inner = make_hubbard_continuous(
                self.ham, self.trial, self.qmc.dt,
                charge_decomposition=popts.get("charge_decomposition", True),
                device=self.device, dtype=self.trial.psia.dtype,
            )
        return Continuous(
            inner=inner,
            dt=self.qmc.dt,
            free_projection=self.free_projection,
            hybrid=self.hybrid,
            force_bias=popts.get("force_bias", not self.free_projection),
            stochastic_ri=popts.get("stochastic_ri", False),
            ri_nsamples=int(popts.get("nsamples", 20)),
        )

    def _metadata(self) -> dict:
        q = self.qmc
        return {
            "uuid": self.uuid,
            "sys_info": {
                "hostname": platform.node(),
                "python": sys.version.split()[0],
                "numpy": np.__version__,
                "torch": torch.__version__,
                "device": str(self.device),
            },
            "system": {"name": self.ham.name, "nup": self.ham.nup,
                       "ndown": self.ham.ndown, "nbasis": self.ham.nbasis},
            "qmc": {"nwalkers": q.nwalkers, "dt": q.dt, "nsteps": q.nsteps,
                    "nblocks": q.nblocks, "nstblz": q.nstblz,
                    "npop_control": q.npop_control, "rng_seed": q.rng_seed},
            "trial": {"name": self.trial.name, "etrial": self.trial.etrial},
            "propagators": {"free_projection": self.free_projection,
                            "hybrid": self.hybrid},
            "estimators": {
                "mixed": {"energy_eval_freq": self.energy_eval_freq},
                "estimators": {"back_prop": {"splits": [[0]]}},
            },
        }

    def run_block(self) -> np.ndarray:
        """Advance one block (nsteps), report, and update eshift."""
        t0 = time.perf_counter()
        block = (hubbard_fast.run_block_lanes if self.use_fast_block
                 else run_block)
        self.state, acc = block(
            self.ham, self.trial, self.prop, self.state, self.generator,
            self.eshift, self.step,
            nsteps=self.qmc.nsteps,
            nstblz=self.qmc.nstblz,
            npop_control=self.qmc.npop_control,
            pop_method=self.qmc.pop_control_method,
            target_weight=float(self.qmc.nwalkers),
            energy_eval_freq=self.energy_eval_freq,
        )
        acc = acc.cpu().numpy()
        self.block_seconds.append(time.perf_counter() - t0)
        self.step += self.qmc.nsteps
        row = self.reporter.block_row(self.step, acc[0] + 1j * acc[1])
        if self.step < self.qmc.neqlb:
            self.eshift = self.reporter.get_shift(self.hybrid)
        else:
            self.eshift = self.reporter.get_shift()
        return row

    def run(self) -> np.ndarray:
        """Run all blocks; returns the output rows [nblocks, 11] complex."""
        self.reporter.print_header()
        rows = []
        for _ in range(self.qmc.nblocks):
            rows.append(self.run_block())
            check_population_alive(self.state.weight,
                                   "reduce dt or improve the trial")
        return np.array(rows)
