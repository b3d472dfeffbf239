"""Zero-temperature AFQMC driver (the supported subset).

Counterpart of ``pauxy_tpu/qmc/afqmc.py`` for the configurations its lanes
fast block covers (``qmc/hubbard_fast.eligible``): every block runs
``hubbard_fast.run_block_lanes``; block boundaries touch the host for the
output row, the HDF5 push and the eshift update. Any other configuration
raises ``NotImplementedError``.
"""

from __future__ import annotations

import platform
import sys
import time
import uuid

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import mixed
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
from pauxy_tpu_torch.qmc import hubbard_fast
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils.io import H5EstimatorHelper, create_estimates_file
from pauxy_tpu_torch.walkers.state import init_walkers

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


class AFQMC:
    """Zero-temperature phaseless AFQMC simulation on ``device``.

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
        self.free_projection = popts.get("free_projection", False)
        self.hybrid = popts.get("hybrid", True)
        self.prop = self._build_propagator(popts)
        mixed_opts = eopts.get("mixed", {})
        self.energy_eval_freq = mixed_opts.get("energy_eval_freq", qmc.nsteps)
        bp = eopts.get("back_propagation", eopts.get("back_propagated"))
        if not hubbard_fast.eligible(
            self.ham, self.trial, self.prop,
            free_projection=self.free_projection,
            nbp=bp is not None, nitcf=eopts.get("itcf") is not None,
            calc_one_rdm=bool(mixed_opts.get("one_rdm", False)),
            calc_two_rdm=mixed_opts.get("two_rdm") is not None,
            pop_method=qmc.pop_control_method,
        ):
            raise NotImplementedError(
                "this configuration is not ported yet: the port runs Hubbard "
                "continuous-HS hybrid phaseless AFQMC with a single-"
                "determinant trial, comb or pair_branch population control "
                "and the mixed energy estimator"
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

    def _build_propagator(self, popts: dict) -> Continuous:
        hs = popts.get("hubbard_stratonovich", "continuous")
        if self.ham.name != "Hubbard" or "discrete" in hs:
            raise NotImplementedError(
                f"no ported propagator for {self.ham.name!r} with {hs!r} HS"
            )
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
        self.state, acc = hubbard_fast.run_block_lanes(
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
