"""Finite-temperature AFQMC driver.

Counterpart of ``pauxy_tpu/qmc/thermal_afqmc.py``: the continuous
propagator (Hubbard, Generic or UEG) on the full-rank stack or the
low-rank stack (``walker_options={"low_rank": True}``, diagonal trials
only), or the discrete Hubbard propagator
(``propagator_options={"hubbard_stratonovich": "discrete"}``). Each
measurement block samples one full imaginary-time path (a Python loop over
the beta/dt slices with per-slice weight capping and population control),
then a mixed thermal measurement (energy and particle number from the
1-RDM, or with ``average_gf`` their average over every cyclic stack
origin) and a reset of the walkers to the trial density matrix.

On a walker mesh (``af.state = parallel.mesh.shard_walkers(af.state, m)``
on every rank) each rank propagates its own walkers with the slices of
the whole population's draws; the per-slice population control runs
across ranks, the measurement's sums are summed over the walker group,
the reset keeps this rank's rows, and only rank 0 writes the file.
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
from pauxy_tpu_torch.estimators import thermal as th
from pauxy_tpu_torch.estimators.thermal import one_rdm_from_G, particle_number
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.propagation.thermal import make_thermal_propagator
from pauxy_tpu_torch.propagation.thermal_discrete import make_thermal_discrete
from pauxy_tpu_torch.qmc.afqmc import check_population_alive
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils.io import H5EstimatorHelper, create_estimates_file
from pauxy_tpu_torch.walkers import low_rank as lrw
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.walkers import thermal_state as tws

THERMAL_HEADER = [
    "Iteration", "WeightFactor", "Weight", "ENumer", "EDenom", "ETotal",
    "E1Body", "E2Body", "EHybrid", "Overlap", "Nav", "Time",
]


@dataclasses.dataclass
class PathNoise:
    """Injected draws of one path: the propagator's draws xi and the
    population-control uniforms pop [nslices, k] (k = 1 for comb, w // 2
    for pair_branch); slice ts uses xi[ts] and pop[ts]. xi is
    [nslices, w, nfields] normals for the continuous propagator,
    [nslices, M, w] heat-bath uniforms for the discrete constrained path
    and [nslices, w, M] fields in {0, 1} for discrete free projection."""

    xi: torch.Tensor
    pop: torch.Tensor


def run_path(ham, trial, prop, state, generator, *, ntime_slices: int,
             npop_control: int, pop_method: str, target_weight: float,
             calc_one_rdm: bool = False, average_gf: bool = False,
             noise: PathNoise | None = None):
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
    return state, measure_state(ham, trial, state, calc_one_rdm, average_gf)


def measure_state(ham, trial, state, calc_one_rdm: bool = False,
                  average_gf: bool = False) -> torch.Tensor:
    """Mixed thermal measurement from the current Green's function: the
    energy from the 1-RDM P = 1 - G^T, EHybrid the tracked per-slice hybrid
    energy, Overlap sum w (ot = 1 at T > 0), and with ``calc_one_rdm`` the
    weighted P appended flat. With ``average_gf`` (full-rank stack) the
    same path is measured at every cyclic stack origin k, G from the stack
    rolled by -k (a copy), and the energies, particle number and P are
    averaged. Returns [2, len] (real and imaginary parts)."""
    e_fn = mixed.energy_estimator_G(ham)

    def measure(g):
        p = one_rdm_from_G(g)
        return (*e_fn(p[:, 0], p[:, 1]), particle_number(p), p)

    if average_gf:
        parts = [measure(th.greens_function_qdt(
                     torch.roll(state.stack, -k, dims=1).transpose(1, 2)))
                 for k in range(state.nbins)]
        etot, e1b, e2b, nav, p = (sum(x) / state.nbins
                                  for x in zip(*parts))
    else:
        etot, e1b, e2b, nav, p = measure(state.G)
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
    acc = pmesh.walker_sum(acc)
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
        # A fresh driver starts unsharded (shard_walkers registers a mesh).
        pmesh.set_active_mesh(None)
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
        # The tier of float32 products, set when the driver is built (a
        # process-wide setting, as JAX's): "float32" is IEEE; the lower
        # tiers are the opt-in speed ladder.
        self.matmul_precision = config.set_matmul_precision(
            popts.get("matmul_precision"), self.device)
        wopts = dict(walker_options or {})
        # The low-rank stack needs a diagonal trial density matrix.
        self.low_rank = bool(wopts.get("low_rank", False))
        if self.low_rank:
            dmat = self.trial.dmat
            if (dmat - torch.diag_embed(torch.diagonal(
                    dmat, dim1=-2, dim2=-1))).abs().max() >= 1e-10:
                raise ValueError("the low-rank stack requires a diagonal "
                                 "trial density matrix")
            popts.setdefault("low_rank", True)
            popts.setdefault("low_rank_thresh",
                             wopts.get("low_rank_thresh", 1e-6))
        if "discrete" in popts.get("hubbard_stratonovich", ""):
            self.prop = make_thermal_discrete(
                self.ham, self.trial, qmc.dt,
                charge_decomposition=popts.get("charge_decomposition",
                                               False),
                free_projection=popts.get("free_projection", False),
                mu=popts.get("mu"),
                wrap_stabilize=popts.get("wrap_stabilize", 10),
                device=self.device, dtype=self.trial.dmat.dtype)
        else:
            self.prop = make_thermal_propagator(
                self.ham, self.trial, qmc.dt, options=popts,
                device=self.device, dtype=self.trial.dmat.dtype)
        self._init_walkers = (lrw.init_low_rank_walkers if self.low_rank
                              else tws.init_thermal_walkers)
        mixed_opts = dict(estimator_options or {}).get("mixed", {})
        self.calc_one_rdm = bool(mixed_opts.get("one_rdm", False))
        self.average_gf = bool(mixed_opts.get("average_gf", False))
        if self.average_gf and self.low_rank:
            raise NotImplementedError(
                "average_gf needs the full-rank stack")
        if qmc.pop_control_method not in ("comb", "pair_branch"):
            raise ValueError(f"unknown population control method "
                             f"{qmc.pop_control_method!r}")
        self.state = self._init_walkers(self.trial, qmc.nwalkers)
        self.filename = filename
        self.output = None
        # Only rank 0 prints and writes the estimates file.
        if not pmesh.is_rank0():
            self.verbose, filename = False, None
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
            calc_one_rdm=self.calc_one_rdm, average_gf=self.average_gf,
            noise=noise)
        acc = acc.cpu()
        self.block_seconds.append(time.perf_counter() - t0)
        self.block += 1
        # Liveness before the reset (the reference's abort on sum |w|).
        check_population_alive(self.state.weight, "reduce dt or beta")
        row = self._emit_row(acc, self.block)
        self.state = self._init_walkers(self.trial, self.qmc.nwalkers)
        mesh = pmesh.active_mesh()
        if mesh is not None:
            self.state = pmesh.shard_walkers(self.state, mesh)
        return row

    def run(self) -> np.ndarray:
        """The iteration-0 row of the initial state, then one row per path;
        returns [nblocks + 1, 12] complex."""
        if self.verbose:
            print("".join(f"{h:>17s}" for h in THERMAL_HEADER))
        rows = [self._emit_row(measure_state(
            self.ham, self.trial, self.state, self.calc_one_rdm,
            self.average_gf), 0)]
        rows += [self.run_block() for _ in range(self.qmc.nblocks)]
        return np.array(rows)
