"""Zero-temperature AFQMC driver (the supported subset).

Counterpart of ``pauxy_tpu/qmc/afqmc.py``. Two blocks, each the JAX
package's counterpart:

* ``hubbard_fast.run_block_lanes``, the lanes fast block, for the
  configurations ``hubbard_fast.eligible`` covers (Hubbard continuous-HS
  hybrid phaseless);
* ``run_block`` below, the generic [w, M, n] block, for everything else:
  the discrete-HS (Hirsch) propagator (constrained-path CPMC, the direct
  update, free projection; with a GHF trial its GHF sweep), the Hubbard,
  Generic, UEG (plane waves) and PW_FFT continuous-HS propagators
  (phaseless with the hybrid or the local-energy update, or free
  projection; Hubbard and Generic also with a multi-determinant trial),
  with the mixed estimator's density matrices and the back-propagated and
  ITCF estimators.

The Hubbard-Holstein model takes the generic block with its own
propagator (``propagation/hirsch_dmc``: Hirsch electron updates and DMC
phonon moves; coherent-state, Lang-Firsov or multi-coherent trials). The
Generic energy variants (exact ERIs, PNO, stochastic RI) and the
stochastic-RI one-body step run in the generic block too. Block boundaries
touch the host for the output rows, the HDF5 push and the eshift update.
Back propagation and the ITCF with a multi-determinant, GHF or
multi-coherent trial or the Hubbard-Holstein propagator, and a GHF trial
with the continuous propagator, raise ``NotImplementedError``, as in JAX.

On a walker mesh (``parallel/mesh``: ``af.state =
mesh.shard_walkers(af.state, m)`` on every rank, and for Generic
``mesh.shard_generic`` on a [walker, chol] mesh, back propagation, the
ITCF and the energy variants included) each rank runs both
blocks on its own walkers; the block sums are summed over the walker group
once a block, so every rank reports the same rows, and only rank 0 writes
the HDF5 file and the checkpoint metadata.

Each step runs inside the spans of ``utils/tracing``: ``ortho``,
``propagate``, ``pop_control`` and ``measure``, and inside them
``force_bias``, ``vhs``, ``taylor``, ``inv_logdet``, ``energy`` and
``exchange``. Off, they cost a flag test each. Under any
``torch.profiler`` profile (``profile_dir`` takes one of the whole
``run()``) they appear as ``pauxy.<name>`` ranges around the operations
they hold. With the recorder on (``tracing.enable()``) every block leaves
a record in ``tracing.blocks()``: its wall time, the host's time to issue
its last launch, and each span's calls and device and host seconds (CUDA
events, read while the next block runs, so the recorder adds no
synchronisation).
``block_mode="split"`` (or ``PAUXY_TPU_SPLIT=1``) records the driver's
blocks whatever the recorder's switch, sums the four top-level spans'
device seconds into ``af.timing`` and has ``finalise`` print JAX's
per-phase table.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
import warnings

import numpy as np
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.estimators import back_prop, mixed
from pauxy_tpu_torch.estimators import itcf as itcf_mod
from pauxy_tpu_torch.estimators.local_energy import rademacher
from pauxy_tpu_torch.models import ghf
from pauxy_tpu_torch.models import hubbard_holstein as hh
from pauxy_tpu_torch.models import multi_slater as msd
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.propagation.continuous import Continuous, is_single_det
from pauxy_tpu_torch.propagation.generic import make_generic_continuous
from pauxy_tpu_torch.propagation.hirsch import Hirsch, make_hirsch
from pauxy_tpu_torch.propagation.hirsch_dmc import HirschDMC, make_hirsch_dmc
from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
from pauxy_tpu_torch.propagation.planewave import make_planewave
from pauxy_tpu_torch.propagation.pw_fft import make_pw_fft_inner
from pauxy_tpu_torch.qmc import hubbard_fast
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.qmc.options import QMCOpts
from pauxy_tpu_torch.utils import tracing
from pauxy_tpu_torch.utils.io import (H5EstimatorHelper,
                                      create_estimates_file, get_sys_info)
from pauxy_tpu_torch.utils.tracing import span
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.walkers.state import init_walkers, orthogonalise


def check_population_alive(weight: torch.Tensor, hint: str):
    """Raise when the population's total |weight| (over the walker group on
    a mesh) has vanished."""
    total = float(pmesh.walker_sum(weight.abs().sum()))
    if total < 1e-8:
        raise RuntimeError(
            f"Total weight is {total:13.8e}: the walker population died. "
            f"Something is seriously wrong — {hint}."
        )


# The split table's phases: af.timing's key and the span it reads.
SPLIT_PHASES = (("ortho", "ortho"), ("prop", "propagate"),
                ("pop", "pop_control"), ("estim", "measure"))


@dataclasses.dataclass(frozen=True)
class Extras:
    """Back-propagation and ITCF settings of a block (all off by default).

    ``nbp`` steps of back propagation measured at ``bp_nsplit`` split
    points; ``nitcf`` slices of ITCF; ``nprop_tot`` the length of the
    shared field buffer (``nbp``, or ``nitcf`` + the ITCF equilibration).
    """

    nbp: int = 0
    bp_nsplit: int = 1
    bp_restore: str | None = None
    bp_two_rdm: str | None = None
    bp_eval_energy: bool = False
    bp_eval_ekt: bool = False
    nprop_tot: int = 0
    nitcf: int = 0
    itcf_stable: bool = True
    itcf_restore: bool = True
    itcf_stack_size: int = 1

    @property
    def nhist(self) -> int:
        return self.nprop_tot or self.nbp

    @property
    def splits(self) -> tuple:
        return tuple((i + 1) * (self.nbp // self.bp_nsplit)
                     for i in range(self.bp_nsplit))


def _reset(state, old: str):
    """The history after a measurement: the current walkers become the
    snapshot ``phia_<old>``/``phib_<old>`` and the factors restart at 1."""
    return dataclasses.replace(
        state, **{f"phia_{old}": state.phia, f"phib_{old}": state.phib},
        cos_fac=torch.ones_like(state.cos_fac),
        weight_fac=torch.ones_like(state.weight_fac))


def run_block(ham, trial, prop, state, generator, eshift: float,
              step0: int, *, nsteps: int, nstblz: int, npop_control: int,
              pop_method: str, target_weight: float, energy_eval_freq: int,
              free_projection: bool = False, calc_one_rdm: bool = False,
              calc_two_rdm: str | None = None, extras: Extras = Extras(),
              noise: BlockNoise | None = None):
    """Advance ``state`` by one block of ``nsteps`` steps in the
    [w, M, n] layout, in the JAX step order
    (``pauxy_tpu/qmc/afqmc.py:117-228``): re-orthogonalise on
    ``step % nstblz == 0`` before propagating; propagate (the shifted
    fields into buffer slot ``(step - 1) % nhist``); cap weights at 10% of
    the total weight from step 2 on; population control on
    ``step % npop_control == 0``; the mixed estimator, with energies on
    ``step % energy_eval_freq == 0``; a back-propagation measurement when
    the buffer count ``(step - 1) % nhist + 1`` reaches a split point, and
    the history reset after the last split; the ITCF measurement and its
    snapshot reset on ``step % nhist == 0``. With ``calc_one_rdm`` /
    ``calc_two_rdm`` the mixed accumulator carries the density-matrix tail.

    Returns (state, mixed, bp, itcf): each accumulator [2, n] real, the
    block sums' real and imaginary parts (n = 0 for an estimator that is
    off). Draws come from ``generator`` unless ``noise`` is given
    (``noise.xi[i]`` is step i's propagator draw: the site sweep's
    uniforms [M, w] (the GHF sweep's too), the direct update's uniforms
    [w, M], discrete free projection's field bits [w, M], the
    continuous HS fields [w, X], with stochastic RI a
    ``continuous.RIDraws``, for Hubbard-Holstein a ``hirsch_dmc.DMCDraws``;
    ``noise.est[i]`` the stochastic-RI energy's probes [X, S]).
    On a walker mesh the block sums are summed over the walker group.
    Each step's phases are the spans ``ortho``, ``propagate`` (the step and
    the weight cap), ``pop_control`` and ``measure`` (``utils/tracing``).
    """
    discrete = isinstance(prop, Hirsch)
    nhist = extras.nhist
    energy_fn = None
    if extras.bp_eval_energy:
        energy_fn = mixed.energy_estimator_G(ham)
    cdtype = state.log_ovlp.dtype
    m = state.nbasis
    nacc_bp = (back_prop.bp_acc_size(ham, extras.bp_two_rdm,
                                     extras.bp_eval_ekt) if extras.nbp else 0)
    accs = []
    bp_acc = torch.zeros(nacc_bp * extras.bp_nsplit, dtype=cdtype,
                         device=state.weight.device)
    itcf_acc = torch.zeros(
        itcf_mod.itcf_acc_size(m, extras.nitcf, extras.itcf_stack_size)
        if extras.nitcf else 0, dtype=cdtype, device=state.weight.device)
    for i in range(nsteps):
        step = step0 + 1 + i
        if step % nstblz == 0:
            with span("ortho"):
                state = orthogonalise(state, free_projection)
        with span("propagate"):
            state = prop.propagate(trial, state, generator, eshift,
                                   None if noise is None else noise.xi[i],
                                   bp_ix=(step - 1) % nhist if nhist
                                   else None, ham=ham)
            if step > 1:
                cap = 0.10 * state.total_weight
                state = dataclasses.replace(
                    state, weight=torch.where(state.weight.abs() > cap, cap,
                                              state.weight))
        if step % npop_control == 0:
            with span("pop_control"):
                state = pc.pop_control(
                    state, target_weight, pop_method,
                    uniforms=None if noise is None else noise.pop[i],
                    generator=generator)
        with span("measure"):
            eval_energy = step % energy_eval_freq == 0
            ri_theta = None
            if eval_energy and getattr(ham, "stochastic_ri", False):
                # On a [walker, chol] mesh every rank draws the whole [X, S]
                # and keeps its X rows (ham.nchol is the local slice's).
                ri_theta = (noise.est[i] if noise is not None
                            and noise.est is not None
                            else pmesh.draw_shared(
                                lambda shape: rademacher(
                                    shape, state.weight.dtype, generator,
                                    state.weight.device),
                                (ham.nchol, ham.nsamples), chol_dim=0))
            accs.append(mixed.update(ham, trial, state, eval_energy,
                                     free_projection, calc_one_rdm,
                                     calc_two_rdm, ri_theta))
            if extras.nbp:
                buffcount = (step - 1) % nhist + 1
                for k, s in enumerate(extras.splits):
                    if buffcount == s:
                        part = slice(k * nacc_bp, (k + 1) * nacc_bp)
                        bp_acc[part] += back_prop.update(
                            ham, trial, prop, state, energy_fn,
                            nstblz=nstblz, restore_weights=extras.bp_restore,
                            discrete=discrete, eval_ekt=extras.bp_eval_ekt,
                            nbp_len=s, calc_two_rdm=extras.bp_two_rdm)
                if buffcount == extras.splits[-1]:
                    state = _reset(state, "old")
            if extras.nitcf and step % nhist == 0:
                itcf_acc += itcf_mod.measure(
                    prop, trial, state, nmax=extras.nitcf, nstblz=nstblz,
                    stable=extras.itcf_stable,
                    restore_weights=extras.itcf_restore, discrete=discrete,
                    stack_size=extras.itcf_stack_size)
                state = _reset(state, "right")
    s = torch.stack(accs).sum(dim=0)
    if pmesh.active_mesh() is not None:
        ns, nb = s.shape[0], bp_acc.shape[0]
        tot = pmesh.walker_sum(torch.cat([s, bp_acc, itcf_acc]))
        s, bp_acc, itcf_acc = tot[:ns], tot[ns:ns + nb], tot[ns + nb:]
    return (state, torch.stack([s.real, s.imag]),
            torch.stack([bp_acc.real, bp_acc.imag]),
            torch.stack([itcf_acc.real, itcf_acc.imag]))


class AFQMC:
    """Zero-temperature AFQMC simulation on ``device``.

    The trial fixes the precision; ``ham`` and ``trial`` are moved to
    ``device``. With ``filename`` the block rows go to an HDF5 file in the
    JAX package's layout; without it nothing is written.
    ``walker_options``: ``write_freq`` (every that many blocks the walkers
    go to ``write_file``, "restart.h5" by default; on a walker mesh a
    directory of shards, ``utils.checkpoint.save_walkers_sharded``) and
    ``read_file`` (start from a checkpoint file or a sharded checkpoint's
    directory: walkers, step, eshift and the generator's state). The
    positional order is JAX's. ``block_mode``: None (the default block),
    or "split" (every block recorded by ``utils/tracing`` and the phase
    table printed; also ``PAUXY_TPU_SPLIT=1``); ``profile_dir``: where
    ``run()`` writes its ``torch.profiler`` trace, which holds the step's
    ``pauxy.*`` spans.

    To record blocks without split mode, turn the recorder on
    (``from pauxy_tpu_torch.utils import tracing; tracing.enable()``) and
    read ``tracing.blocks()``: a record a block, with ``steps``,
    ``wall_s`` (the value ``block_seconds`` gets), ``host_issue_s`` (block
    start to the last launch issued), ``profiled`` and, per span name, its
    ``calls``, ``device_s`` and ``host_s``. In split mode ``timing`` sums
    the four top-level spans over the blocks.
    """

    def __init__(self, ham, trial, qmc: QMCOpts,
                 propagator_options: dict | None = None,
                 estimator_options: dict | None = None,
                 walker_options: dict | None = None,
                 verbose: bool = False, filename: str | None = None, *,
                 device=None, block_mode: str | None = None,
                 profile_dir: str | None = None):
        # A fresh driver starts unsharded: drop a mesh a previous run
        # registered (shard_walkers registers it again).
        pmesh.set_active_mesh(None)
        self._t_init = time.perf_counter()
        self.block_mode = block_mode or (
            "split" if os.environ.get("PAUXY_TPU_SPLIT") == "1" else "fused")
        if self.block_mode not in ("fused", "split"):
            raise ValueError(f"block_mode {block_mode!r}, want 'fused' or "
                             "'split'")
        self.profile_dir = profile_dir
        self.device = config.resolve_device(device)
        self.uuid = str(uuid.uuid1())
        self.ham = ham.to(self.device)
        self.trial = trial.to(self.device)
        self.qmc = qmc
        self.verbose = verbose
        popts = dict(propagator_options or {})
        eopts = dict(estimator_options or {})
        # The tier of float32 products, set when the driver is built (a
        # process-wide setting, as JAX's): "float32" is IEEE; the lower
        # tiers are the opt-in speed ladder.
        self.matmul_precision = config.set_matmul_precision(
            popts.get("matmul_precision"), self.device)
        self.free_projection = popts.get("free_projection", False)
        self.hybrid = popts.get("hybrid", True)
        self.prop = self._build_propagator(popts)
        # The discrete propagator reports the projected energy as the
        # shift during equilibration (its hybrid is False), as in JAX.
        self.hybrid = getattr(self.prop, "hybrid", self.hybrid)
        mixed_opts = eopts.get("mixed", {})
        self.energy_eval_freq = mixed_opts.get("energy_eval_freq", qmc.nsteps)
        # The mixed estimator's density matrices: the 1-RDM [2, M, M] and
        # the UEG's structure factor [2, 2, nq].
        self.calc_one_rdm = bool(mixed_opts.get("one_rdm", False))
        self.calc_two_rdm = mixed_opts.get("two_rdm", None)
        mixed.check_dms(self.ham, self.trial, self.free_projection,
                        self.calc_one_rdm, self.calc_two_rdm)
        dms_shapes = []
        if self.calc_one_rdm:
            dms_shapes.append(("one_rdm", (2, ham.nbasis, ham.nbasis)))
        if self.calc_two_rdm is not None:
            dms_shapes.append(("two_rdm", (2, 2, ham.nq)))
        bp_opts = eopts.get("back_propagation",
                            eopts.get("back_propagated"))
        itcf_opts = eopts.get("itcf")
        if (bp_opts is not None or itcf_opts is not None) and (
                not is_single_det(self.trial)
                or isinstance(self.prop, HirschDMC)):
            raise NotImplementedError(
                "back propagation and the ITCF are single-determinant only "
                "(no multi-determinant, GHF or multi-coherent trial) and "
                "not for the Hubbard-Holstein propagator")
        self.extras = self._extras(bp_opts, itcf_opts)
        if qmc.pop_control_method not in ("comb", "pair_branch"):
            raise ValueError(f"unknown population control method "
                             f"{qmc.pop_control_method!r}")
        # The lanes block where it is eligible; PAUXY_TPU_FAST=0 opts out,
        # as in JAX.
        self.use_fast_block = (
            os.environ.get("PAUXY_TPU_FAST", "1") != "0"
            and hubbard_fast.eligible(
                self.ham, self.trial, self.prop,
                free_projection=self.free_projection,
                pop_method=qmc.pop_control_method, nbp=self.extras.nbp,
                nitcf=self.extras.nitcf, calc_one_rdm=self.calc_one_rdm,
                calc_two_rdm=self.calc_two_rdm,
            ))

        ex = self.extras
        seed = qmc.rng_seed if qmc.rng_seed is not None else 7
        # The phonon coordinates' first draw has a seed of its own, as in
        # JAX (seed + 1000003).
        phonon_mw = phonon_gen = None
        if hh.carries_phonons(self.trial):
            phonon_mw = self.ham.m * self.ham.w0
            phonon_gen = torch.Generator(device=self.device)
            phonon_gen.manual_seed(seed + 1000003)
        self.state = init_walkers(
            self.trial, qmc.nwalkers, total_weight=float(qmc.nwalkers),
            nprop_tot=ex.nhist or None,
            nfields=self.ham.nfields if ex.nhist else None,
            itcf=bool(ex.nitcf), phonon_mw=phonon_mw, generator=phonon_gen)
        self.eshift = 0.0
        self.filename = filename
        output = None
        # Only rank 0 prints and writes the estimates file.
        if not pmesh.is_rank0():
            self.verbose = verbose = False
            filename = None
        if filename is not None:
            create_estimates_file(filename, mixed.HEADER,
                                  metadata=self._metadata())
            output = H5EstimatorHelper(filename, "basic")
        self.reporter = mixed.MixedReporter(qmc.nsteps, output=output,
                                            verbose=verbose,
                                            dms_shapes=dms_shapes)
        self.bp_reporter = self.itcf_reporter = None
        if ex.nbp:
            self.bp_reporter = back_prop.BPReporter(
                None if filename is None
                else H5EstimatorHelper(filename, "back_propagated"),
                ex.nbp, ex.bp_eval_energy, nsplit=ex.bp_nsplit,
                two_rdm_shape=self._two_rdm_shape(ex.bp_two_rdm))
        if ex.nitcf:
            kdims = None
            if itcf_opts.get("kspace", False) and hasattr(self.ham, "nx"):
                kdims = (self.ham.nx, self.ham.ny)
            self.itcf_reporter = itcf_mod.ITCFReporter(
                None if filename is None
                else H5EstimatorHelper(filename, "itcf"),
                kspace_dims=kdims, mode=itcf_opts.get("mode", "full"))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0
        # Wall-clock seconds of each block, ending with its host readback.
        self.block_seconds: list[float] = []
        wopts = dict(walker_options or {})
        self.write_freq = int(wopts.get("write_freq", 0) or 0)
        self.write_file = wopts.get("write_file", "restart.h5")
        read_file = wopts.get("read_file")
        if read_file is not None:
            self._restart(read_file)
        # Seconds per phase (split mode), summed over the run.
        self.timing = {"setup": time.perf_counter() - self._t_init,
                       "block": 0.0, "ortho": 0.0, "prop": 0.0, "pop": 0.0,
                       "estim": 0.0}

    def _restart(self, read_file: str):
        """Continue from a checkpoint (a file, or a sharded checkpoint's
        directory, read whole or, on the active mesh, this rank's shard):
        the walkers, the step, eshift and, when the file holds this
        device's generator state, the stream."""
        from pauxy_tpu_torch.utils.checkpoint import (load_walkers,
                                                      load_walkers_sharded)

        if os.path.isdir(read_file):
            self.state, info = load_walkers_sharded(
                self.state, read_file, mesh=pmesh.active_mesh())
        else:
            self.state, info = load_walkers(self.state, read_file)
        self.step = info["step"]
        self.eshift = info["eshift"]
        rng = info["rng_state"]
        if rng is not None and rng.numel() == \
                self.generator.get_state().numel():
            self.generator.set_state(rng)
        else:
            warnings.warn(
                f"{read_file} holds no generator state for this device (a "
                "JAX key or none): the random stream starts afresh from "
                "rng_seed", stacklevel=3)
        if self.verbose:
            print(f"# Restarted {self.state.nwalkers} walkers from "
                  f"{read_file} at step {self.step}.")

    def _two_rdm_shape(self, two_rdm: str | None):
        """The back-propagated 2-RDM tail's shape in the output: the
        spin-summed [M]^4, or the UEG's S(k) blocks [2, 2, nq]."""
        if two_rdm == "full":
            return (self.ham.nbasis,) * 4
        if two_rdm == "structure_factor":
            return (2, 2, self.ham.nq)
        return None

    def _extras(self, bp_opts: dict | None, itcf_opts: dict | None
                ) -> Extras:
        """Back-propagation and ITCF settings from the estimator options,
        with the JAX driver's checks: ``nsplit`` divides tau_bp / dt,
        ``stack_size`` divides tau_max / dt, and with both on the shared
        field buffer needs tau_bp = tau_max + tau_eqlb."""
        dt = self.qmc.dt
        kw = {}
        nprop_tot = None
        if bp_opts is not None:
            nbp = int(round(bp_opts.get("tau_bp", 0) / dt))
            nsplit = int(bp_opts.get("nsplit", 1))
            if nbp % nsplit:
                raise ValueError("nsplit must divide tau_bp/dt")
            kw.update(nbp=nbp, bp_nsplit=nsplit,
                      bp_restore=bp_opts.get("restore_weights", None),
                      bp_two_rdm=bp_opts.get("two_rdm", None),
                      bp_eval_energy=bp_opts.get("evaluate_energy", True),
                      bp_eval_ekt=bp_opts.get("evaluate_ekt", False))
            back_prop.bp_two_rdm_size(self.ham, kw["bp_two_rdm"])
            nprop_tot = nbp
        if itcf_opts is not None:
            nitcf = int(round(itcf_opts.get("tau_max", 0) / dt))
            neqlb = int(round(itcf_opts.get("tau_eqlb", 0) / dt))
            stack_size = int(itcf_opts.get("stack_size", 1))
            if nitcf % stack_size:
                raise ValueError("itcf stack_size must divide tau_max/dt")
            if nprop_tot is not None and nprop_tot != nitcf + neqlb:
                raise ValueError(
                    "with both BP and ITCF enabled, tau_bp must equal "
                    "tau_max + tau_eqlb (shared field-config buffer)")
            kw.update(nitcf=nitcf,
                      itcf_stable=itcf_opts.get("stable", True),
                      itcf_restore=itcf_opts.get("restore_weights", True),
                      itcf_stack_size=stack_size)
            nprop_tot = nitcf + neqlb
        return Extras(nprop_tot=nprop_tot or 0, **kw)

    def _build_propagator(self, popts: dict
                          ) -> Continuous | Hirsch | HirschDMC:
        hs = popts.get("hubbard_stratonovich", "continuous")
        if self.ham.name == "HubbardHolstein":
            return make_hirsch_dmc(
                self.ham, self.trial, self.qmc.dt,
                lang_firsov=popts.get("lang_firsov", False),
                symmetric_trotter=popts.get("symmetric_trotter", False),
                device=self.device, dtype=self.trial.inita.dtype)
        if isinstance(self.trial, ghf.GHFTrial) and "discrete" not in hs:
            # As in JAX: a GHF trial pairs with the discrete propagator.
            raise NotImplementedError(
                "GHF trials require hubbard_stratonovich='discrete'")
        if self.ham.name not in ("Hubbard", "Generic", "UEG", "PW_FFT") or (
                self.ham.name != "Hubbard" and "discrete" in hs):
            raise NotImplementedError(
                f"no ported propagator for {self.ham.name!r} with {hs!r} HS"
            )
        if isinstance(self.trial, msd.MultiSlaterTrial) and (
                "discrete" in hs or self.ham.name not in ("Hubbard",
                                                          "Generic")):
            raise NotImplementedError(
                "multi-determinant trials run with the continuous Hubbard "
                "and Generic propagators only")
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
                device=self.device, dtype=self.trial.inita.dtype,
            )
        dev = dict(device=self.device, dtype=self.trial.inita.dtype)
        if self.ham.name == "Generic":
            inner = make_generic_continuous(
                self.ham, self.trial, self.qmc.dt,
                taylor_impl=popts.get("taylor_impl"), **dev)
        elif self.ham.name == "UEG":
            # As in JAX, no taylor_impl is passed: PAUXY_TPU_TAYLOR_UEG.
            inner = make_planewave(self.ham, self.trial, self.qmc.dt, **dev)
        elif self.ham.name == "PW_FFT":
            inner = make_pw_fft_inner(
                self.ham, self.trial, self.qmc.dt,
                exp_order=popts.get("expansion_order", 6), **dev)
        else:
            inner = make_hubbard_continuous(
                self.ham, self.trial, self.qmc.dt,
                charge_decomposition=popts.get("charge_decomposition", True),
                device=self.device, dtype=self.trial.inita.dtype,
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
            "sys_info": get_sys_info(),
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
                "estimators": {"back_prop": {"splits": [
                    list(self.extras.splits) if self.extras.nbp else [0]]}},
            },
        }

    def run_block(self, noise: BlockNoise | None = None) -> np.ndarray:
        """Advance one block (nsteps), report, and update eshift. Draws
        come from the driver's generator unless ``noise`` is given (see
        ``run_block`` and ``hubbard_fast.run_block_lanes``). The block is
        recorded (``utils/tracing``) in split mode or with the recorder
        on."""
        t0 = time.perf_counter()
        kw = dict(nsteps=self.qmc.nsteps, nstblz=self.qmc.nstblz,
                  npop_control=self.qmc.npop_control,
                  pop_method=self.qmc.pop_control_method,
                  target_weight=float(self.qmc.nwalkers),
                  energy_eval_freq=self.energy_eval_freq)
        with tracing.block(self.state.weight.device, self.qmc.nsteps, t0,
                           always=self.block_mode == "split") as blk:
            if self.use_fast_block:
                self.state, acc = hubbard_fast.run_block_lanes(
                    self.ham, self.trial, self.prop, self.state,
                    self.generator, self.eshift, self.step, noise=noise,
                    **kw)
                bp_acc = itcf_acc = None
            else:
                self.state, acc, bp_acc, itcf_acc = run_block(
                    self.ham, self.trial, self.prop, self.state,
                    self.generator, self.eshift, self.step,
                    free_projection=self.free_projection,
                    calc_one_rdm=self.calc_one_rdm,
                    calc_two_rdm=self.calc_two_rdm, extras=self.extras,
                    noise=noise, **kw)
            blk.issued()
            acc = acc.cpu().numpy()
            self.block_seconds.append(time.perf_counter() - t0)
            blk.end(self.block_seconds[-1])
        self.timing["block"] += self.block_seconds[-1]
        if self.block_mode == "split":
            spans = blk.record["spans"]
            for key, name in SPLIT_PHASES:
                if name in spans:
                    self.timing[key] += spans[name]["device_s"]
        self.step += self.qmc.nsteps
        row = self.reporter.block_row(self.step, acc[0] + 1j * acc[1])
        if self.bp_reporter is not None:
            a = bp_acc.cpu().numpy()
            self.bp_reporter.block_row(a[0] + 1j * a[1], self.ham.nbasis)
        if self.itcf_reporter is not None:
            a = itcf_acc.cpu().numpy()
            self.itcf_reporter.block_row(
                a[0] + 1j * a[1], self.ham.nbasis,
                self.extras.nitcf // self.extras.itcf_stack_size)
        if self.step < self.qmc.neqlb:
            self.eshift = self.reporter.get_shift(self.hybrid)
        else:
            self.eshift = self.reporter.get_shift()
        if self.write_freq and (
                self.step // self.qmc.nsteps) % self.write_freq == 0:
            from pauxy_tpu_torch.utils.checkpoint import (
                save_walkers, save_walkers_sharded)

            if pmesh.active_mesh() is not None:
                save_walkers_sharded(self.state, self.write_file,
                                     generator=self.generator,
                                     step=self.step, eshift=self.eshift)
            else:
                save_walkers(self.state, self.write_file,
                             generator=self.generator, step=self.step,
                             eshift=self.eshift)
        return row

    def run(self) -> np.ndarray:
        """Run all blocks; returns the output rows [nblocks, 11] complex.
        With ``verbose`` the timing table follows; with ``profile_dir`` the
        whole run is one ``torch.profiler`` trace, written there as
        ``trace.<uuid>.json`` (Chrome trace format)."""
        self.reporter.print_header()

        def blocks():
            rows = []
            for _ in range(self.qmc.nblocks):
                rows.append(self.run_block())
                check_population_alive(self.state.weight,
                                       "reduce dt or improve the trial")
            return rows

        if self.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.state.weight.is_cuda:
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                rows = blocks()
            os.makedirs(self.profile_dir, exist_ok=True)
            rank = (f".{torch.distributed.get_rank()}"
                    if torch.distributed.is_initialized() else "")
            prof.export_chrome_trace(os.path.join(
                self.profile_dir, f"trace.{self.uuid}{rank}.json"))
        else:
            rows = blocks()
        if self.verbose:
            self.finalise()
        return np.array(rows)

    def get_energy(self, skip: int = 0):
        """Reblocked mixed-energy estimate from the output file: (mean,
        standard error), or None without a file or with too little
        data."""
        from pauxy_tpu_torch.analysis import blocking
        from pauxy_tpu_torch.analysis.extraction import \
            extract_mixed_estimates

        if self.filename is None:
            return None
        try:
            frame = extract_mixed_estimates(self.filename, skip)
            s = blocking.reblock_summary(
                np.asarray(frame.ETotal.values, dtype=complex).real)
            return float(s["mean"]), float(s["standard error"])
        except (IndexError, ValueError, KeyError):
            return None

    def get_one_rdm(self, skip: int = 0):
        """Block-averaged back-propagated 1-RDM (av, err), or the mixed
        1-RDM when back propagation is off and the mixed one_rdm is on;
        None otherwise (and without a file)."""
        from pauxy_tpu_torch.analysis import blocking

        if self.filename is None:
            return None
        try:
            if self.extras.nbp:
                return blocking.average_rdm(self.filename, skip=max(skip, 1),
                                            est_type="back_propagated",
                                            ix=self.extras.nbp)
            if self.calc_one_rdm:
                return blocking.average_rdm(self.filename, skip=max(skip, 1),
                                            est_type="basic", ix=None)
        except (IndexError, ValueError, KeyError):
            return None
        return None

    def finalise(self, verbose: bool = True):
        """Print the timing table. In split mode JAX's per-phase table
        (seconds per orthogonalisation, per step, per population control
        and per step); else set-up, then the blocks' wall times (each ends
        with its host readback)."""
        if not verbose:
            return
        if self.block_mode == "split":
            t = self.timing
            nsteps = max(self.step, 1)
            print(f"# Running time : {time.perf_counter() - self._t_init:.6f}"
                  " seconds")
            print("# Timing breakdown (per step):")
            print(f"# - Setup: {t['setup']:.6f} s")
            nstblz = max(self.step // max(self.qmc.nstblz, 1), 1)
            npcon = max(self.step // max(self.qmc.npop_control, 1), 1)
            print(f"# - Orthogonalisation: {t['ortho'] / nstblz:.6f} s")
            print(f"# - Propagation: {t['prop'] / nsteps:.6f} s")
            print(f"# - Population control: {t['pop'] / npcon:.6f} s")
            print(f"# - Estimators: {t['estim'] / nsteps:.6f} s")
            return
        secs = np.asarray(self.block_seconds)
        print(f"# Running time : {time.perf_counter() - self._t_init:.6f} "
              "seconds")
        print("# Timing breakdown (per block, wall clock):")
        print(f"# - Setup: {self.timing['setup']:.6f} s")
        if secs.size:
            nsteps = max(self.qmc.nsteps, 1)
            print(f"# - Blocks: {secs.size}, first {secs[0]:.6f} s")
            rest = secs[1:] if secs.size > 1 else secs
            print(f"# - Block: mean {rest.mean():.6f} s, min "
                  f"{rest.min():.6f} s, max {rest.max():.6f} s "
                  f"({rest.mean() / nsteps:.6f} s/step)")
