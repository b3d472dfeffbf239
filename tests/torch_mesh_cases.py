"""Scenarios of the port's walker mesh, run alike on one rank and on R.

Each ``case_*(mesh_kind, tmp)`` builds a small double-precision run of the
port on the CPU and returns its numbers (numpy arrays, equal on every
rank); with ``mesh_kind`` None it is the one-rank run, with "walker" the
walker axis is sharded over every rank of the process group, with
"walker_chol" the ranks form a [walker, 2 chol] mesh. The cases mirror
``tests/test_multidevice.py`` case by case. :func:`run_rank` is what each
rank of ``parallel.launch.run_ranks`` runs. This module imports no JAX, so
that the ranks start quickly.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.walkers import init_walkers

KW = dict(device="cpu", dtype="double")
MIXED = {"mixed": {"energy_eval_freq": 1}}


def _mesh(kind):
    if kind == "walker":
        return pmesh.walker_mesh(device="cpu")
    if kind == "walker_chol":
        return pmesh.walker_chol_mesh(2, device="cpu")
    return None


def _drive(af, kind, generic=False):
    m = _mesh(kind)
    if m is not None:
        if generic:
            af.ham, af.trial, af.prop = pmesh.shard_generic(
                af.ham, af.trial, af.prop, m)
        af.state = pmesh.shard_walkers(af.state, m)
    try:
        return np.asarray(af.run())
    finally:
        pmesh.set_active_mesh(None)


def _hub(**kw):
    return make_hubbard(3, 3, U=4.0, nx=3, ny=3, **kw, **KW)


def case_continuous(kind, tmp):
    ham = _hub(ktwist=[0.01, -0.02])
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=2, rng_seed=11)
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               estimator_options=MIXED, device="cpu")
    assert af.use_fast_block
    return _drive(af, kind)[:, 1:10].real


def case_pair_branch(kind, tmp):
    ham = _hub(ktwist=[0.01, -0.02])
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=2, rng_seed=11,
                  pop_control_method="pair_branch")
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               estimator_options=MIXED, device="cpu")
    return _drive(af, kind)[:, 1:10].real


def comb_state(nw=16, heavy=3):
    """A population tagged by phia[:, 0, 0] = walker index, all the weight
    on walker ``heavy``."""
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **KW)
    state = init_walkers(free_electron_trial(ham, **KW), nw)
    phia = state.phia.clone()
    phia[:, 0, 0] = torch.arange(nw, dtype=torch.float64).to(phia.dtype)
    w = torch.full((nw,), 1e-6, dtype=state.weight.dtype)
    w[heavy] = 1.0
    return dataclasses.replace(state, phia=phia, weight=w)


# The uniform JAX's comb draws from jax.random.key(0) in float64 (the
# tests check it), injected so that the port's comb can be held against
# JAX's.
COMB_UNIFORM = 0.41845711171638644


def case_comb_gather(kind, tmp):
    from pauxy_tpu_torch.walkers import pop_control as pc

    state = comb_state()
    m = _mesh(kind)
    if m is not None:
        state = pmesh.shard_walkers(state, m)
    try:
        out = pc.comb(state, 16.0,
                      torch.tensor(COMB_UNIFORM, dtype=torch.float64))
        tags = pmesh.gather_walkers(out.phia[:, 0, 0].real)
        weights = pmesh.gather_walkers(out.weight)
    finally:
        pmesh.set_active_mesh(None)
    return np.stack([tags.numpy(), weights.numpy()])


def _discrete(kind, tmp, twist, **popts):
    ham = _hub(ktwist=twist) if twist else _hub()
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=6, nblocks=3, nstblz=3,
                  npop_control=2, rng_seed=5)
    m = _mesh(kind)
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               propagator_options={"hubbard_stratonovich": "discrete",
                                   **popts},
               estimator_options=MIXED, device="cpu")
    if m is not None:
        af.state = pmesh.shard_walkers(af.state, m)
    try:
        route = af.prop.sweep_kernel
        return np.asarray(af.run())[:, 1:10].real, route
    finally:
        pmesh.set_active_mesh(None)


def case_discrete(kind, tmp):
    """The general complex sweep (a twisted lattice: the scan route)."""
    rows, route = _discrete(kind, tmp, [0.01, -0.02])
    assert route == "scan", route
    return rows


def case_sweep_kernel(kind, tmp):
    """The real sweep: the sweep kernel's route (its plain version on the
    CPU), with JAX's ``mesh`` propagator option on the sharded run."""
    popts = {} if kind is None else {"mesh": pmesh.walker_mesh(device="cpu")}
    rows, route = _discrete(kind, tmp, None, **popts)
    assert route == "kernel", route
    return rows


def case_free_projection(kind, tmp):
    ham = _hub(ktwist=[0.01, -0.02])
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=11)
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               propagator_options={"free_projection": True},
               estimator_options=MIXED, device="cpu")
    rows = _drive(af, kind)[:, 1:10]
    return np.stack([rows.real, rows.imag])


def case_ghf(kind, tmp):
    from pauxy_tpu_torch.models import ghf

    ham = _hub()
    fe = free_electron_trial(ham, **KW)
    trial = ghf.ghf_trial_from_uhf(ham, fe.psia.numpy(), fe.psib.numpy(),
                                   **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"hubbard_stratonovich": "discrete"},
               estimator_options=MIXED, device="cpu")
    return _drive(af, kind)[:, 1:10].real


def case_back_propagation(kind, tmp):
    ham = _hub()
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1},
                                  "back_propagation": {
                                      "tau_bp": 0.1,
                                      "evaluate_energy": True}},
               device="cpu")
    rows = _drive(af, kind)[:, 1:10].real
    bp = [np.concatenate([np.ravel(v) for _, v in sorted(r.items())])
          for r in af.bp_reporter.rows]
    return rows, np.real(np.stack(bp)), np.imag(np.stack(bp))


def case_itcf(kind, tmp):
    ham = _hub()
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1},
                                  "itcf": {"tau_max": 0.25,
                                           "stable": True}},
               device="cpu")
    rows = _drive(af, kind)[:, 1:10].real
    g = np.stack([np.asarray(r["real_space_greens_function"])
                  for r in af.itcf_reporter.rows])
    return rows, g.real


def case_kernel_dispatch(kind, tmp):
    """Kernel B (log-det, solve) and the Cholesky kernel (CholeskyQR2) on
    each rank's own walkers: the gathered results equal the one-rank
    call's."""
    from pauxy_tpu_torch.ops import clinalg

    rng = np.random.default_rng(9)
    w, n, m = 16, 5, 12
    s = torch.from_numpy(rng.normal(size=(w, n, n))
                         + 1j * rng.normal(size=(w, n, n)))
    phi = torch.from_numpy(rng.normal(size=(w, m, n))
                           + 1j * rng.normal(size=(w, m, n)))
    mesh = _mesh(kind)
    if mesh is not None:
        pmesh.set_active_mesh(mesh)
    try:
        s_l, phi_l = pmesh.local_rows(s), pmesh.local_rows(phi)
        ld = clinalg.slogdet(s_l)
        x = clinalg.solve(s_l, phi_l.transpose(-1, -2))
        q, logr = clinalg.cholesky_qr2(phi_l)
        out = [pmesh.gather_walkers(t) for t in (ld, x, q, logr)]
    finally:
        pmesh.set_active_mesh(None)
    return [np.stack([t.real.numpy(), t.imag.numpy()]) if t.is_complex()
            else t.numpy() for t in out]


def case_fast_block_shard(kind, tmp):
    """The lanes block called directly, with JAX's ``"shard"`` spelling of
    kernel A's route on the mesh."""
    from pauxy_tpu_torch.propagation import continuous
    from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
    from pauxy_tpu_torch.qmc import hubbard_fast as hf

    ham = _hub()
    trial = free_electron_trial(ham, **KW)
    inner = make_hubbard_continuous(ham, trial, 0.01, **KW)
    prop = continuous.Continuous(inner=inner, dt=0.01)
    state = init_walkers(trial, 16, total_weight=16.0)
    mesh = _mesh(kind)
    if mesh is not None:
        state = pmesh.shard_walkers(state, mesh)
    gen = torch.Generator().manual_seed(3)
    try:
        s, a = hf.run_block_lanes(
            ham, trial, prop, state, gen, 0.0, 0, nsteps=6, nstblz=3,
            npop_control=2, pop_method="comb", target_weight=16.0,
            energy_eval_freq=1,
            greens_impl=None if mesh is None else "shard")
        weight = pmesh.gather_walkers(s.weight)
    finally:
        pmesh.set_active_mesh(None)
    return a.numpy(), weight.numpy()


def case_thermal(kind, tmp):
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **KW)
    trial = make_one_body_trial(ham, 0.5, 0.05, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=1, nblocks=4, beta=0.5,
                  npop_control=2, rng_seed=7)
    af = ThermalAFQMC(ham, trial, qmc, device="cpu")
    return _drive(af, kind)[:, :11].real


def case_thermal_discrete(kind, tmp):
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **KW)
    trial = make_one_body_trial(ham, 0.5, 0.05, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=1, nblocks=3, beta=0.5,
                  npop_control=2, rng_seed=3)
    af = ThermalAFQMC(ham, trial, qmc,
                      propagator_options={"hubbard_stratonovich":
                                          "discrete"}, device="cpu")
    return _drive(af, kind)[:, :11].real


def case_thermal_low_rank(kind, tmp):
    from pauxy_tpu_torch.qmc.calc import setup_calculation

    af = setup_calculation({
        "verbosity": 0,
        "qmc": {"timestep": 0.05, "rng_seed": 8, "nblocks": 3,
                "nwalkers": 16, "beta": 0.25, "npop_control": 2},
        "model": {"name": "UEG", "rs": 1.0, "ecut": 1.0, "nup": 1,
                  "mu": 0.245, "ndown": 1},
        "trial": {"name": "one_body"},
        "walkers": {"low_rank": True, "low_rank_thresh": 1e-6},
        "estimates": {"filename": os.path.join(tmp, f"lr_{kind}.h5")},
    }, **KW)
    assert af.low_rank
    return _drive(af, kind)[:, :11].real


def case_hubbard_holstein(kind, tmp):
    from pauxy_tpu_torch.models import (coherent_state_trial,
                                        make_hubbard_holstein)

    ham = make_hubbard_holstein(2, 2, U=4.0, nx=4, g=0.5, w0=1.0,
                                xpbc=False, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=8, nblocks=3, nstblz=4,
                  npop_control=4, rng_seed=5)
    af = AFQMC(ham, coherent_state_trial(ham, **KW), qmc,
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               device="cpu")
    return _drive(af, kind)[:, 1:10].real


def case_multi_coherent(kind, tmp):
    from pauxy_tpu_torch.models import (make_hubbard_holstein,
                                        multi_coherent_trial)

    ham = make_hubbard_holstein(1, 1, U=4.0, nx=3, g=0.4, w0=1.0,
                                xpbc=True, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=6, nblocks=3, nstblz=3,
                  npop_control=3, rng_seed=4)
    af = AFQMC(ham, multi_coherent_trial(ham, **KW), qmc,
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               device="cpu")
    return _drive(af, kind)[:, 1:10].real


def _generic_ham():
    from pauxy_tpu_torch.models import make_generic
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    return make_generic((3, 3), h1e, chol, enuc, **KW)


def case_generic(kind, tmp):
    """Generic on a [walker=2, chol=2] mesh (the one-rank run keeps the
    exchange supermatrix; the sharded one sums the exchange's partials)."""
    from pauxy_tpu_torch.models import rhf_identity_trial

    ham = _generic_ham()
    qmc = QMCOpts(nwalkers=16, dt=0.005, nsteps=8, nblocks=2, nstblz=4,
                  npop_control=2, rng_seed=3)
    af = AFQMC(ham, rhf_identity_trial(ham, **KW), qmc,
               estimator_options=MIXED, device="cpu")
    return _drive(af, kind, generic=True)[:, 1:10].real


def case_msd_generic(kind, tmp):
    from pauxy_tpu_torch.models import multi_slater_trial

    ham = _generic_ham()
    rng = np.random.default_rng(4)
    eye = np.eye(8)[:, :6]
    psi = np.stack([eye, eye + 0.05 * rng.standard_normal(eye.shape)])
    trial = multi_slater_trial(ham, psi, np.array([0.9, 0.1]), **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.005, nsteps=6, nblocks=2, nstblz=3,
                  npop_control=2, rng_seed=9)
    af = AFQMC(ham, trial, qmc, estimator_options=MIXED, device="cpu")
    return _drive(af, kind, generic=True)[:, 1:10].real


# ---------------------------------------------------------------------------
# Every Generic path on the [walker, chol] mesh (tests/test_torch_mesh_chol.py)
# ---------------------------------------------------------------------------

def _generic_af(variant=None, estimator_options=None, **kw):
    """A small Generic AFQMC driver (``_generic_ham``'s system, the RHF
    identity trial, 16 walkers), with an energy ``variant`` of
    ``make_generic``'s and ``kw`` passed to the driver."""
    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    ham = make_generic((3, 3), h1e, chol, enuc, **(variant or {}), **KW)
    qmc = kw.pop("qmc", None) or QMCOpts(
        nwalkers=16, dt=0.005, nsteps=8, nblocks=2, nstblz=4,
        npop_control=2, rng_seed=3)
    return AFQMC(ham, rhf_identity_trial(ham, **KW), qmc,
                 estimator_options=estimator_options or MIXED,
                 device="cpu", **kw)


BP_CHOL = {"mixed": {"energy_eval_freq": 1},
           "back_propagation": {"tau_bp": 0.02, "evaluate_energy": True,
                                "evaluate_ekt": True,
                                "restore_weights": "partial"}}


def _bp_rows(af):
    """The back-propagated rows (energies, denominators, 1-RDM and both
    EKT Focks of every block) as one real and one imaginary array."""
    bp = np.stack([np.concatenate([np.ravel(v) for _, v in sorted(r.items())])
                   for r in af.bp_reporter.rows])
    return np.real(bp), np.imag(bp)


def case_bp_chol(kind, tmp):
    """Back propagation with energies, EKT and restore_weights='partial':
    the field buffer holds each rank's X slice."""
    af = _generic_af(estimator_options=BP_CHOL)
    rows = _drive(af, kind, generic=True)[:, 1:10].real
    if kind is not None:
        assert af.state.configs.shape[-1] == 8, af.state.configs.shape
    return (rows, *_bp_rows(af))


def case_itcf_chol(kind, tmp):
    af = _generic_af(estimator_options={
        "mixed": {"energy_eval_freq": 1},
        "itcf": {"tau_max": 0.02, "stable": True}})
    rows = _drive(af, kind, generic=True)[:, 1:10].real
    g = np.stack([np.asarray(r["real_space_greens_function"])
                  for r in af.itcf_reporter.rows])
    return rows, g.real, g.imag


def _variant(kind, **variant):
    af = _generic_af(variant)
    return _drive(af, kind, generic=True)[:, 1:10].real


def case_exact_eri_chol(kind, tmp):
    return _variant(kind, exact_eri=True)


def case_pno_chol(kind, tmp):
    return _variant(kind, pno=True, thresh_pno=1e-6)


def case_sri_chol(kind, tmp):
    return _variant(kind, stochastic_ri=True, nsamples=6)


def case_sri_cv_chol(kind, tmp):
    return _variant(kind, stochastic_ri=True, nsamples=6,
                    control_variate=True)


def case_sri_step_chol(kind, tmp):
    """The sketched one-body step: the rows and every sketch applied (the
    same on every rank of both groups as on the one-rank run)."""
    from pauxy_tpu_torch.propagation import continuous

    applied = []
    plain = continuous._apply_bh1_stochastic

    def record(bh1, phia, phib, theta):
        applied.append(theta.numpy().copy())
        return plain(bh1, phia, phib, theta)

    af = _generic_af(propagator_options={"stochastic_ri": True,
                                         "nsamples": 64})
    continuous._apply_bh1_stochastic = record
    try:
        rows = _drive(af, kind, generic=True)[:, 1:10].real
    finally:
        continuous._apply_bh1_stochastic = plain
    assert len(applied) == 2 * 16, len(applied)
    return rows, np.stack(applied)


def case_thermal_generic_chol(kind, tmp):
    """ThermalAFQMC on the full-rank stack with a Generic Hamiltonian."""
    from pauxy_tpu_torch.models import make_generic
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    ham = make_generic((3, 3), h1e, chol, enuc, **KW)
    trial = make_one_body_trial(ham, 0.25, 0.05, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=1, nblocks=2, beta=0.25,
                  npop_control=2, rng_seed=7)
    af = ThermalAFQMC(ham, trial, qmc, device="cpu")
    return _drive(af, kind, generic=True)[:, :11].real


def case_thermal_generic_low_rank_chol(kind, tmp):
    """ThermalAFQMC on the low-rank stack with a Generic Hamiltonian whose
    one-body part, and so the trial's density matrix, is diagonal (the
    stack's condition; M = 4, X = 8)."""
    from pauxy_tpu_torch.models import make_generic
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    rng = np.random.default_rng(0)
    chol = 0.1 * rng.normal(size=(4, 4, 8))
    ham = make_generic((1, 1), np.diag([-1.0, -0.5, 0.0, 1.0]),
                       chol + chol.transpose(1, 0, 2), **KW)
    trial = make_one_body_trial(ham, beta=0.25, dt=0.05, mu=0.0, **KW)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=1, nblocks=2, beta=0.25,
                  npop_control=2, rng_seed=5)
    af = ThermalAFQMC(ham, trial, qmc, device="cpu",
                      walker_options={"low_rank": True})
    assert af.low_rank
    return _drive(af, kind, generic=True)[:, :11].real


def case_bp_ckpt_chol(kind, tmp):
    """Back propagation with a checkpoint: on one rank 3 blocks straight;
    on the mesh 2 blocks written to ``bp_ckpt`` and read back on the mesh
    (whether every rank's walkers and field-buffer slice came back
    exactly); the test restores the directory on one rank and runs the
    third block."""
    if kind is None:
        af = _generic_af(estimator_options=BP_CHOL, qmc=bp_ckpt_qmc(3))
        return _drive(af, None, generic=True)[:, 1:10].real, \
            _bp_rows(af)[0]
    from pauxy_tpu_torch.utils.checkpoint import load_walkers_sharded

    d = os.path.join(tmp, "bp_ckpt")
    af = _generic_af(estimator_options=BP_CHOL, qmc=bp_ckpt_qmc(2),
                     walker_options={"write_freq": 2, "write_file": d})
    m = _mesh(kind)
    af.ham, af.trial, af.prop = pmesh.shard_generic(af.ham, af.trial,
                                                    af.prop, m)
    af.state = pmesh.shard_walkers(af.state, m)
    try:
        rows = np.asarray(af.run())[:, 1:10].real
        # Read back on the mesh: this rank's walkers and X slice.
        back, _ = load_walkers_sharded(af.state, d, mesh=m)
    finally:
        pmesh.set_active_mesh(None)
    same = all(torch.equal(getattr(back, f), getattr(af.state, f))
               for f in ("configs", "phia", "weight", "weight_fac"))
    return rows, _bp_rows(af)[0], same


def bp_ckpt_qmc(nblocks):
    return QMCOpts(nwalkers=16, dt=0.005, nsteps=8, nblocks=nblocks,
                   nstblz=4, npop_control=2, rng_seed=3)


def parity_inputs(nw=4, seed=21):
    """The module parity cases' inputs, numpy from a seed: full Green's
    functions Ga, Gb [w, 8, 8] and half-rotated ones [w, 3, 8] of the
    ``_generic_ham`` system."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    eye = np.eye(8)
    ga = eye[None, :, :3] @ eye[None, :3, :] + 0.2 * cplx(nw, 8, 8)
    gb = eye[None, :, :3] @ eye[None, :3, :] + 0.2 * cplx(nw, 8, 8)
    gha = np.eye(3, 8)[None] + 0.3 * cplx(nw, 3, 8)
    ghb = np.eye(3, 8)[None] + 0.3 * cplx(nw, 3, 8)
    return ga, gb, gha, ghb


SRI_THETA = "sri_theta.npy"


def case_parity_chol(kind, tmp):
    """The dense-G energy, both EKT Focks and the stochastic-RI energy
    (with and without the control variate; the probes [16, 6] that the
    test wrote to ``tmp``) on the same inputs: on the mesh each rank's X
    slice, summed over the chol group inside each function."""
    from pauxy_tpu_torch.estimators import ekt
    from pauxy_tpu_torch.estimators import local_energy as le

    ga, gb, gha, ghb = (torch.from_numpy(x) for x in parity_inputs())
    theta = torch.from_numpy(np.load(os.path.join(tmp, SRI_THETA)))
    out = {}
    m = _mesh(kind)
    for cv in (False, True):
        af = _generic_af({"stochastic_ri": True, "nsamples": 6,
                          "control_variate": cv})
        ham, trial = af.ham, af.trial
        if m is not None:
            ham, trial, _ = pmesh.shard_generic(ham, trial, af.prop, m)
            pmesh.set_active_mesh(m)
        try:
            th = theta if m is None else theta.chunk(m.nchol)[
                m.coord(pmesh.CHOL_AXIS)]
            out[f"sri_{cv}"] = le.local_energy_generic_stochastic_ri(
                trial, gha, ghb, ham.ecore, th, cv)
            if not cv:
                out["cholesky_G"] = le.local_energy_generic_cholesky_G(
                    ham, ga, gb)
                eye = torch.eye(8, dtype=ga.dtype)
                pa, pb = eye - ga.transpose(-1, -2), eye - gb.transpose(-1, -2)
                out["ekt_1p"] = ekt.ekt_1p_fock(ham.H1[0], ham.chol, pa, pb)
                out["ekt_1h"] = ekt.ekt_1h_fock(ham.H1[0], ham.chol, pa, pb)
        finally:
            pmesh.set_active_mesh(None)
    return {k: np.asarray(torch.stack(v) if isinstance(v, tuple) else v)
            for k, v in out.items()}


# Which mesh each case runs on.
MESH_OF = {"generic": "walker_chol", "msd_generic": "walker_chol",
           **{name[5:]: "walker_chol" for name in list(globals())
              if name.startswith("case_") and name.endswith("_chol")}}


def run(name: str, kind, tmp):
    return globals()[f"case_{name}"](kind, tmp)


def run_rank(rank: int, names, tmp):
    """Every case of ``names`` on its mesh: {name: result} of this rank
    (the caller holds every rank's against the one-rank run)."""
    out = {}
    for name in names:
        out[name] = run(name, MESH_OF.get(name, "walker"), tmp)
    return out


# ---------------------------------------------------------------------------
# Sharded checkpoints (tests/test_torch_checkpoint_sharded.py)
# ---------------------------------------------------------------------------

def random_state(nw=16, seed=3):
    """(trial, a walker population of the 3x3 twisted lattice with
    perturbed orbitals and weights in [0.5, 1.5))."""
    ham = _hub(ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham, **KW)
    state = init_walkers(trial, nw)
    rng = np.random.default_rng(seed)
    return trial, dataclasses.replace(
        state,
        phia=state.phia + 0.1 * torch.from_numpy(
            rng.standard_normal(tuple(state.phia.shape))),
        weight=torch.from_numpy(rng.uniform(size=nw) + 0.5))


def _resume_qmc(nblocks):
    return QMCOpts(nwalkers=16, dt=0.01, nsteps=5, nblocks=nblocks, nstblz=5,
                   npop_control=2, rng_seed=11)


def resume_driver(nblocks, walker_options=None):
    ham = _hub(ktwist=[0.01, -0.02])
    return AFQMC(ham, free_electron_trial(ham, **KW), _resume_qmc(nblocks),
                 estimator_options=MIXED, walker_options=walker_options,
                 device="cpu")


def checkpoint_rank(rank: int, tmp):
    """Each rank's part of the sharded-checkpoint cases: the round trip on
    the mesh (directory ``rt``), a sharded save for the dense restore and
    for JAX (``dense``), and the driver resuming from a sharded directory,
    by hand (``ckpt3``) and through ``write_freq`` / ``read_file``
    (``opts``)."""
    from pauxy_tpu_torch.utils.checkpoint import (load_walkers_sharded,
                                                  save_walkers_sharded)

    out = {}
    m = pmesh.walker_mesh(device="cpu")
    trial, state = random_state()
    local = pmesh.shard_walkers(state, m)
    gen = torch.Generator().manual_seed(99)
    rt = os.path.join(tmp, "rt")
    save_walkers_sharded(local, rt, generator=gen, step=70, eshift=-1.25)
    template = pmesh.shard_walkers(init_walkers(trial, 16), m)
    restored, info = load_walkers_sharded(template, rt, mesh=m)
    out["roundtrip"] = {
        name: bool(torch.equal(getattr(restored, name), getattr(local, name)))
        for name in ("phia", "phib", "weight", "log_ovlp", "total_weight")}
    out["info"] = (info["step"], info["eshift"],
                   bool(torch.equal(info["rng_state"], gen.get_state())))
    out["nlocal"] = restored.nwalkers
    save_walkers_sharded(local, os.path.join(tmp, "dense"), step=5,
                         eshift=0.5)
    pmesh.set_active_mesh(None)

    full = resume_driver(3)
    full.state = pmesh.shard_walkers(full.state, m)
    rows_full = np.asarray(full.run())
    part1 = resume_driver(2)
    part1.state = pmesh.shard_walkers(part1.state, m)
    part1.run()
    d3 = os.path.join(tmp, "ckpt3")
    save_walkers_sharded(part1.state, d3, generator=part1.generator,
                         step=part1.step, eshift=part1.eshift)
    part2 = resume_driver(1)
    template = pmesh.shard_walkers(part2.state, m)
    part2.state, info = load_walkers_sharded(template, d3, mesh=m)
    part2.step, part2.eshift = info["step"], info["eshift"]
    part2.generator.set_state(info["rng_state"])
    rows_resumed = np.asarray(part2.run())
    # The same through the driver's options: a sharded directory written
    # every 2 blocks, read whole by a new driver, which is then sharded.
    d4 = os.path.join(tmp, "opts")
    part1 = resume_driver(2, {"write_freq": 2, "write_file": d4})
    part1.state = pmesh.shard_walkers(part1.state, m)
    part1.run()
    part2 = resume_driver(1, {"read_file": d4})
    part2.state = pmesh.shard_walkers(part2.state, m)
    rows_opts = np.asarray(part2.run())
    pmesh.set_active_mesh(None)
    out["rows"] = (rows_full[-1, 1:10].real, rows_resumed[-1, 1:10].real,
                   rows_opts[-1, 1:10].real)
    return out


def tensor_rank(rank: int):
    """A rank's result holding tensors (sent back by value)."""
    if rank == 1 and os.environ.get("MESH_CASES_FAIL") == "1":
        raise ValueError("rank 1 fails on purpose")
    return {"x": torch.full((3,), float(rank)), "rank": rank}
