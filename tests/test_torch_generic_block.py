"""Port parity: the generic [w, M, n] block and its pieces against JAX.

float64 throughout, from the same walker state (the JAX objects carried
across with pauxy_tpu_torch.utils.convert):
  * greens_function, orthogonalise and mixed.update (phaseless and free
    projection), local_energy_hubbard and comb / pair_branch population
    control (same parents): 1e-10;
  * two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
    with JAX's own draws injected through ``noise``, taken in JAX's order
    (keys = split(block_key, nsteps); kprop, kpop, kest = split(key, 3);
    rs = uniform(kprop, (M, nw)); comb's uniform(kpop, ()) or pair_branch's
    uniform(kpop, (nw // 2,))): accumulators and weights at rtol 1e-8,
    atol 1e-10, for the spin decomposition on the port's "kernel" route
    (JAX runs its scan route here; both take the same draws) with comb and
    with pair_branch, and the charge decomposition on the "scan" route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation.hirsch import make_hirsch
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers
from pauxy_tpu.walkers import pop_control as jpc
from pauxy_tpu.walkers import state as jstate_mod
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.ops import greens as tgreens
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import pop_control as tpc
from pauxy_tpu_torch.walkers import state as tstate_mod

torch.set_num_threads(1)

STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def close_log(a, b, tol=1e-10):
    d = np.asarray(a) - np.asarray(b)
    close(d.real, 0.0, tol)
    close(np.angle(np.exp(1j * d.imag)), 0.0, tol)


def system(nw=16, seed=0, **kw):
    ham = make_hubbard(nup=kw.get("nup", 7), ndown=kw.get("ndown", 7),
                       U=4.0, nx=4, ny=4)
    trial = free_electron_trial(ham)
    state = init_walkers(trial, nw, total_weight=float(nw))
    rng = np.random.default_rng(seed)
    pa = 0.1 * (rng.standard_normal(state.phia.shape)
                + 1j * rng.standard_normal(state.phia.shape))
    pb = 0.1 * (rng.standard_normal(state.phib.shape)
                + 1j * rng.standard_normal(state.phib.shape))
    state = state.replace(
        phia=state.phia + pa, phib=state.phib + pb,
        weight=jnp.asarray(rng.uniform(0.2, 3.0, nw)),
        hybrid_energy=jnp.asarray(rng.normal(size=nw) + 0j))
    state = state.replace(
        log_ovlp=jgreens.log_overlap(state.phia, trial.psia)
        + jgreens.log_overlap(state.phib, trial.psib))
    tham = convert.hubbard(np.asarray(ham.T), ham.U, ham.symmetric,
                           nx=ham.nx, ny=ham.ny, nup=ham.nup,
                           ndown=ham.ndown, device="cpu")
    ttrial = convert.trial(np.asarray(trial.psia), np.asarray(trial.psib),
                           trial.etrial, device="cpu")
    return ham, trial, state, tham, ttrial, port_state(state)


def port_state(js):
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu")


def assert_states_close(ts, js, tol=1e-10):
    for f in ("phia", "phib", "weight", "unscaled_weight", "log_detr",
              "hybrid_energy"):
        close(getattr(ts, f).numpy(), getattr(js, f), tol)
    close_log(ts.log_ovlp.numpy(), js.log_ovlp, tol)
    assert float(ts.total_weight) == pytest.approx(float(js.total_weight),
                                                   rel=tol)


def test_greens_function_matches_jax():
    ham, trial, js, _, tt, ts = system()
    for phi_j, psi_j, phi_t, psi_t in ((js.phia, trial.psia, ts.phia,
                                        tt.psia),
                                       (js.phib, trial.psib, ts.phib,
                                        tt.psib)):
        gj = jgreens.greens_function(phi_j, psi_j)
        gt = tgreens.greens_function(phi_t, psi_t)
        close(gt.G.numpy(), gj.G)
        close(gt.Ghalf.numpy(), gj.Ghalf)
        close_log(gt.log_ovlp.numpy(), gj.log_ovlp)


def test_orthogonalise_matches_jax():
    _, _, js, _, _, ts = system(seed=1)
    jnew = jstate_mod.orthogonalise(js)
    tnew = tstate_mod.orthogonalise(ts)
    assert_states_close(tnew, jnew)
    # Free projection: |det R| into the weight, the overlap kept.
    assert_states_close(tstate_mod.orthogonalise(ts, free_projection=True),
                        jstate_mod.orthogonalise(js, free_projection=True))


@pytest.mark.parametrize("symmetric", [False, True])
def test_local_energy_hubbard_matches_jax(symmetric):
    _, trial, js, _, _, _ = system(seed=2)
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4,
                       symmetric=symmetric)
    tham = convert.hubbard(np.asarray(ham.T), ham.U, symmetric, nx=4, ny=4,
                           nup=7, ndown=7, device="cpu")
    ga = jgreens.greens_function(js.phia, trial.psia).G
    gb = jgreens.greens_function(js.phib, trial.psib).G
    ej = jle.local_energy_hubbard(ham, ga, gb)
    et = tle.local_energy_hubbard(tham, torch.from_numpy(np.array(ga)),
                                  torch.from_numpy(np.array(gb)))
    for a, b in zip(et, ej):
        close(a.numpy(), b)


@pytest.mark.parametrize("eval_energy", [True, False])
def test_mixed_update_matches_jax(eval_energy):
    ham, trial, js, tham, tt, ts = system(seed=3)
    aj = jmixed.update(ham, trial, js, eval_energy)
    at = tmixed.update(tham, tt, ts, eval_energy)
    assert at.shape == (tmixed.NACC,) == aj.shape
    close(at.numpy(), aj)
    close(tmixed.update(tham, tt, ts, eval_energy,
                        free_projection=True).numpy(),
          jmixed.update(ham, trial, js, eval_energy, free_projection=True))


@pytest.mark.parametrize("method", ["comb", "pair_branch"])
def test_pop_control_matches_jax(method):
    _, _, js, _, _, ts = system(nw=24, seed=4)
    key = jax.random.key(9)
    shape = () if method == "comb" else (12,)
    u = torch.from_numpy(np.array(
        jax.random.uniform(key, shape, dtype=jnp.float64)).reshape(-1))
    jnew = jpc.pop_control(js, key, 24.0, method)
    tnew = tpc.pop_control(ts, 24.0, method, uniforms=u)
    assert_states_close(tnew, jnew)
    with pytest.raises(ValueError):
        tpc.pop_control(ts, 24.0, "stochastic", uniforms=u)


def jax_noise(block_key, nsteps, nw, m, pop_method):
    rs, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        rs.append(np.asarray(jax.random.uniform(kprop, (m, nw),
                                                dtype=jnp.float64)))
        shape = () if pop_method == "comb" else (nw // 2,)
        pop.append(np.asarray(jax.random.uniform(kpop, shape,
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(torch.from_numpy(np.array(rs)),
                      torch.from_numpy(np.array(pop)))


CASES = {
    "spin_kernel_comb": dict(charge=False, route="kernel"),
    "spin_kernel_pair_branch": dict(charge=False, route="kernel",
                                    pop_method="pair_branch"),
    "charge_scan": dict(charge=True, route="scan", npop_control=2, eef=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_block_trajectory_matches_jax(case):
    kw = CASES[case]
    nw = 24
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    trial = free_electron_trial(ham)
    jprop = make_hirsch(ham, trial, 0.01, charge_decomposition=kw["charge"],
                        sweep_kernel="scan")
    js = init_walkers(trial, nw, total_weight=float(nw))
    pop_method = kw.get("pop_method", "comb")
    opts = dict(nsteps=10, nstblz=5, npop_control=kw.get("npop_control", 1),
                pop_method=pop_method, target_weight=float(nw),
                energy_eval_freq=kw.get("eef", 1))
    tham = convert.hubbard(np.asarray(ham.T), ham.U, ham.symmetric,
                           nx=ham.nx, ny=ham.ny, nup=ham.nup,
                           ndown=ham.ndown, device="cpu")
    ttrial = convert.trial(np.asarray(trial.psia), np.asarray(trial.psib),
                           trial.etrial, device="cpu")
    tprop = convert.hirsch(np.asarray(jprop.BT2), np.asarray(jprop.auxf),
                           np.asarray(jprop.aux_wfac), dt=jprop.dt,
                           charge=jprop.charge, gamma=jprop.gamma,
                           sweep_kernel=kw["route"], device="cpu")
    ts = port_state(js)
    for block, eshift in enumerate((0.0, -12.0)):
        key = jax.random.key(11 + block)
        step0 = 10 * block
        js, jacc, _, _ = jafqmc.run_block(
            ham, trial, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(step0, jnp.int32), free_projection=False, **opts)
        noise = jax_noise(key, 10, nw, 16, pop_method)
        ts, tacc, _, _ = tafqmc.run_block(tham, ttrial, tprop, ts, None,
                                          eshift, step0, noise=noise, **opts)
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "unscaled_weight", "log_detr"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(ts.phia.numpy(), np.asarray(js.phia),
                                   rtol=1e-8, atol=1e-10)
        assert float(ts.total_weight) == pytest.approx(
            float(js.total_weight), rel=1e-8)
