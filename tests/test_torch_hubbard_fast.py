"""Port parity: block trajectories of qmc/hubbard_fast against the JAX block.

Both blocks start from the same walker state, propagator and trial (the
JAX objects carried across with pauxy_tpu_torch.utils.convert), and the
port is fed JAX's own random draws through ``noise``, taken in JAX's order
(hubbard_fast.py: keys = split(block_key, nsteps); kprop, kpop, kest =
split(key, 3); xi = normal(kprop, (nw, m)).T). Two blocks run back to
back, the second with a nonzero eshift so that the hybrid-energy bound is
active. In float64 the accumulators' real parts and the final weights
agree at rtol 1e-8, atol 1e-10, the bound of tests/test_hubbard_fast.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.propagation import continuous as jcont
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous
from pauxy_tpu.qmc import hubbard_fast as jhf
from pauxy_tpu.walkers import init_walkers
from pauxy_tpu_torch.propagation import continuous as tcont
from pauxy_tpu_torch.propagation.hubbard import HubbardContinuous
from pauxy_tpu_torch.qmc import hubbard_fast as thf
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight")


def jax_noise(block_key, nsteps, nw, m, pop_method):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, m),
                                               dtype=jnp.float64)).T)
        shape = () if pop_method == "comb" else (nw // 2,)
        pop.append(np.asarray(jax.random.uniform(kpop, shape,
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return thf.BlockNoise(torch.from_numpy(np.array(xi)),
                          torch.from_numpy(np.array(pop)))


def port_state(js):
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu")


CASES = {
    "comb": dict(),
    "pair_branch": dict(pop_method="pair_branch"),
    "spin_twist_7_6": dict(ktwist=[0.02, -0.01], nup=7, ndown=6,
                           charge=False),
    "no_force_bias": dict(force_bias=False, eef=2, npop_control=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_block_trajectory_matches_jax(case):
    kw = CASES[case]
    nw = 24
    ham = make_hubbard(nup=kw.get("nup", 7), ndown=kw.get("ndown", 7),
                       U=4.0, nx=4, ny=4, ktwist=kw.get("ktwist"))
    trial = free_electron_trial(ham)
    inner = make_hubbard_continuous(ham, trial, 0.01,
                                    charge_decomposition=kw.get("charge",
                                                                True))
    jprop = jcont.Continuous(inner=inner, dt=0.01,
                             force_bias=kw.get("force_bias", True))
    jstate = init_walkers(trial, nw, total_weight=float(nw))
    pop_method = kw.get("pop_method", "comb")
    opts = dict(nsteps=10, nstblz=5, npop_control=kw.get("npop_control", 2),
                pop_method=pop_method, target_weight=float(nw),
                energy_eval_freq=kw.get("eef", 1))

    tham = convert.hubbard(np.asarray(ham.T), ham.U, ham.symmetric,
                           nx=ham.nx, ny=ham.ny, nup=ham.nup,
                           ndown=ham.ndown, device="cpu")
    ttrial = convert.trial(np.asarray(trial.psia), np.asarray(trial.psib),
                           trial.etrial, device="cpu")
    tinner = convert.hubbard_continuous(np.asarray(inner.BH1),
                                        np.asarray(inner.mf_shift),
                                        dt=inner.dt, U=inner.U,
                                        charge=inner.charge, device="cpu")
    tprop = tcont.Continuous(inner=tinner, dt=0.01,
                             force_bias=jprop.force_bias)
    assert thf.eligible(tham, ttrial, tprop, free_projection=False, nbp=0,
                        nitcf=0, calc_one_rdm=False, calc_two_rdm=None,
                        pop_method=pop_method)
    tstate = port_state(jstate)

    for block, eshift in enumerate((0.0, -12.0)):
        key = jax.random.key(3 + block)
        step0 = 10 * block
        jstate, jacc = jhf.run_block_lanes(
            ham, trial, jprop, jstate, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(step0, jnp.int32), greens_impl="xla", **opts)
        noise = jax_noise(key, 10, nw, 16, pop_method)
        tstate, tacc = thf.run_block_lanes(tham, ttrial, tprop, tstate, None,
                                           eshift, step0, noise=noise, **opts)
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(tstate.weight.numpy(),
                                   np.asarray(jstate.weight), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(tstate.log_detr.numpy(),
                                   np.asarray(jstate.log_detr), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(np.abs(tstate.phia.numpy()),
                                   np.abs(np.asarray(jstate.phia)),
                                   rtol=1e-8, atol=1e-10)
        assert tstate.phia.shape == (nw, 16, ham.nup)
        assert float(tstate.total_weight) == pytest.approx(
            float(jstate.total_weight), rel=1e-8)


def test_generator_draws_reproducible_and_finite():
    ham = convert.hubbard(np.stack([np.eye(4) * 0.0] * 2), 2.0, False,
                          nx=4, ny=1, nup=1, ndown=1, device="cpu")
    psi = np.eye(4, 1, dtype=np.complex128)
    trial = convert.trial(psi, psi, 0.0, device="cpu")
    inner = HubbardContinuous(torch.eye(4, dtype=torch.complex128)[None]
                              .repeat(2, 1, 1),
                              torch.zeros(4, dtype=torch.complex128),
                              dt=0.01, U=2.0)
    prop = tcont.Continuous(inner=inner, dt=0.01)
    from pauxy_tpu_torch.walkers import init_walkers as tinit

    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        state, acc = thf.run_block_lanes(
            ham, trial, prop, tinit(trial, 6), g, 0.0, 0, nsteps=4,
            nstblz=2, npop_control=1, pop_method="comb", target_weight=6.0,
            energy_eval_freq=1)
        outs.append((state, acc))
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.isfinite(outs[0][1]).all()
    assert dataclasses.fields(outs[0][0])


def test_continuous_fields_match_jax():
    """Drift catcher: the port's propagator settings are the JAX ones."""
    jf = [f.name for f in dataclasses.fields(jcont.Continuous)]
    tf = [f.name for f in dataclasses.fields(tcont.Continuous)]
    assert jf == tf
    p = tcont.Continuous(inner=None, dt=0.01)
    assert p.ebound == pytest.approx(jcont.Continuous(inner=None,
                                                      dt=0.01).ebound)
    e = torch.tensor([-40.0 + 1j, -12.0 - 2j, 30.0 + 0j],
                     dtype=torch.complex128)
    b = tcont._bound_hybrid(e, -12.0, p.ebound).numpy()
    jb = np.asarray(jcont._bound_hybrid(jnp.asarray(e.numpy()),
                                        jnp.asarray(-12.0 + 0j), p.ebound))
    np.testing.assert_allclose(b, jb, rtol=1e-14)
    np.testing.assert_array_equal(tcont._bound_hybrid(e, 0.0, 1.0).numpy(),
                                  e.numpy())
