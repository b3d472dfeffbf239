"""Port tests for the discrete thermal propagator
(propagation/thermal_discrete.py) against the JAX package, float64 on the
CPU, 3x3 Hubbard U = 4 unless stated:

* ``make_thermal_discrete``'s tables (BH1, BH1^-1, auxf, aux_wfac, delta)
  at 1e-12: spin and charge decompositions, a non-symmetric model, a
  system mu apart from the trial's; the attractive-U ValueError, and the
  charge decomposition building for attractive U; the converter;
* ``_sweep_greens_function`` at 1e-10 at every slice of a path (bin
  boundaries and interior slices), and ``_site_sweep`` with JAX's uniforms
  (G, weight, BV) at 1e-10;
* the heat-bath ratio 1 + (1 - G_ii) delta against the brute-force ratio
  det(1 + A') / det(1 + A) site by site, and the swept G against
  (1 + diag(BV) A)^-1, at 1e-10;
* the wrapped G (wrap_stabilize = 10^9) against a recompute every slice
  (wrap_stabilize = 1): G at 1e-9, weights at rtol 1e-10, slice by slice;
* two paths of ThermalAFQMC against JAX's with JAX's uniforms (constrained
  path) or fields (free projection) injected, spin and charge, every row
  entry but the time at rtol 1e-8;
* U = 0: every row the exact grand-canonical E and N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models.thermal_trial import make_one_body_trial as j_mobt
from pauxy_tpu.propagation import thermal_discrete as jtd
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu.qmc import thermal_afqmc as jta
from pauxy_tpu.walkers import thermal_state as jtws
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
from pauxy_tpu_torch.propagation import thermal_discrete as td
from pauxy_tpu_torch.qmc import QMCOpts
from pauxy_tpu_torch.qmc import thermal_afqmc as tta
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import thermal_state as tws

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
TABLES = ("BH1", "BH1_inv", "auxf", "aux_wfac", "delta")
STATE = ("stack", "right", "G", "log_m0", "weight", "unscaled_weight",
         "phase", "total_weight", "hybrid_energy", "pq", "pd", "pt")
# beta = 0.3, dt = 0.05: 6 slices in 3 bins of 2.
KW = dict(beta=0.3, dt=0.05, mu=0.9, stack_size=2)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = np_(a), np_(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def pair(U=4.0, **model):
    model = dict(dict(nup=3, ndown=3, nx=3, ny=3), **model)
    jham = j_make_hubbard(U=U, **model)
    ham = make_hubbard(model["nup"], model["ndown"], U=U, nx=model["nx"],
                       ny=model["ny"], symmetric=model.get("symmetric",
                                                           False), **CPU)
    return jham, ham


@pytest.mark.parametrize("charge,symmetric,mu", [(False, False, None),
                                                 (True, False, None),
                                                 (False, True, 0.5),
                                                 (True, True, 1.2)])
def test_tables_match_jax(charge, symmetric, mu):
    jham, ham = pair(symmetric=symmetric)
    jt, t = j_mobt(jham, **KW), make_one_body_trial(ham, **KW, **CPU)
    jp = jtd.make_thermal_discrete(jham, jt, 0.05, charge, mu=mu)
    p = td.make_thermal_discrete(ham, t, 0.05, charge, mu=mu, **CPU)
    for name in TABLES:
        assert rel(getattr(p, name), getattr(jp, name)) < 1e-12, name
    assert (p.charge, p.wrap_stabilize) == (charge, 10)
    conv = convert.thermal_discrete(
        *(np.asarray(getattr(jp, k)) for k in TABLES), dt=jp.dt,
        charge=jp.charge, free_projection=jp.free_projection,
        wrap_stabilize=jp.wrap_stabilize, device="cpu")
    for name in TABLES:
        assert np.array_equal(np_(getattr(conv, name)),
                              np.asarray(getattr(jp, name)))


def test_attractive_u_needs_charge():
    jham = j_make_hubbard(nup=2, ndown=2, U=-4.0, nx=4, ny=1)
    ham = make_hubbard(2, 2, U=-4.0, nx=4, ny=1, **CPU)
    kw = dict(beta=0.4, dt=0.05, stack_size=2)
    jt, t = j_mobt(jham, **kw), make_one_body_trial(ham, **kw, **CPU)
    with pytest.raises(ValueError, match="charge_decomposition"):
        td.make_thermal_discrete(ham, t, 0.05, **CPU)
    p = td.make_thermal_discrete(ham, t, 0.05, charge_decomposition=True,
                                 **CPU)
    jp = jtd.make_thermal_discrete(jham, jt, 0.05, charge_decomposition=True)
    assert torch.isfinite(p.auxf).all()
    for name in TABLES:
        assert rel(getattr(p, name), getattr(jp, name)) < 1e-12, name


def to_port(jstate):
    return convert.thermal_walker_state(
        **{k: np.asarray(getattr(jstate, k)) for k in STATE}, device="cpu")


def test_sweep_pieces_match_jax():
    """Along one JAX path (4 walkers): the boundary G of every slice and
    the site sweep of the slice with JAX's uniforms."""
    jham, ham = pair()
    jt, t = j_mobt(jham, **KW), make_one_body_trial(ham, **KW, **CPU)
    jp = jtd.make_thermal_discrete(jham, jt, 0.05, wrap_stabilize=1)
    p = td.make_thermal_discrete(ham, t, 0.05, wrap_stabilize=1, **CPU)
    # JAX's pieces under jit, the slice index traced: one trace each.
    j_greens = jax.jit(lambda st, ts: jp._sweep_greens_function(jt, st, ts))
    j_sweep = jax.jit(jp._site_sweep)
    j_propagate = jax.jit(lambda st, key, ts: jp.propagate(jt, st, key, ts))
    jstate = jtws.init_thermal_walkers(jt, 4)
    key = jax.random.key(3)
    for ts in range(jt.num_slices):
        key, sub = jax.random.split(key)
        state = to_port(jstate)
        jg = j_greens(jstate, ts)
        g = p._sweep_greens_function(t, state, ts)
        assert rel(g, jg) < 1e-10, ts
        jg2, jw, jbv, _ = j_sweep(jstate, jg, sub)
        rs = torch.from_numpy(np.array(jax.random.uniform(
            sub, (9, 4), dtype=jnp.float64)))
        g2, w, bv = p._site_sweep(state, torch.from_numpy(np.array(jg)),
                                  rs)
        assert rel(g2, jg2) < 1e-10 and rel(w, jw) < 1e-10, ts
        assert np.array_equal(np_(bv), np.asarray(jbv)), ts
        jstate = j_propagate(jstate, sub, ts)


def test_heat_bath_ratio_is_the_determinant_ratio():
    """Site by site: R_s(x) = det(1 + A'_s) / det(1 + A_s) for
    A'_s = (1 + delta[x, s] e_i e_i^T) A_s; the weight factor
    sum_x max(0, Re R_up R_dn) / 2; the swept G = (1 + diag(BV) A)^-1."""
    _, ham = pair()
    t = make_one_body_trial(ham, **KW, **CPU)
    p = td.make_thermal_discrete(ham, t, 0.05, **CPU)
    rng = np.random.default_rng(7)
    m = 9
    a = 0.5 * (np.eye(m) + 0.3 * rng.normal(size=(1, 2, m, m))
               + 0.3j * rng.normal(size=(1, 2, m, m)))
    g0 = np.linalg.inv(np.eye(m) + a)
    state = tws.init_thermal_walkers(t, 1)
    rs = rng.uniform(size=(m, 1))
    g, w, bv = p._site_sweep(state, torch.from_numpy(g0),
                             torch.from_numpy(rs))
    delta = np_(p.delta)
    cur, weight = a[0].copy(), 1.0
    for i in range(m):
        ratios = []
        for x in (0, 1):
            r = 1.0
            for s in (0, 1):
                e = np.eye(m, dtype=complex)
                e[i, i] += delta[x, s]
                r *= (np.linalg.det(np.eye(m) + e @ cur[s])
                      / np.linalg.det(np.eye(m) + cur[s]))
            ratios.append(r)
        pr = np.maximum(0.5 * np.real(ratios), 0.0)
        weight *= pr.sum()
        x = int(rs[i, 0] >= pr[0] / pr.sum())
        for s in (0, 1):
            cur[s][i] *= 1 + delta[x, s]
    assert abs(np_(w)[0] - weight) < 1e-10 * weight
    assert rel(bv[0], np.stack([np.diagonal(cur[s]) / np.diagonal(a[0, s])
                                for s in (0, 1)])) < 1e-10
    want = np.linalg.inv(np.eye(m) + np_(bv)[0][:, :, None] * a[0])
    assert rel(g[0], want) < 1e-10


def test_wrap_equals_recompute():
    """wrap_stabilize = 10^9 (recompute at bin boundaries only) against 1
    (every slice), the same uniforms, slice by slice (beta = 1, 2 bins of
    10)."""
    _, ham = pair()
    t = make_one_body_trial(ham, 1.0, 0.05, stack_size=10, **CPU)
    ref = td.make_thermal_discrete(ham, t, 0.05, wrap_stabilize=1, **CPU)
    wrap = td.make_thermal_discrete(ham, t, 0.05, wrap_stabilize=10 ** 9,
                                    **CPU)
    s_ref, s_wrap = (tws.init_thermal_walkers(t, 4) for _ in range(2))
    rng = np.random.default_rng(5)
    assert t.nbins == 2
    for ts in range(t.num_slices):
        rs = torch.from_numpy(rng.uniform(size=(9, 4)))
        s_ref = ref.propagate(t, s_ref, ts, rs)
        s_wrap = wrap.propagate(t, s_wrap, ts, rs)
        assert np.abs(np_(s_wrap.G) - np_(s_ref.G)).max() < 1e-9, ts
        np.testing.assert_allclose(np_(s_wrap.weight), np_(s_ref.weight),
                                   rtol=1e-10)


def jax_discrete_noise(sub, nslices, nw, m, free_projection):
    draws, pop = [], []
    for key in jax.random.split(sub, nslices):
        kprop, kpop = jax.random.split(key)
        if free_projection:
            draws.append(np.asarray(jax.random.randint(kprop, (nw, m), 0, 2)))
        else:
            draws.append(np.asarray(jax.random.uniform(
                kprop, (m, nw), dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return tta.PathNoise(torch.from_numpy(np.array(draws)),
                         torch.from_numpy(np.array(pop)))


@pytest.mark.parametrize("free_projection,charge", [(False, False),
                                                    (False, True),
                                                    (True, False),
                                                    (True, True)])
def test_two_paths_match_jax(free_projection, charge, tmp_path):
    jham, ham = pair()
    nw = 8
    opts = dict(nwalkers=nw, dt=KW["dt"], nsteps=1, nblocks=2,
                beta=KW["beta"], npop_control=2, rng_seed=8)
    popts = {"hubbard_stratonovich": "discrete",
             "free_projection": free_projection,
             "charge_decomposition": charge}
    jaf = jta.ThermalAFQMC(jham, j_mobt(jham, **KW), JQMCOpts(**opts),
                           propagator_options=popts,
                           filename=str(tmp_path / "j.h5"))
    af = tta.ThermalAFQMC(ham, make_one_body_trial(ham, **KW, **CPU),
                          QMCOpts(**opts), propagator_options=popts,
                          device="cpu")
    assert isinstance(af.prop, td.ThermalDiscrete)
    key = jax.random.key(8)
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise = jax_discrete_noise(sub, af.ntime_slices, nw, 9,
                                   free_projection)
        jrow, row = jaf.run_block(), af.run_block(noise)
        np.testing.assert_allclose(row[:11], jrow[:11], rtol=1e-8,
                                   atol=1e-10)
        assert np.isfinite(row).all()


@pytest.mark.parametrize("free_projection", [False, True])
def test_free_fermions_exact(free_projection):
    _, ham = pair(U=0.0)
    beta, dt = 1.0, 0.05
    trial = make_one_body_trial(ham, beta, dt, **CPU)
    rows = tta.ThermalAFQMC(
        ham, trial, QMCOpts(nwalkers=4, dt=dt, nsteps=1, nblocks=2,
                            beta=beta, npop_control=5, rng_seed=3),
        propagator_options={"hubbard_stratonovich": "discrete",
                            "free_projection": free_projection},
        device="cpu").run()
    evals = np.linalg.eigvalsh(ham.T[0].numpy())
    occ = 1.0 / (np.exp(beta * (evals - trial.mu)) + 1.0)
    for row in rows:
        assert row[5].real == pytest.approx(2 * np.sum(evals * occ),
                                            abs=1e-5)
        assert row[10].real == pytest.approx(2 * occ.sum(), abs=1e-6)
