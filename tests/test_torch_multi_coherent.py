"""Port parity: the multi-coherent Hubbard-Holstein trial, its energy and
its propagator paths, against JAX.

float64, the same inputs on both sides (numpy from a seed; JAX's trial
carried across with pauxy_tpu_torch.utils.convert, or each package
building its own from the same system):
  * multi_coherent_trial (the translation-symmetrised default and explicit
    stacks: psi, shifts, coeffs, etrial) and the translation permutations:
    1e-10;
  * boson_log_value, component_log_weights, mc_log_overlap,
    mc_greens_function, mc_boson_mixture, local_energy_multi_coherent and
    the mixed estimator's step (with the mixture 1-RDM): 1e-10;
  * the multi-coherent electron half-step, _site_sweep_mc and
    _boson_move_mc with JAX's draws: 1e-10, fields identical;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws,
    P = 3 (the plain step and symmetric_trotter): rtol 1e-8;
  * the anchors of tests/test_hubbard_holstein.py on the CPU: a
    one-component mixture follows the coherent-state run, and the 3-site
    polaron is within 0.2 of simple_fci_bose_fermi;
  * the refusals JAX keeps: back propagation, the ITCF and S(k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import hubbard_holstein as jhh
from pauxy_tpu.models import multi_coherent as jmc
from pauxy_tpu.ops import clinalg as jclinalg
from pauxy_tpu.propagation.hirsch_dmc import make_hirsch_dmc as j_make_dmc
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import ci
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import hubbard_holstein as thh
from pauxy_tpu_torch.models import multi_coherent as tmc
from pauxy_tpu_torch.propagation.hirsch_dmc import DMCDraws, make_hirsch_dmc
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def tpu_branch(monkeypatch):
    """JAX's log-determinant with arg det wrapped into (-pi, pi], the
    branch of its TPU kernel (and of the port's kernel B); jit caches
    cleared around it."""
    slogdet = jclinalg.slogdet

    def wrapped(s):
        ld = slogdet(s)
        return (ld.real + 1j * jnp.angle(jnp.exp(1j * ld.imag))).astype(
            ld.dtype)

    jax.clear_caches()
    monkeypatch.setattr(jclinalg, "slogdet", wrapped)
    yield
    jax.clear_caches()


def pair(nup=1, ndown=1, nx=3, ny=1, **kw):
    args = dict(nup=nup, ndown=ndown, U=kw.pop("U", 4.0), nx=nx, ny=ny,
                w0=kw.pop("w0", 0.8), lmbda=kw.pop("lmbda", 0.5), **kw)
    return jhh.make_hubbard_holstein(**args), \
        thh.make_hubbard_holstein(**args, **CPU)


def random_trial(jham, p=3, seed=2):
    """A random complex P-component stack, carried to both packages."""
    rng = np.random.default_rng(seed)
    m, ne = jham.nbasis, jham.nup + jham.ndown
    psi = rng.standard_normal((p, m, ne)) + 1j * rng.standard_normal(
        (p, m, ne))
    shifts = rng.standard_normal((p, m))
    coeffs = rng.uniform(0.5, 1.0, p) * np.exp(1j * rng.uniform(-1, 1, p))
    jt = jmc.multi_coherent_trial(jham, psi, shifts, coeffs)
    tt = convert.multi_coherent_trial(
        np.asarray(jt.psi), np.asarray(jt.shifts), np.asarray(jt.coeffs),
        np.asarray(jt.inita), np.asarray(jt.initb), np.asarray(jt.shift),
        nup=jt.nup, m=jt.m, w0=jt.w0, etrial=jt.etrial, device="cpu")
    return jt, tt


def random_walkers(m, na, nb, nw=5, seed=4):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    return c(nw, m, na), c(nw, m, nb), rng.standard_normal((nw, m))


# --------------------------------------------------------- construction ---

@pytest.mark.parametrize("shape", [(3, 1), (2, 2)])
def test_translation_trial_matches_jax(shape):
    nx, ny = shape
    jham, tham = pair(nx=nx, ny=ny)
    assert [p.tolist() for p in tmc._translation_perms(tham)] == \
        [p.tolist() for p in jmc._translation_perms(jham)]
    jt = jmc.multi_coherent_trial(jham)
    tt = tmc.multi_coherent_trial(tham, **CPU)
    assert tt.nperms == jt.nperms == nx * ny
    for key in ("psi", "shifts", "coeffs", "inita", "initb", "shift"):
        close(getattr(tt, key).numpy(), getattr(jt, key))
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
    assert (tt.nup, tt.ndown, tt.nbasis) == (jt.nup, jt.ndown, jt.nbasis)


def test_explicit_stack_etrial_matches_jax():
    jham, tham = pair(nx=4, nup=2, ndown=2, lmbda=0.3)
    jt, tt = random_trial(jham, p=2, seed=8)
    built = tmc.multi_coherent_trial(tham, tt.psi.numpy(),
                                     tt.shifts.numpy(), tt.coeffs.numpy(),
                                     **CPU)
    assert built.etrial == pytest.approx(jt.etrial, rel=1e-10)


# ----------------------------------------------------------- functions ---

def test_mixture_functions_match_jax():
    jham, tham = pair(nx=4, nup=2, ndown=1, lmbda=0.3)
    jt, tt = random_trial(jham, p=3)
    pa, pb, x = random_walkers(4, 2, 1)
    ja, jb, jx = jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(x)

    @jax.jit
    def jax_side(jt, ja, jb, jx):
        gi, cw = jmc.mc_greens_function(jt, ja, jb, jx)
        mix = jmc.mc_boson_mixture(jt, ja, jb, jx)
        return (jmc.boson_log_value(jt, jx),
                jmc.component_log_weights(jt, ja, jb, jx),
                jmc.mc_log_overlap(jt, ja, jb, jx), (gi, cw), mix,
                jle.local_energy_multi_coherent(jham, gi, cw, jx, mix[1]))

    jblv, (jlogw, jsa, jsb), jlo, (jgi, jcw), jmix, jen = jax_side(
        jt, ja, jb, jx)
    close(tmc.boson_log_value(tt, t(x)).numpy(), jblv)
    logw, sa, sb = tmc.component_log_weights(tt, t(pa), t(pb), t(x))
    # The log weights up to the log-det branch (JAX's CPU route sums the
    # pivots' phases unwrapped).
    close(np.exp(logw.numpy() - np.asarray(jlogw)), 1.0)
    close(logw.real.numpy(), np.asarray(jlogw).real)
    close(sa.numpy(), jsa)
    close(sb.numpy(), jsb)
    close(np.exp(tmc.mc_log_overlap(tt, t(pa), t(pb), t(x)).numpy()),
          np.exp(np.asarray(jlo)))
    gi, cw = tmc.mc_greens_function(tt, t(pa), t(pb), t(x))
    close(gi.numpy(), jgi)
    close(cw.numpy(), jcw)
    for a, b in zip(tmc.mc_boson_mixture(tt, t(pa), t(pb), t(x)), jmix):
        close(a.numpy(), b)
    got = tle.local_energy_multi_coherent(tham, gi, cw, t(x), t(jmix[1]))
    for a, b in zip(got, jen):
        close(a.numpy(), b)


def test_mixed_update_matches_jax(tpu_branch):
    jham, tham = pair(nx=4, nup=2, ndown=2, lmbda=0.3)
    jt, tt = random_trial(jham, p=3, seed=5)
    js = j_init_walkers(jt, 5, phonon_mw=jham.m * jham.w0,
                        phonon_key=jax.random.key(2))
    ts = init_walkers(tt, 5, X0=t(js.X))
    close(ts.log_ovlp.numpy(), js.log_ovlp)
    pa, pb, _ = random_walkers(4, 2, 2, seed=7)
    js = js.replace(phia=jnp.asarray(pa), phib=jnp.asarray(pb))
    ts.phia, ts.phib = t(pa), t(pb)
    for rdm in (False, True):
        close(tmixed.update(tham, tt, ts, True, calc_one_rdm=rdm).numpy(),
              jmixed.update(jham, jt, js, True, calc_one_rdm=rdm))


# --------------------------------------------------------- propagation ---

def same(ts, js, tol=1e-10):
    for f in ("phia", "phib", "weight", "log_ovlp", "X"):
        close(getattr(ts, f).numpy(), getattr(js, f), tol)


def test_propagator_pieces_match_jax(tpu_branch):
    jham, tham = pair(nx=4, nup=2, ndown=2, lmbda=0.3)
    jt = jmc.multi_coherent_trial(jham)
    tt = tmc.multi_coherent_trial(tham, **CPU)
    jprop = j_make_dmc(jham, jt, 0.02)
    tprop = make_hirsch_dmc(tham, tt, 0.02, **CPU)
    assert tprop.hirsch.sweep_kernel == "scan"
    nw = 6
    js = j_init_walkers(jt, nw, total_weight=float(nw),
                        phonon_mw=jham.m * jham.w0,
                        phonon_key=jax.random.key(3))
    ts = init_walkers(tt, nw, total_weight=float(nw), X0=t(js.X))
    same(ts, js)
    js = jax.jit(lambda s: jprop._electron_half_step_mc(jt, s, 0.01))(js)
    ts = tprop._electron_half_step_mc(tt, ts, 0.01)
    same(ts, js)
    k1, k2 = jax.random.split(jax.random.key(6))
    js, jf = jax.jit(lambda s: jprop._site_sweep_mc(jt, s, k1))(js)
    ts, tf = tprop._site_sweep_mc(tt, ts, rs=t(jax.random.uniform(
        k1, (4, nw), dtype=jnp.float64)))
    same(ts, js)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    # The maintained overlap is the mixture's from scratch.
    close(np.exp(ts.log_ovlp.numpy() - tmc.mc_log_overlap(
        tt, ts.phia, ts.phib, ts.X).numpy()), 1.0, 1e-9)
    js = jax.jit(lambda s: jprop._boson_move_mc(jt, s, k2, 0.02))(js)
    ts = tprop._boson_move_mc(tt, ts, 0.02, normals=t(jax.random.normal(
        k2, (nw, 4), dtype=jnp.float64)))
    same(ts, js)


def hh_noise(block_key, nsteps, nw, m, symmetric):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        k1, k2, k3 = jax.random.split(kprop, 3)
        xi.append(DMCDraws(
            t(jax.random.uniform(k1, (m, nw), dtype=jnp.float64)),
            t(jax.random.normal(k2, (nw, m), dtype=jnp.float64)),
            t(jax.random.normal(k3, (nw, m), dtype=jnp.float64))
            if symmetric else None))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(xi, t(np.array(pop)))


@pytest.mark.parametrize("symmetric", [False, True])
def test_blocks_match_jax(symmetric, tpu_branch):
    jham, tham = pair(nx=3)
    jt = jmc.multi_coherent_trial(jham)
    tt = tmc.multi_coherent_trial(tham, **CPU)
    assert tt.nperms == 3
    popts = {"symmetric_trotter": symmetric}
    jprop = j_make_dmc(jham, jt, 0.01, **popts)
    tprop = make_hirsch_dmc(tham, tt, 0.01, **popts, **CPU)
    nw, nsteps = 8, 5
    js = j_init_walkers(jt, nw, total_weight=float(nw),
                        phonon_mw=jham.m * jham.w0,
                        phonon_key=jax.random.key(11))
    ts = init_walkers(tt, nw, total_weight=float(nw), X0=t(js.X))
    opts = dict(nsteps=nsteps, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(51 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(nsteps * block, jnp.int32), free_projection=False,
            **opts)
        ts, tacc, _, _ = tafqmc.run_block(
            tham, tt, tprop, ts, None, eshift, nsteps * block,
            noise=hh_noise(key, nsteps, nw, 3, symmetric), **opts)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib", "log_ovlp", "X"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


# ------------------------------------------------------------ anchors ---

def test_single_component_follows_coherent_run():
    """A one-component mixture reproduces the coherent-state run (the same
    draws; the mixture collapses to the plain ratio and drift)."""
    ham = thh.make_hubbard_holstein(2, 2, U=4.0, nx=4, g=0.4, w0=1.0,
                                    **CPU)
    single = thh.coherent_state_trial(ham, **CPU)
    psi0 = np.concatenate([single.psia.numpy(), single.psib.numpy()], 1)
    mc = tmc.multi_coherent_trial(ham, psi0[None],
                                  single.shift.numpy()[None], np.ones(1),
                                  **CPU)
    qmc = QMCOpts(nwalkers=20, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=7)
    rows = {}
    for tag, trial in (("single", single), ("multi", mc)):
        rows[tag] = AFQMC(ham, trial, qmc, estimator_options={
            "mixed": {"energy_eval_freq": 1}}, device="cpu").run()
    np.testing.assert_allclose(rows["multi"][:, 5].real,
                               rows["single"][:, 5].real, rtol=5e-4)


def test_polaron_vs_bose_fermi_fci():
    """The translation-symmetrised trial (P = 3) on the 3-site ring
    against the bose-fermi FCI."""
    ham = thh.make_hubbard_holstein(1, 1, U=4.0, nx=3, w0=0.8, lmbda=0.5,
                                    **CPU)
    e_fci = ci.simple_fci_bose_fermi(ham, nboson_max=12)[0][0]
    trial = tmc.multi_coherent_trial(ham, **CPU)
    rows = AFQMC(ham, trial, QMCOpts(nwalkers=100, dt=0.005, nsteps=20,
                                     nblocks=15, nstblz=5, npop_control=5,
                                     rng_seed=7),
                 estimator_options={"mixed": {"energy_eval_freq": 2}},
                 device="cpu").run()
    et = rows[5:, 5].real
    assert np.isfinite(et).all()
    assert abs(et.mean() - e_fci) < 0.2, (et.mean(), e_fci)


def test_refusals_match_jax():
    ham = thh.make_hubbard_holstein(1, 1, U=4.0, nx=3, lmbda=0.5, **CPU)
    trial = tmc.multi_coherent_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1)
    for eopts in ({"back_propagation": {"tau_bp": 0.02}},
                  {"itcf": {"tau_max": 0.02}}):
        with pytest.raises(NotImplementedError, match="multi-coherent"):
            AFQMC(ham, trial, qmc, estimator_options=eopts, device="cpu")
    with pytest.raises(NotImplementedError, match="two_rdm"):
        AFQMC(ham, trial, qmc, estimator_options={
            "mixed": {"two_rdm": "structure_factor"}}, device="cpu")
    rows = AFQMC(ham, trial, qmc, estimator_options={
        "mixed": {"energy_eval_freq": 1, "one_rdm": True}},
        device="cpu").run()
    assert np.isfinite(rows).all()
