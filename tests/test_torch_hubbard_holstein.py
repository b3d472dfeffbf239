"""Port parity: the Hubbard-Holstein model, its coherent-state and
Lang-Firsov trials and the DMC phonon propagator, against JAX.

float64, the same inputs on both sides (numpy from a seed; each package
builds its own system and trial from the same parameters):
  * make_hubbard_holstein (T, h1e_mod, eks, g, m, gsq2mw), the
    coherent-state trial (orbitals, shift, etrial), the Lang-Firsov
    parameters, energy and trial (gamma, orbitals, etrial): 1e-10;
  * the harmonic-oscillator helpers, the HH local energy, the host energy
    and the mixed estimator's step: 1e-10;
  * the propagator's pieces with JAX's draws (uniform(k1, (M, w)),
    normal(k2, (w, M))): the electron half-step, the sweep (the sweep
    kernel's plain version against JAX's pallas_interpret) and the phonon
    move: 1e-10, fields identical;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws (the
    plain step, symmetric_trotter, lang_firsov; JAX's scan sweep, which it
    takes with several devices, against the sweep kernel's plain
    version; JAX's log-det phase wrapped into (-pi, pi] as its TPU kernel
    and kernel B give it): rtol 1e-8;
  * the anchors of tests/test_hubbard_holstein.py on the CPU: the
    single-site polaron (plain and symmetric_trotter) within 0.05 of
    U - 4 g^2 / w0, g = 0 within 0.3 of the Hubbard FCI, a finite
    Lang-Firsov run with positive weights;
  * the device rule and no jax in a Hubbard-Holstein run.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import hubbard_holstein as jhh
from pauxy_tpu.ops import clinalg as jclinalg
from pauxy_tpu.propagation.hirsch_dmc import make_hirsch_dmc as j_make_dmc
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import ci
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import hubbard_holstein as thh
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.propagation.hirsch_dmc import DMCDraws, make_hirsch_dmc
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def pair(nup=2, ndown=2, nx=4, ny=1, **kw):
    """The same system built by each package."""
    args = dict(nup=nup, ndown=ndown, U=kw.pop("U", 4.0), nx=nx, ny=ny, **kw)
    return jhh.make_hubbard_holstein(**args), \
        thh.make_hubbard_holstein(**args, **CPU)


# --------------------------------------------------------- construction ---

@pytest.mark.parametrize("kw", [dict(nx=4, w0=0.8, lmbda=0.5),
                                dict(nx=3, ny=2, lmbda=0.25, xpbc=False),
                                dict(nx=1, g=0.5, xpbc=False, nup=1,
                                     ndown=1)])
def test_system_and_coherent_trial_match_jax(kw):
    jham, tham = pair(**kw)
    for key in ("T", "h1e_mod", "eks"):
        close(getattr(tham, key).numpy(), getattr(jham, key))
    for key in ("g", "m", "w0", "U", "gsq2mw", "nbasis", "nfields"):
        assert getattr(tham, key) == pytest.approx(getattr(jham, key),
                                                   rel=1e-12)
    jt = jhh.coherent_state_trial(jham)
    tt = thh.coherent_state_trial(tham, **CPU)
    for key in ("psia", "psib", "shift", "inita", "initb"):
        close(getattr(tt, key).numpy(), getattr(jt, key))
    close(tt.G_host, np.asarray(jt.G_host.arr))
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10, abs=1e-12)
    assert tt.name == "coherent_state"


def test_lang_firsov_matches_jax():
    jham, tham = pair(nx=4, w0=1.0, lmbda=0.5)
    jg, ju = jhh._lf_params(jham)
    tg, tu = thh._lf_params(tham)
    assert (tg, tu) == pytest.approx((jg, ju), rel=1e-12)
    rng = np.random.default_rng(3)
    psia = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    psib = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    gam = rng.uniform(0.5, 1.5, size=4)
    assert thh.lang_firsov_energy(tham, psia, psib, gam) == pytest.approx(
        jhh.lang_firsov_energy(jham, psia, psib, gam), rel=1e-10)
    for relax in (False, True):
        jt, jgam = jhh.lang_firsov_trial(jham, relax_gamma=relax)
        tt, tgam = thh.lang_firsov_trial(tham, relax_gamma=relax, **CPU)
        close(tgam, jgam)
        close(tt.psia.numpy(), jt.psia)
        close(tt.psib.numpy(), jt.psib)
        close(tt.shift.numpy(), jt.shift)
        assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
        assert tt.name == "lang_firsov"


# ------------------------------------------------------------ energies ---

def test_oscillator_helpers_and_energies_match_jax():
    jham, tham = pair(nx=3, ny=2, lmbda=0.4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 6))
    shift = rng.standard_normal(6)
    for name in ("ho_log_value", "ho_gradient", "ho_laplacian",
                 "ho_local_energy"):
        close(getattr(thh, name)(t(x), tham.m, tham.w0, t(shift)).numpy(),
              getattr(jhh, name)(jnp.asarray(x), jham.m, jham.w0,
                                 jnp.asarray(shift)))
    ga = rng.standard_normal((5, 6, 6)) + 1j * rng.standard_normal((5, 6, 6))
    gb = rng.standard_normal((5, 6, 6)) + 1j * rng.standard_normal((5, 6, 6))
    got = tle.local_energy_hubbard_holstein(tham, t(ga), t(gb), t(x),
                                            t(shift))
    want = jle.local_energy_hubbard_holstein(jham, jnp.asarray(ga),
                                             jnp.asarray(gb),
                                             jnp.asarray(x),
                                             jnp.asarray(shift))
    for a, b in zip(got, want):
        close(a.numpy(), b)
    g2 = np.stack([ga[0], gb[0]])
    close(np.array(tle.local_energy_G_host(tham, g2)),
          np.array(jle.local_energy_G_host(jham, g2)))


def test_mixed_update_matches_jax():
    jham, tham = pair(nx=4, lmbda=0.3)
    jt = jhh.coherent_state_trial(jham)
    tt = thh.coherent_state_trial(tham, **CPU)
    js = j_init_walkers(jt, 6, phonon_mw=jham.m * jham.w0,
                        phonon_key=jax.random.key(4))
    rng = np.random.default_rng(6)
    pa = np.asarray(js.phia) + 0.1 * rng.standard_normal((6, 4, 2))
    pb = np.asarray(js.phib) + 0.1 * rng.standard_normal((6, 4, 2))
    js = js.replace(phia=jnp.asarray(pa), phib=jnp.asarray(pb),
                    weight=jnp.asarray(rng.uniform(0.5, 1.5, 6)))
    ts = init_walkers(tt, 6, X0=t(js.X))
    ts.phia, ts.phib, ts.weight = t(pa), t(pb), t(js.weight)
    for rdm in (False, True):
        close(tmixed.update(tham, tt, ts, True, calc_one_rdm=rdm).numpy(),
              jmixed.update(jham, jt, js, True, calc_one_rdm=rdm))


# --------------------------------------------------------- propagation ---

def walkers_pair(jt, tt, jham, nw, seed=9):
    js = j_init_walkers(jt, nw, total_weight=float(nw),
                        phonon_mw=jham.m * jham.w0,
                        phonon_key=jax.random.key(seed))
    ts = init_walkers(tt, nw, total_weight=float(nw), X0=t(js.X))
    close(ts.log_ovlp.numpy(), js.log_ovlp)
    close(ts.X.numpy(), js.X, 0)
    return js, ts


def same(ts, js, fields=("phia", "phib", "weight", "log_ovlp", "X"),
         tol=1e-10):
    for f in fields:
        close(getattr(ts, f).numpy(), getattr(js, f), tol)


@pytest.mark.parametrize("lf", [False, True])
def test_propagator_pieces_match_jax(lf):
    jham, tham = pair(nx=4, ny=1, lmbda=0.4)
    jt = jhh.coherent_state_trial(jham)
    tt = thh.coherent_state_trial(tham, **CPU)
    jprop = j_make_dmc(jham, jt, 0.02, lang_firsov=lf)
    # JAX takes its scan sweep with several (virtual) devices; its Pallas
    # kernel, in interpret mode, is the one the sweep kernel ports.
    jprop = jprop.replace(hirsch=jprop.hirsch.replace(
        sweep_kernel="pallas_interpret"))
    tprop = make_hirsch_dmc(tham, tt, 0.02, lang_firsov=lf, **CPU)
    assert tprop.hirsch.sweep_kernel == "kernel"
    close(tprop.BT_half.numpy(), jprop.BT_half)
    close(tprop.hirsch.auxf.numpy(), jprop.hirsch.auxf)
    assert tprop.eshift_boson == pytest.approx(jprop.eshift_boson,
                                               rel=1e-12)
    assert tprop.cpl == pytest.approx(jprop.cpl, rel=1e-12)
    js, ts = walkers_pair(jt, tt, jham, 7)
    js = jprop._electron_half_step(jt, js, 0.01)
    ts = tprop._electron_half_step(tt, ts, 0.01)
    same(ts, js)
    k1, k2 = jax.random.split(jax.random.key(3))
    js, jf = jprop.hirsch._site_sweep(jt, js, k1)
    ts, tf = tprop.hirsch._site_sweep(
        tt, ts, rs=t(jax.random.uniform(k1, (4, 7), dtype=jnp.float64)))
    same(ts, js)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    js = jprop._boson_move(jt, js, k2, 0.02)
    ts = tprop._boson_move(tt, ts, 0.02, normals=t(
        jax.random.normal(k2, (7, 4), dtype=jnp.float64)))
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


def blocks_match(jham, tham, jt, tt, popts, nw=8, nsteps=5, seed=41):
    jprop = j_make_dmc(jham, jt, 0.02, **popts)
    tprop = make_hirsch_dmc(tham, tt, 0.02, **popts, **CPU)
    js, ts = walkers_pair(jt, tt, jham, nw)
    opts = dict(nsteps=nsteps, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(seed + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(nsteps * block, jnp.int32), free_projection=False,
            **opts)
        noise = hh_noise(key, nsteps, nw, tham.nbasis,
                         popts.get("symmetric_trotter", False))
        ts, tacc, _, _ = tafqmc.run_block(tham, tt, tprop, ts, None, eshift,
                                          nsteps * block, noise=noise,
                                          **opts)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib", "log_ovlp", "X"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


@pytest.fixture
def tpu_branch(monkeypatch):
    """JAX's log-determinant with arg det wrapped into (-pi, pi], the
    branch of its TPU kernel (and of the port's kernel B); JAX's CPU
    route sums the pivots' phases unwrapped. The jit caches are cleared
    on both sides of the test."""
    slogdet = jclinalg.slogdet

    def wrapped(s):
        ld = slogdet(s)
        return (ld.real + 1j * jnp.angle(jnp.exp(1j * ld.imag))).astype(
            ld.dtype)

    jax.clear_caches()
    monkeypatch.setattr(jclinalg, "slogdet", wrapped)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("popts", [{}, {"symmetric_trotter": True},
                                   {"lang_firsov": True}])
def test_blocks_match_jax(popts, tpu_branch):
    jham, tham = pair(nx=3, ny=2, lmbda=0.3)
    if popts.get("lang_firsov"):
        jt, _ = jhh.lang_firsov_trial(jham)
        tt, _ = thh.lang_firsov_trial(tham, **CPU)
    else:
        jt = jhh.coherent_state_trial(jham)
        tt = thh.coherent_state_trial(tham, **CPU)
    blocks_match(jham, tham, jt, tt, popts)


def test_converted_propagator_equals_built_one():
    jham, tham = pair(nx=4, lmbda=0.3)
    jt = jhh.coherent_state_trial(jham)
    jprop = j_make_dmc(jham, jt, 0.02, symmetric_trotter=True)
    h = jprop.hirsch
    conv = convert.hirsch_dmc(
        convert.hirsch(np.asarray(h.BT2), np.asarray(h.auxf),
                       np.asarray(h.aux_wfac), dt=h.dt, charge=h.charge,
                       gamma=h.gamma, sweep_kernel="kernel", device="cpu"),
        np.asarray(jprop.BT_half), dt=jprop.dt, m=jprop.m, w0=jprop.w0,
        cpl=jprop.cpl, eshift_boson=jprop.eshift_boson,
        symmetric_trotter=True, device="cpu")
    tt = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       shift=np.asarray(jt.shift), device="cpu")
    cham = convert.hubbard_holstein(
        np.asarray(jham.T), jham.U, g=jham.g, w0=jham.w0, m=jham.m,
        lmbda=jham.lmbda, nx=jham.nx, ny=jham.ny, nup=jham.nup,
        ndown=jham.ndown, device="cpu")
    for key in ("T", "h1e_mod", "eks"):
        close(getattr(cham, key).numpy(), getattr(tham, key).numpy(), 0)
    built = make_hirsch_dmc(cham, tt, 0.02, symmetric_trotter=True, **CPU)
    close(conv.BT_half.numpy(), built.BT_half.numpy())
    close(conv.hirsch.BT2.numpy(), built.hirsch.BT2.numpy())
    assert conv.eshift_boson == pytest.approx(built.eshift_boson)
    js = j_init_walkers(jt, 3, phonon_mw=1.0, phonon_key=jax.random.key(1))
    st = convert.walker_state(
        **{k: np.asarray(getattr(js, k)) for k in (
            "phia", "phib", "weight", "unscaled_weight", "log_ovlp",
            "hybrid_energy", "log_detr", "total_weight", "X")},
        device="cpu")
    close(st.X.numpy(), js.X, 0)


# ------------------------------------------------------------ anchors ---

@pytest.mark.parametrize("symmetric", [False, True])
def test_single_site_polaron_exact(symmetric):
    """One site, (1, 1): E = U - 4 g^2 / w0 (the zero-point energy
    excluded)."""
    ham = thh.make_hubbard_holstein(1, 1, U=4.0, nx=1, g=0.5, w0=1.0,
                                    xpbc=False, **CPU)
    af = AFQMC(ham, thh.coherent_state_trial(ham, **CPU),
               QMCOpts(nwalkers=200, dt=0.01, nsteps=20, nblocks=8,
                       nstblz=10, npop_control=10, rng_seed=7),
               propagator_options={"symmetric_trotter": symmetric},
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               device="cpu")
    assert af.prop.symmetric_trotter == symmetric
    rows = af.run()
    assert abs(rows[3:, 5].real.mean() - (4.0 - 4 * 0.5 ** 2)) < 0.05


def test_g0_matches_hubbard_fci():
    hh = thh.make_hubbard_holstein(2, 2, U=4.0, nx=4, g=0.0, w0=1.0,
                                   xpbc=False, **CPU)
    rows = AFQMC(hh, thh.coherent_state_trial(hh, **CPU),
                 QMCOpts(nwalkers=100, dt=0.01, nsteps=20, nblocks=12,
                         nstblz=5, npop_control=5, rng_seed=5),
                 estimator_options={"mixed": {"energy_eval_freq": 2}},
                 device="cpu").run()
    assert np.isfinite(rows.real).all()
    e_fci = ci.simple_fci(make_hubbard(2, 2, U=4.0, nx=4, xpbc=False,
                                       **CPU))[0][0]
    assert abs(rows[6:, 5].real.mean() - e_fci) < 0.3


def test_lang_firsov_run_stays_finite():
    ham = thh.make_hubbard_holstein(2, 2, U=4.0, nx=4, w0=1.0, lmbda=0.25,
                                    **CPU)
    trial, _ = thh.lang_firsov_trial(ham, **CPU)
    af = AFQMC(ham, trial, QMCOpts(nwalkers=16, dt=0.01, nsteps=5,
                                   nblocks=3, rng_seed=2),
               propagator_options={"lang_firsov": True},
               estimator_options={"mixed": {"energy_eval_freq": 5}},
               device="cpu")
    rows = af.run()
    assert np.isfinite(rows).all() and (rows[:, 2].real > 0).all()


# --------------------------------------------------------------- AFQMC ---

def test_device_rule_and_refusals():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thh.make_hubbard_holstein(1, 1, U=4.0, nx=2)
    ham = thh.make_hubbard_holstein(1, 1, U=4.0, nx=2, **CPU)
    trial = thh.coherent_state_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AFQMC(ham, trial, qmc)
    with pytest.raises(NotImplementedError, match="Hubbard-Holstein"):
        AFQMC(ham, trial, qmc, estimator_options={
            "back_propagation": {"tau_bp": 0.02}}, device="cpu")
    from pauxy_tpu_torch.models import free_electron_trial
    with pytest.raises(ValueError, match="shift"):
        make_hirsch_dmc(ham, free_electron_trial(make_hubbard(
            1, 1, U=4.0, nx=2, **CPU), **CPU), 0.01, **CPU)
    af = AFQMC(ham, trial, qmc, device="cpu")
    assert not af.use_fast_block and af.state.X.shape == (4, 2)


def test_hubbard_holstein_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import (make_hubbard_holstein,"
        " coherent_state_trial, multi_coherent_trial)\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "kw = dict(device='cpu', dtype='double')\n"
        "ham = make_hubbard_holstein(1, 1, U=4.0, nx=3, lmbda=0.5, **kw)\n"
        "for tr in (coherent_state_trial(ham, **kw),"
        " multi_coherent_trial(ham, **kw)):\n"
        "    AFQMC(ham, tr, QMCOpts(nwalkers=4, dt=0.01, nsteps=2,"
        " nblocks=1), device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
