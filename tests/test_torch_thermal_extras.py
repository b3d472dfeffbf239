"""Port tests for the Generic thermal inner, the thermal Hartree-Fock
(mean-field) trial and the tau-averaged Green's function against the JAX
package, float64 on the CPU:

* the Generic inner on generate_hamiltonian(4, (2, 2), seed=5, nchol=8):
  the propagator set-up (BH1, mf_shift, chol, mf_const_fac) at 1e-12, the
  force bias and dense_bv (the plain order-6 series) at 1e-10, the
  converter, and two paths of ThermalAFQMC with JAX's draws injected at
  rtol 1e-8;
* ``fock_matrix`` and the host energy for Hubbard, Generic and UEG at
  1e-10; the mean-field entropy; ``make_mean_field_trial`` (mu, the slice
  propagator and its inverse, the left table, P, nav) at 1e-10 for
  Hubbard (mu found, and find_mu=False) and Generic, and its verbose
  grand-potential lines; the converter carrying the trial's name, and two
  paths with the converted JAX trial and JAX's draws at rtol 1e-8;
* ``measure_state`` with ``average_gf`` (and the 1-RDM) on a state after
  one JAX path, at 1e-10;
* a subprocess driving the new paths imports no jax.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import thermal as jth
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models import thermal_trial as jtt
from pauxy_tpu.models.generic import make_generic as j_make_generic
from pauxy_tpu.propagation.thermal import make_thermal_propagator as j_mtp
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu.qmc import thermal_afqmc as jta
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.estimators import thermal as th
from pauxy_tpu_torch.models import make_generic, make_hubbard
from pauxy_tpu_torch.models import thermal_trial as tt
from pauxy_tpu_torch.models.ueg import make_ueg
from pauxy_tpu_torch.propagation.thermal import (ThermalGenericInner,
                                                 make_thermal_propagator)
from pauxy_tpu_torch.qmc import QMCOpts
from pauxy_tpu_torch.qmc import thermal_afqmc as tta
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")
STATE = ("stack", "right", "G", "log_m0", "weight", "unscaled_weight",
         "phase", "total_weight", "hybrid_energy", "pq", "pd", "pt")
TRIAL = ("dmat", "dmat_inv", "left_table", "bin_full")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = np_(a), np_(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def generic_pair():
    h1e, chol, enuc, _ = generate_hamiltonian(4, (2, 2), seed=5, nchol=8)
    return (j_make_generic((2, 2), h1e, chol, enuc),
            make_generic((2, 2), h1e, chol, enuc, **CPU))


def hubbard_pair():
    return (j_make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3),
            make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU))


def jax_path_noise(sub, nslices, nw, nfields):
    xi, pop = [], []
    for key in jax.random.split(sub, nslices):
        kprop, kpop = jax.random.split(key)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nfields),
                                               dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return tta.PathNoise(torch.from_numpy(np.array(xi)),
                         torch.from_numpy(np.array(pop)))


def two_paths(jaf, af, nw):
    key = jax.random.key(jaf.qmc.rng_seed)
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise = jax_path_noise(sub, af.ntime_slices, nw, af.prop.nfields)
        jrow, row = jaf.run_block(), af.run_block(noise)
        np.testing.assert_allclose(row[:11], jrow[:11], rtol=1e-8,
                                   atol=1e-10)
        assert np.isfinite(row).all()


# ------------------------------------------------------------ Generic ---

def test_generic_inner_matches_jax():
    jham, ham = generic_pair()
    kw = dict(beta=0.5, dt=0.05, mu=0.1)
    jt = jtt.make_one_body_trial(jham, **kw)
    t = tt.make_one_body_trial(ham, **kw, **CPU)
    jp, p = j_mtp(jham, jt, 0.05), make_thermal_propagator(ham, t, 0.05,
                                                          **CPU)
    assert isinstance(p.inner, ThermalGenericInner)
    for name in ("BH1", "mf_shift", "chol"):
        assert rel(getattr(p.inner, name), getattr(jp.inner, name)) < 1e-12
    assert p.mf_const_fac == pytest.approx(jp.mf_const_fac, rel=1e-12)
    rng = np.random.default_rng(4)
    pm = rng.normal(size=(3, 2, 4, 4)) + 1j * rng.normal(size=(3, 2, 4, 4))
    assert rel(p.inner.force_bias_P(torch.from_numpy(pm)),
               jp.inner.force_bias_P(jnp.asarray(pm))) < 1e-10
    x = rng.normal(size=(3, 8)) + 0.1j * rng.normal(size=(3, 8))
    assert rel(p.inner.dense_bv(torch.from_numpy(x)),
               jp.inner.dense_bv(jnp.asarray(x))) < 1e-10
    conv = convert.thermal_propagator(
        "generic", np.asarray(jp.inner.BH1), np.asarray(jp.inner.mf_shift),
        chol=np.asarray(jp.inner.chol), dt=jp.dt,
        mf_const_fac=jp.mf_const_fac, device="cpu")
    for name in ("BH1", "mf_shift", "chol"):
        assert np.array_equal(np_(getattr(conv.inner, name)),
                              np.asarray(getattr(jp.inner, name)))


def test_generic_two_paths_match_jax(tmp_path):
    jham, ham = generic_pair()
    kw = dict(beta=0.5, dt=0.05, mu=0.1)
    nw = 8
    opts = dict(nwalkers=nw, dt=0.05, nsteps=1, nblocks=2, beta=0.5,
                npop_control=2, rng_seed=7)
    jaf = jta.ThermalAFQMC(jham, jtt.make_one_body_trial(jham, **kw),
                           JQMCOpts(**opts), filename=str(tmp_path / "j.h5"))
    af = tta.ThermalAFQMC(ham, tt.make_one_body_trial(ham, **kw, **CPU),
                          QMCOpts(**opts), device="cpu")
    assert af.prop.nfields == 8
    two_paths(jaf, af, nw)


# --------------------------------------------------------- mean field ---

def test_fock_matrices_and_entropy_match_jax():
    """The Fock matrices, and the host energy the mean-field log reads
    (its UEG branch is the batched kernel on one walker)."""
    rng = np.random.default_rng(2)
    for jham, ham in (hubbard_pair(), generic_pair(),
                      (j_make_ueg(nup=1, ndown=1, rs=1.0, ecut=1.0),
                       make_ueg(1, 1, rs=1.0, ecut=1.0, **CPU))):
        m = ham.nbasis
        p = rng.normal(size=(2, m, m))
        p = 0.5 * (p + p.transpose(0, 2, 1))
        assert rel(tt.fock_matrix(ham, p), jtt.fock_matrix(jham, p)) < 1e-10
        g = np.eye(m)[None] - p.transpose(0, 2, 1)
        assert rel(np.array(le.local_energy_G_host(ham, g), complex),
                   np.array(jle.local_energy_G_host(jham, g), complex)) \
            < 1e-10
    h1 = np.stack([np.diag(rng.normal(size=6))] * 2)
    assert th.entropy(2.0, 0.1, h1) == pytest.approx(
        jth.entropy(2.0, 0.1, h1), rel=1e-12)


@pytest.mark.parametrize("system,kw", [
    ("hubbard", dict(beta=1.0, dt=0.05, nav=6.0)),
    ("hubbard", dict(beta=0.5, dt=0.05, mu=0.3, find_mu=False)),
    ("generic", dict(beta=0.5, dt=0.05, nav=4.0))])
def test_mean_field_trial_matches_jax(system, kw):
    jham, ham = hubbard_pair() if system == "hubbard" else generic_pair()
    jt = jtt.make_mean_field_trial(jham, **kw)
    t = tt.make_mean_field_trial(ham, **kw, **CPU)
    assert t.name == jt.name == "mean_field"
    assert t.mu == pytest.approx(jt.mu, abs=1e-10)
    if not kw.get("find_mu", True):
        assert t.mu == 0.3
    assert t.nav == pytest.approx(jt.nav, abs=1e-10)
    assert (t.stack_size, t.num_slices) == (jt.stack_size, jt.num_slices)
    for name in TRIAL:
        assert rel(getattr(t, name), getattr(jt, name)) < 1e-10, name
    assert rel(t.P_host, jt.P_host.arr) < 1e-10
    assert rel(t.G_host, jt.G_host.arr) < 1e-10


def omegas(text):
    return [float(x) for x in re.findall(r"Omega = (\S+)", text)]


def test_mean_field_verbose_log_matches_jax(capsys):
    jham, ham = hubbard_pair()
    jtt.make_mean_field_trial(jham, 0.5, 0.05, verbose=True)
    want = omegas(capsys.readouterr().out)
    tt.make_mean_field_trial(ham, 0.5, 0.05, verbose=True, **CPU)
    got = omegas(capsys.readouterr().out)
    assert len(got) == len(want) > 1
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_mean_field_trial_converts_and_runs_like_jax(tmp_path):
    """JAX's mean-field trial carried over by the converter; two paths of
    the continuous Hubbard propagator at the system mu 0.9."""
    jham, ham = hubbard_pair()
    jt = jtt.make_mean_field_trial(jham, 0.5, 0.05, nav=6.0)
    t = convert.one_body_trial(
        *(np.asarray(getattr(jt, k)) for k in TRIAL), mu=jt.mu,
        beta=jt.beta, dt=jt.dt, num_slices=jt.num_slices,
        stack_size=jt.stack_size, nav=jt.nav, P_host=jt.P_host.arr,
        G_host=jt.G_host.arr, name=jt.name, device="cpu")
    assert t.name == "mean_field"
    nw = 8
    opts = dict(nwalkers=nw, dt=0.05, nsteps=1, nblocks=2, beta=0.5,
                npop_control=2, rng_seed=8)
    popts = {"mu": 0.9}
    jaf = jta.ThermalAFQMC(jham, jt, JQMCOpts(**opts),
                           propagator_options=popts,
                           filename=str(tmp_path / "j.h5"))
    af = tta.ThermalAFQMC(ham, t, QMCOpts(**opts), propagator_options=popts,
                          device="cpu")
    two_paths(jaf, af, nw)


# --------------------------------------------------------- average_gf ---

def test_measure_state_average_gf_matches_jax(tmp_path):
    jham, ham = hubbard_pair()
    kw = dict(beta=0.5, dt=0.05, mu=0.9, stack_size=2)
    jt = jtt.make_one_body_trial(jham, **kw)
    t = tt.make_one_body_trial(ham, **kw, **CPU)
    jaf = jta.ThermalAFQMC(jham, jt, JQMCOpts(
        nwalkers=6, dt=0.05, nsteps=1, nblocks=1, beta=0.5, npop_control=2,
        rng_seed=4), filename=str(tmp_path / "j.h5"))
    jstate, _ = jta.run_path(
        jaf.ham, jaf.trial, jaf.prop, jaf.state, jax.random.key(4),
        ntime_slices=jt.num_slices, npop_control=2, pop_method="comb",
        target_weight=6.0)
    assert jt.nbins == 5
    state = convert.thermal_walker_state(
        **{k: np.asarray(getattr(jstate, k)) for k in STATE}, device="cpu")
    for one_rdm in (False, True):
        want = np.asarray(jta.measure_state(jham, jt, jstate, one_rdm, True))
        got = tta.measure_state(ham, t, state, one_rdm, True)
        assert rel(got, want) < 1e-10
        plain = tta.measure_state(ham, t, state, one_rdm)
        assert rel(plain, want) > 1e-6     # the average is not one origin
    # The stack is rolled on a copy: the state is unchanged.
    assert np.array_equal(np_(state.stack), np.asarray(jstate.stack))


def test_new_thermal_paths_import_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from pauxy_tpu_torch.models import (make_generic, make_hubbard, "
        "make_mean_field_trial, make_one_body_trial, make_ueg)\n"
        "from pauxy_tpu_torch.qmc import QMCOpts, ThermalAFQMC\n"
        "cpu = dict(device='cpu', dtype='double')\n"
        "q = QMCOpts(nwalkers=2, dt=0.05, nsteps=1, nblocks=1, beta=0.1)\n"
        "ueg = make_ueg(1, 1, rs=1.0, ecut=0.5, **cpu)\n"
        "ThermalAFQMC(ueg, make_one_body_trial(ueg, 0.1, 0.05, mu=0.245, "
        "**cpu), q, walker_options={'low_rank': True}, "
        "device='cpu').run()\n"
        "hub = make_hubbard(1, 1, U=4.0, nx=2, ny=1, **cpu)\n"
        "mf = make_mean_field_trial(hub, 0.1, 0.05, **cpu)\n"
        "for fp in (False, True):\n"
        "    ThermalAFQMC(hub, mf, q, propagator_options={"
        "'hubbard_stratonovich': 'discrete', 'free_projection': fp}, "
        "estimator_options={'mixed': {'average_gf': True}}, "
        "device='cpu').run()\n"
        "rng = np.random.default_rng(0)\n"
        "chol = rng.normal(size=(3, 3, 4)) * 0.1\n"
        "chol = chol + chol.transpose(1, 0, 2)\n"
        "gen = make_generic((1, 1), np.diag([-1.0, 0.0, 1.0]), chol, **cpu)\n"
        "ThermalAFQMC(gen, make_one_body_trial(gen, 0.1, 0.05, mu=0.0, "
        "**cpu), q, device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)
