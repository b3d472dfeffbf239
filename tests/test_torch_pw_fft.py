"""Port parity: the PW_FFT (FFT-grid UEG) path against JAX.

float64 on the CPU, the same seeded numpy inputs through both packages,
1e-10 relative to the largest reference entry (set-up tables 1e-12):
  * ``make_pw_fft``'s tables and maps exactly, and ``convert.pw_fft_system``
    giving the same buffers;
  * the free-electron trial's energy (the host energy by the gather kernels
    on the system's cube lookup) against JAX's host loops;
  * ``local_energy_pw_fft`` against JAX's, and against the dense UEG
    energy of the same Hamiltonian (the UEG's basis order mapped);
  * ``make_pw_fft_inner``: BH1, vqfac, the trial's cube transforms; its
    force bias and apply_vhs (one FFT convolution an order);
  * two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
    with JAX's normals injected, rtol 1e-8 / atol 1e-10 on the
    accumulators, weights and walkers;
  * AFQMC runs PW_FFT on the CPU when asked and raises without a card by
    default; back propagation's structure factor stays UEG-only; the run
    pulls in no jax.
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
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.models.pw_fft import make_pw_fft as j_make_pw_fft
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.pw_fft import make_pw_fft_inner as j_mpi
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import (free_electron_trial, make_pw_fft,
                                    make_ueg, trial_from_orbitals)
from pauxy_tpu_torch.ops import greens as tgreens
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.propagation.pw_fft import make_pw_fft_inner
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")
INNER_FIELDS = ("BH1", "vqfac", "vq_sqrtdt", "gmap", "qmap", "ct_f_a",
                "ct_if_a", "ct_f_b", "ct_if_b")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, tol=1e-10):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def t(x):
    return torch.from_numpy(np.array(x))


def pw_system(nup=7, ndown=7, ecut=1.0):
    jham = j_make_pw_fft(nup=nup, ndown=ndown, rs=1.0, ecut=ecut)
    jt = jtrial.free_electron_trial(jham)
    ham = convert.pw_fft_system(
        *(np.asarray(getattr(jham, k)) for k in ("sp_eigv", "h1e_mod",
                                                 "vqvec", "gmap", "qmap")),
        basis=np.asarray(jham.basis), qvecs=np.asarray(jham.qvecs),
        qmesh=jham.qmesh, rs=jham.rs, ecut=jham.ecut, vol=jham.vol,
        kfac=jham.kfac, ecore=jham.ecore, nup=jham.nup, ndown=jham.ndown,
        nmax=jham.nmax, device="cpu")
    tt = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       device="cpu")
    return jham, jt, ham, tt


def walkers(rng, psi, nw, scale=0.2):
    m, n = psi.shape
    return np.asarray(psi)[None] + scale * (
        rng.normal(size=(nw, m, n)) + 1j * rng.normal(size=(nw, m, n)))


def test_system_tables_match_jax():
    jham, jt, conv, _ = pw_system()
    ham = make_pw_fft(7, 7, rs=1.0, ecut=1.0, **CPU)
    for name in ("sp_eigv", "h1e_mod", "vqvec", "gmap", "qmap"):
        np.testing.assert_array_equal(np_(getattr(ham, name)),
                                      np.asarray(getattr(jham, name)))
    for name, buf in ham.named_buffers():
        assert torch.equal(getattr(conv, name), buf), name
    np.testing.assert_array_equal(ham.basis, np.asarray(jham.basis))
    np.testing.assert_array_equal(ham.qvecs, np.asarray(jham.qvecs))
    assert ham.qmesh == tuple(jham.qmesh)
    for name in ("vol", "kfac", "ecore", "ef", "nbasis", "nq", "nfields",
                 "nmax"):
        assert getattr(ham, name) == getattr(jham, name), name
    close(ham.T, np.asarray(jham.T), 0)


def test_free_electron_trial_energy_matches_jax():
    jham, jt, _, _ = pw_system()
    ham = make_pw_fft(7, 7, rs=1.0, ecut=1.0, **CPU)
    trial = free_electron_trial(ham, **CPU)
    close(trial.psia, jt.psia, 0)
    assert trial.etrial == pytest.approx(jt.etrial, rel=1e-12)
    # A non-trivial G: the host energy against JAX's explicit loops.
    rng = np.random.default_rng(2)
    psi = np.linalg.qr(rng.normal(size=(ham.nbasis, 7))
                       + 1j * rng.normal(size=(ham.nbasis, 7)))[0]
    g = trial_from_orbitals(ham, np.concatenate([psi, psi[:, :4]], 1),
                            **CPU).G_host
    jg = np.asarray(jle.local_energy_G_host(jham, g))
    close(np.array(tle.local_energy_G_host(ham, g)), jg)


@pytest.mark.parametrize("nelec", [(7, 7), (3, 1)])
def test_local_energy_pw_fft_matches_jax(nelec):
    jham, jt, ham, tt = pw_system(*nelec)
    rng = np.random.default_rng(sum(nelec))
    phia = walkers(rng, jt.psia, 3)
    phib = walkers(rng, jt.psib, 3)
    jga = jgreens.greens_function(jnp.asarray(phia), jt.psia)
    jgb = jgreens.greens_function(jnp.asarray(phib), jt.psib)
    tga = tgreens.greens_function(t(phia), tt.psia, want_g=False)
    tgb = tgreens.greens_function(t(phib), tt.psib, want_g=False)
    want = jle.local_energy_pw_fft(jham, jt, jga.Ghalf, jgb.Ghalf)
    got = tmixed.energy_estimator(ham, tt)(tga, tgb)
    for a, b in zip(got, want):
        close(a, b)
    assert not tmixed.needs_full_g(ham)
    # The dense UEG energy of the same Hamiltonian, the basis order mapped.
    ueg = make_ueg(*nelec, rs=1.0, ecut=1.0, **CPU)
    lut = {tuple(k): i for i, k in enumerate(ham.basis)}
    perm = np.array([lut[tuple(k)] for k in ueg.basis])
    ga = tgreens.greens_function(t(phia), tt.psia).G
    gb = tgreens.greens_function(t(phib), tt.psib).G
    dense = tle.local_energy_ueg(ueg, ga[:, perm][:, :, perm],
                                 gb[:, perm][:, :, perm])
    for a, b in zip(got, dense):
        close(a, b, 1e-9)


def port_inner(jinner):
    return convert.pw_fft_inner(
        *(np.asarray(getattr(jinner, k)) for k in INNER_FIELDS),
        qmesh=jinner.qmesh, sqrt_dt=jinner.sqrt_dt,
        exp_order=jinner.exp_order, device="cpu")


def test_inner_setup_force_bias_and_vhs_match_jax():
    jham, jt, ham, tt = pw_system()
    jinner = j_mpi(jham, jt, 0.05)
    inner = make_pw_fft_inner(ham, tt, 0.05, **CPU)
    conv = port_inner(jinner)
    for name in INNER_FIELDS + ("mf_shift",):
        close(getattr(inner, name), np.asarray(getattr(jinner, name)), 1e-12)
        assert torch.equal(getattr(conv, name), getattr(inner, name)) or \
            name in ("BH1",), name
    close(conv.BH1, inner.BH1, 1e-15)
    assert inner.qmesh == jinner.qmesh and not inner.uses_full_g
    rng = np.random.default_rng(7)
    nw = 3
    phia, phib = walkers(rng, jt.psia, nw), walkers(rng, jt.psib, nw)
    jga = jgreens.greens_function(jnp.asarray(phia), jt.psia)
    jgb = jgreens.greens_function(jnp.asarray(phib), jt.psib)
    tga = tgreens.greens_function(t(phia), tt.psia, want_g=False)
    tgb = tgreens.greens_function(t(phib), tt.psib, want_g=False)
    close(inner.force_bias(tt, tga, tgb),
          jinner.force_bias(jt, jga, jgb))
    x = rng.normal(size=(nw, ham.nfields)) + 0.1j * rng.normal(
        size=(nw, ham.nfields))
    a, b = inner.apply_vhs(t(phia), t(phib), t(x))
    ja, jb = jinner.apply_vhs(jnp.asarray(phia), jnp.asarray(phib),
                              jnp.asarray(x))
    close(a, ja)
    close(b, jb)


def jax_noise(block_key, nsteps, nw, nf):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nf),
                                               dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


def test_pw_fft_blocks_match_jax():
    jham, jt, ham, tt = pw_system(3, 3)
    dt, nw, nsteps = 0.01, 6, 5
    jinner = j_mpi(jham, jt, dt)
    jprop = JContinuous(inner=jinner, dt=dt)
    tprop = Continuous(inner=port_inner(jinner), dt=dt)
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    ts = init_walkers(tt, nw, total_weight=float(nw))
    opts = dict(nsteps=nsteps, nstblz=5, npop_control=1, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(51 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(nsteps * block, jnp.int32), free_projection=False,
            **opts)
        ts, tacc, _, _ = tafqmc.run_block(
            ham, tt, tprop, ts, None, eshift, nsteps * block,
            noise=jax_noise(key, nsteps, nw, jham.nfields), **opts)
        # Real parts: the hybrid energy's imaginary part carries JAX's
        # unwrapped CPU log-det branch.
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


def test_afqmc_runs_pw_fft_and_refuses_what_jax_refuses():
    ham = make_pw_fft(2, 2, rs=1.0, ecut=0.5, **CPU)
    trial = free_electron_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=6, dt=0.01, nsteps=4, nblocks=2, nstblz=2,
                  npop_control=1, rng_seed=4)
    af = AFQMC(ham, trial, qmc, propagator_options={"expansion_order": 4},
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               device="cpu")
    assert af.prop.inner.exp_order == 4
    rows = af.run()
    assert rows.shape == (2, 11) and np.isfinite(rows).all()
    with pytest.raises(NotImplementedError, match="UEG-only"):
        AFQMC(ham, trial, qmc, estimator_options={"back_propagation": {
            "tau_bp": 0.02, "two_rdm": "structure_factor"}}, device="cpu")
    with pytest.raises(NotImplementedError):
        AFQMC(ham, trial, qmc,
              propagator_options={"hubbard_stratonovich": "discrete"},
              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AFQMC(ham, trial, qmc)


def test_pw_fft_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import make_pw_fft, "
        "free_electron_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "ham = make_pw_fft(2, 2, rs=1.0, ecut=0.5, device='cpu', "
        "dtype='double')\n"
        "t = free_electron_trial(ham, device='cpu', dtype='double')\n"
        "AFQMC(ham, t, QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),"
        " device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
