"""Port parity: the multi-determinant GHF trial and the Hirsch GHF step
against JAX.

float64, the same inputs on both sides (numpy from a seed; JAX objects
built from the port's arrays or carried across with
pauxy_tpu_torch.utils.convert):
  * make_ghf_trial (with and without an initial walker),
    ghf_trial_from_uhf, ghf_trial_from_files / read_fortran_complex_numbers,
    ghf_variational_energy and the host local energy: 1e-10;
  * ghf_overlap_matrices, ghf_log_overlap, ghf_greens_function,
    local_energy_hubbard_ghf and mixed.update on random spin-mixing
    determinants and block-diagonal walkers: 1e-10;
  * the GHF kinetic half-step and the site sweep (the joint two-row ratio,
    the two sequential Sherman-Morrison updates) with JAX's uniforms
    uniform(key, (M, w)): walkers, weights, overlaps at 1e-10, fields
    identical;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws
    injected (spin and charge decomposition), rtol 1e-8 / atol 1e-10; the
    D = 1 embedding of a UHF trial against the UHF block (the sweep
    kernel's route) with the same uniforms;
  * AFQMC(...).run() with a GHF trial, the refusals JAX keeps (continuous
    HS, back propagation, the mixed RDMs), and no jax import.
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
from pauxy_tpu.models import ghf as jghf
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.propagation.hirsch import make_hirsch as j_make_hirsch
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.transfer import to_device
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import ghf as tghf
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.propagation.hirsch import make_hirsch
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")

j_greens = jax.jit(jghf.ghf_greens_function)
j_log_overlap = jax.jit(jghf.ghf_log_overlap)
j_energy = jax.jit(jle.local_energy_hubbard_ghf)
j_update = jax.jit(jmixed.update, static_argnames=("eval_energy",))


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def random_ghf(seed=3, m=6, na=2, nb=2, nd=3, nw=4):
    """A random spin-mixing GHF expansion and block-diagonal walkers."""
    rng = np.random.default_rng(seed)
    ne = na + nb

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    return c(nd, 2 * m, ne), c(nd), c(nw, m, na), c(nw, m, nb)


def both_trials(psi, coeffs, inita, initb, etrial=0.0):
    jt = jghf.GHFTrial(psi=to_device(psi), coeffs=to_device(coeffs),
                       inita=to_device(inita), initb=to_device(initb),
                       etrial=etrial)
    tt = convert.ghf_trial(psi, coeffs, inita, initb, etrial=etrial,
                           device="cpu")
    return jt, tt


def hubbard_pair(nup=2, ndown=2, nx=3, ny=2):
    return (j_make_hubbard(nup=nup, ndown=ndown, U=4.0, nx=nx, ny=ny),
            make_hubbard(nup, ndown, U=4.0, nx=nx, ny=ny, **CPU))


def uhf_embedding_pair(jham, tham, ndets=2, seed=11):
    """The free-electron UHF pair embedded, plus perturbed copies: built
    by each package from the same arrays."""
    fe = ttrial.free_electron_trial(tham, **CPU)
    psia, psib = fe.psia.numpy(), fe.psib.numpy()
    m, na, nb = tham.nbasis, psia.shape[1], psib.shape[1]
    rng = np.random.default_rng(seed)
    psi = np.zeros((ndets, 2 * m, na + nb), dtype=complex)
    psi[0, :m, :na] = psia
    psi[0, m:, na:] = psib
    for d in range(1, ndets):
        psi[d] = psi[0] + 0.2 * (rng.standard_normal(psi[0].shape)
                                 + 1j * rng.standard_normal(psi[0].shape))
    coeffs = np.array([0.8, 0.2, 0.1, 0.05][:ndets], dtype=complex)
    jt = jghf.make_ghf_trial(jham, psi, coeffs, init=(psia, psib))
    tt = tghf.make_ghf_trial(tham, psi, coeffs, init=(psia, psib), **CPU)
    return jt, tt


# --------------------------------------------------------- construction ---

def test_constructors_match_jax(tmp_path):
    jham, tham = hubbard_pair()
    psi, coeffs, _, _ = random_ghf(m=6)
    for init in (None, (np.eye(6)[:, :2] + 0j, np.eye(6)[:, 2:4] + 0j)):
        jt = jghf.make_ghf_trial(jham, psi, coeffs, init=init)
        tt = tghf.make_ghf_trial(tham, psi, coeffs, init=init, **CPU)
        for k in ("psi", "coeffs", "inita", "initb"):
            close(getattr(tt, k).numpy(), getattr(jt, k))
        assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
        assert (tt.ndets, tt.nbasis, tt.nup, tt.ndown) == (3, 6, 2, 2)
    fe = ttrial.free_electron_trial(tham, **CPU)
    pa, pb = fe.psia.numpy(), fe.psib.numpy()
    jt = jghf.ghf_trial_from_uhf(jham, pa, pb)
    tt = tghf.ghf_trial_from_uhf(tham, pa, pb, **CPU)
    close(tt.psi.numpy(), jt.psi)
    assert tt.etrial == pytest.approx(fe.etrial, rel=1e-10)
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
    # The reference's ascii files: '(re,im)' a line, column-major blocks.
    orb, cf = tmp_path / "orbitals", tmp_path / "coeffs"
    orb.write_text("".join(f"({float(z.real)!r},{float(z.imag)!r})\n"
                           for d in range(3)
                           for z in psi[d].reshape(-1, order="F")))
    cf.write_text("".join(f"({float(z.real)!r}, {float(z.imag)!r})\n"
                          for z in coeffs))
    close(tghf.read_fortran_complex_numbers(str(cf)), coeffs, 0)
    jt = jghf.ghf_trial_from_files(jham, str(orb), str(cf), 2)
    tt = tghf.ghf_trial_from_files(tham, str(orb), str(cf), 2, **CPU)
    close(tt.psi.numpy(), psi[:2], 0)
    close(tt.psi.numpy(), jt.psi)
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)


def test_overlap_greens_and_energy_match_jax():
    jham, tham = hubbard_pair()
    psi, coeffs, phia, phib = random_ghf(seed=5, m=6, nd=3, nw=4)
    jt, tt = both_trials(psi, coeffs, phia[0], phib[0])
    jpa, jpb = jnp.asarray(phia), jnp.asarray(phib)
    close(tghf.ghf_overlap_matrices(tt, t(phia), t(phib)).numpy(),
          jghf.ghf_overlap_matrices(jt, jpa, jpb))
    close(tghf.ghf_log_overlap(tt, t(phia), t(phib)).numpy(),
          j_log_overlap(jt, jpa, jpb))
    gi, wts = tghf.ghf_greens_function(tt, t(phia), t(phib))
    jgi, jwts = j_greens(jt, jpa, jpb)
    close(gi.numpy(), jgi)
    close(wts.numpy(), jwts)
    got = tle.local_energy_hubbard_ghf(tham, gi, wts)
    for a, b in zip(got, j_energy(jham, jgi, jwts)):
        close(a.numpy(), b)
    # The host energy of one walker: JAX's and the batched one.
    host = tghf._ghf_energy_host(tham, psi, coeffs, phia[1], phib[1])
    assert host == pytest.approx(
        jghf._ghf_energy_host(jham, psi, coeffs, phia[1], phib[1]),
        rel=1e-10)
    assert host == pytest.approx(complex(got[0][1]), rel=1e-10)
    # The mixed estimator's step (the GHF energy), and its refusal of RDMs.
    js = j_init_walkers(jt, 4).replace(phia=jpa, phib=jpb)
    ts = init_walkers(tt, 4)
    close(ts.log_ovlp.numpy(), j_init_walkers(jt, 4).log_ovlp)
    ts.phia, ts.phib = t(phia), t(phib)
    close(tmixed.update(tham, tt, ts, True).numpy(),
          j_update(jham, jt, js, True))
    with pytest.raises(NotImplementedError, match="GHF"):
        tmixed.update(tham, tt, ts, True, calc_one_rdm=True)


# ---------------------------------------------------------- propagation ---

def hirsch_port(jprop):
    return convert.hirsch(
        np.asarray(jprop.BT2), np.asarray(jprop.auxf),
        np.asarray(jprop.aux_wfac), dt=jprop.dt, charge=jprop.charge,
        gamma=jprop.gamma, sweep_kernel="scan", device="cpu")


@pytest.mark.parametrize("charge", [False, True])
def test_kinetic_half_step_and_sweep_match_jax(charge):
    jham, tham = hubbard_pair()
    jt, tt = uhf_embedding_pair(jham, tham, ndets=3)
    jprop = j_make_hirsch(jham, jt, 0.05, charge_decomposition=charge)
    tprop = hirsch_port(jprop)
    assert jprop.sweep_kernel == "scan"
    assert make_hirsch(tham, tt, 0.05, charge_decomposition=charge,
                       **CPU).sweep_kernel == "scan"
    js = j_init_walkers(jt, 6, total_weight=6.0)
    ts = init_walkers(tt, 6, total_weight=6.0)
    js = jprop._kinetic_half_step_ghf(jt, js)
    ts = tprop._kinetic_half_step_ghf(tt, ts)
    for f in ("phia", "phib", "weight", "log_ovlp"):
        close(getattr(ts, f).numpy(), getattr(js, f))
    key = jax.random.key(2)
    rs = jax.random.uniform(key, (6, 6), dtype=jnp.float64)
    js, jfields = jprop._site_sweep_ghf(jt, js, key)
    ts, tfields = tprop._site_sweep_ghf(tt, ts, rs=t(rs))
    for f in ("phia", "phib", "weight", "log_ovlp"):
        close(getattr(ts, f).numpy(), getattr(js, f))
    assert np.array_equal(tfields.numpy(), np.asarray(jfields))
    # The maintained overlap is the from-scratch one.
    close(np.exp(ts.log_ovlp.numpy()
                 - tghf.ghf_log_overlap(tt, ts.phia, ts.phib).numpy()),
          1.0, 1e-9)


def jax_noise(block_key, nsteps, nw, m):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.uniform(kprop, (m, nw),
                                                dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


@pytest.mark.parametrize("charge", [False, True])
def test_ghf_blocks_match_jax(charge):
    jham, tham = hubbard_pair()
    jt, tt = uhf_embedding_pair(jham, tham, ndets=2)
    jprop = j_make_hirsch(jham, jt, 0.05, charge_decomposition=charge)
    tprop = hirsch_port(jprop)
    nw = 8
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    ts = init_walkers(tt, nw, total_weight=float(nw))
    opts = dict(nsteps=5, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(41 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(5 * block, jnp.int32), free_projection=False,
            **opts)
        ts, tacc, _, _ = tafqmc.run_block(
            tham, tt, tprop, ts, None, eshift, 5 * block,
            noise=jax_noise(key, 5, nw, tham.nbasis), **opts)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib", "log_ovlp"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


def test_one_determinant_embedding_equals_uhf_block():
    """The D = 1 GHF embedding of a UHF trial gives the UHF block's
    numbers (there through the sweep kernel's route, its plain version
    here) with the same uniforms."""
    tham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    uhf = ttrial.free_electron_trial(tham, **CPU)
    ghf_t = tghf.ghf_trial_from_uhf(tham, uhf.psia.numpy(),
                                    uhf.psib.numpy(), **CPU)
    rng = np.random.default_rng(4)
    noise = BlockNoise(t(rng.uniform(size=(5, 9, 8))),
                       t(rng.uniform(size=(5, 1))))
    opts = dict(nsteps=5, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=8.0, energy_eval_freq=1)
    out = {}
    for tag, trial in (("uhf", uhf), ("ghf", ghf_t)):
        prop = make_hirsch(tham, trial, 0.05, **CPU)
        assert prop.sweep_kernel == ("kernel" if tag == "uhf" else "scan")
        state = init_walkers(trial, 8, total_weight=8.0)
        state, acc, _, _ = tafqmc.run_block(tham, trial, prop, state, None,
                                            0.0, 0, noise=noise, **opts)
        out[tag] = (acc.numpy()[0], state.weight.numpy())
    close(out["ghf"][0], out["uhf"][0], 1e-9)
    close(out["ghf"][1], out["uhf"][1], 1e-9)


# ------------------------------------------------------------- driver ---

def test_afqmc_runs_ghf_and_refuses_what_jax_refuses():
    ham = make_hubbard(2, 2, U=4.0, nx=3, ny=2, **CPU)
    fe = ttrial.free_electron_trial(ham, **CPU)
    trial = tghf.ghf_trial_from_uhf(ham, fe.psia.numpy(), fe.psib.numpy(),
                                    **CPU)
    qmc = QMCOpts(nwalkers=6, dt=0.05, nsteps=4, nblocks=2, nstblz=2,
                  rng_seed=8)
    disc = {"hubbard_stratonovich": "discrete"}
    rows = AFQMC(ham, trial, qmc, propagator_options=disc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cpu").run()
    assert np.isfinite(rows).all()
    with pytest.raises(NotImplementedError, match="discrete"):
        AFQMC(ham, trial, qmc, device="cpu")
    for eopts in ({"back_propagation": {"tau_bp": 0.1}},
                  {"itcf": {"tau_max": 0.1}}):
        with pytest.raises(NotImplementedError, match="single-determinant"):
            AFQMC(ham, trial, qmc, propagator_options=disc,
                  estimator_options=eopts, device="cpu")
    with pytest.raises(NotImplementedError, match="GHF"):
        AFQMC(ham, trial, qmc, propagator_options=disc,
              estimator_options={"mixed": {"one_rdm": True}}, device="cpu")


def test_ghf_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import (make_hubbard,"
        " free_electron_trial, ghf_trial_from_uhf)\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "kw = dict(device='cpu', dtype='double')\n"
        "ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **kw)\n"
        "fe = free_electron_trial(ham, **kw)\n"
        "tr = ghf_trial_from_uhf(ham, fe.psia.numpy(), fe.psib.numpy(),"
        " **kw)\n"
        "AFQMC(ham, tr, QMCOpts(nwalkers=4, dt=0.05, nsteps=2, nblocks=1),"
        " propagator_options={'hubbard_stratonovich': 'discrete'},"
        " device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
