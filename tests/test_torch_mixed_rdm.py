"""Port parity: the mixed estimator's density matrices against JAX.

float64, the same inputs on both sides (JAX objects carried across with
pauxy_tpu_torch.utils.convert):
  * dms_size and the refusals JAX keeps (two_rdm off the UEG, free
    projection, a GHF trial);
  * mixed.update with one_rdm (Hubbard) and with the UEG's structure
    factor, by the FFT route (cube maps) and the dense route: 1e-10;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws
    injected, rtol 1e-8 / atol 1e-10 (real parts: the hybrid energy's
    imaginary part carries JAX's unwrapped CPU log-det branch): Hubbard
    continuous with one_rdm (the generic block, as in JAX), the UEG with
    one_rdm and two_rdm="structure_factor";
  * AFQMC(...).run() writes basic/one_rdm and basic/two_rdm as JAX's
    driver does, each block's traces are n per spin, E1B from the 1-RDM is
    the E1Body column and the S(k) potential energy the E2Body column
    (the limits of tests/test_mixed_rdm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import free_electron_trial as j_free_electron
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu.propagation.planewave import make_planewave as j_mpw
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import (free_electron_trial, ghf_trial_from_uhf,
                                    make_hubbard, make_ueg,
                                    rhf_identity_trial)
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
UEG_FIELDS = ("H1", "h1e_mod", "kpq_idx", "kpq_mask", "pmq_idx", "pmq_mask",
              "vqvec")
STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight", "phase", "eloc")

j_update = jax.jit(jmixed.update, static_argnames=(
    "eval_energy", "free_projection", "calc_one_rdm", "calc_two_rdm"))


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def hubbard_system():
    jham = j_make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    jt = j_free_electron(jham)
    tham = convert.hubbard(np.asarray(jham.T), jham.U, jham.symmetric,
                           nx=3, ny=3, nup=3, ndown=3, device="cpu")
    tt = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       device="cpu")
    return jham, jt, tham, tt


def ueg_system(maps=True):
    jham = j_make_ueg(nup=2, ndown=2, rs=1.0, ecut=1.0)
    jt = jtrial.rhf_identity_trial(jham)
    kw = {}
    if maps:
        kw = dict(gmap=np.asarray(jham.gmap), qmap=np.asarray(jham.qmap),
                  qmesh=jham.qmesh)
    tham = convert.ueg(*(np.asarray(getattr(jham, k)) for k in UEG_FIELDS),
                       basis=np.asarray(jham.basis),
                       qvecs=np.asarray(jham.qvecs), rs=jham.rs,
                       ecut=jham.ecut, vol=jham.vol, kfac=jham.kfac,
                       ecore=jham.ecore, nup=jham.nup, ndown=jham.ndown,
                       device="cpu", **kw)
    if not maps:
        jham = jham.replace(gmap=None, qmap=None, qmesh=None)
    tt = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       device="cpu")
    return jham, jt, tham, tt


def perturbed(jt, nw, seed):
    """JAX walkers near the trial with random weights, and the port's."""
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    rng = np.random.default_rng(seed)

    def noisy(x):
        x = np.asarray(x)
        return jnp.asarray(x + 0.1 * (rng.standard_normal(x.shape)
                                      + 1j * rng.standard_normal(x.shape)))

    js = js.replace(phia=noisy(js.phia), phib=noisy(js.phib),
                    weight=jnp.asarray(rng.uniform(0.3, 2.0, nw)))
    ts = convert.walker_state(**{f: np.asarray(getattr(js, f))
                                 for f in STATE_FIELDS}, device="cpu")
    return js, ts


# ------------------------------------------------------------- pieces ---

def test_dms_size_and_refusals_match_jax():
    jham, jt, tham, tt = hubbard_system()
    assert tmixed.dms_size(tham, True, None) == jmixed.dms_size(
        jham, True, None) == 2 * 81
    ujham, _, utham, _ = ueg_system()
    assert tmixed.dms_size(utham, True, "structure_factor") == \
        jmixed.dms_size(ujham, True, "structure_factor")
    for bad in ("full", "structure_factor"):
        with pytest.raises(NotImplementedError, match="structure_factor"):
            tmixed.dms_size(tham, False, bad)
        with pytest.raises(NotImplementedError, match="structure_factor"):
            jmixed.dms_size(jham, False, bad)
    ts = init_walkers(tt, 3)
    with pytest.raises(NotImplementedError, match="FP"):
        tmixed.update(tham, tt, ts, True, free_projection=True,
                      calc_one_rdm=True)
    gt = ghf_trial_from_uhf(tham, tt.psia.numpy(), tt.psib.numpy(), **CPU)
    with pytest.raises(NotImplementedError, match="GHF"):
        tmixed.update(tham, gt, init_walkers(gt, 3), True,
                      calc_one_rdm=True)
    # Without energy the tail is zero.
    acc = tmixed.update(tham, tt, ts, False, calc_one_rdm=True)
    assert acc.shape == (tmixed.NACC + 162,) and not acc[8:].any()


def test_one_rdm_update_matches_jax():
    jham, jt, tham, tt = hubbard_system()
    js, ts = perturbed(jt, 5, 1)
    close(tmixed.update(tham, tt, ts, True, calc_one_rdm=True).numpy(),
          j_update(jham, jt, js, True, calc_one_rdm=True))


@pytest.mark.parametrize("maps", [True, False])
def test_structure_factor_update_matches_jax(maps):
    jham, jt, tham, tt = ueg_system(maps)
    js, ts = perturbed(jt, 4, 2)
    got = tmixed.update(tham, tt, ts, True, calc_one_rdm=True,
                        calc_two_rdm="structure_factor")
    want = j_update(jham, jt, js, True, calc_one_rdm=True,
                    calc_two_rdm="structure_factor")
    close(got.numpy(), want)


# ------------------------------------------------ blocks against JAX ---

def jax_noise(block_key, nsteps, nw, nf):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nf),
                                               dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


def two_blocks(jham, jt, jprop, tham, tt, tprop, nw, **dms):
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    ts = init_walkers(tt, nw, total_weight=float(nw))
    opts = dict(nsteps=5, nstblz=5, npop_control=1, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(41 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(5 * block, jnp.int32), free_projection=False,
            **dms, **opts)
        ts, tacc, _, _ = tafqmc.run_block(
            tham, tt, tprop, ts, None, eshift, 5 * block,
            noise=jax_noise(key, 5, nw, jham.nfields), **dms, **opts)
        assert tacc.shape[-1] == tmixed.NACC + tmixed.dms_size(tham, **dms)
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


def test_hubbard_one_rdm_blocks_match_jax():
    jham, jt, tham, tt = hubbard_system()
    jinner = j_mhc(jham, jt, 0.05)
    tinner = convert.hubbard_continuous(
        np.asarray(jinner.BH1), np.asarray(jinner.mf_shift), dt=0.05,
        U=4.0, charge=True, device="cpu")
    two_blocks(jham, jt, JContinuous(inner=jinner, dt=0.05), tham, tt,
               Continuous(inner=tinner, dt=0.05), 8, calc_one_rdm=True,
               calc_two_rdm=None)


def test_ueg_structure_factor_blocks_match_jax():
    jham, jt, tham, tt = ueg_system()
    jinner = j_mpw(jham, jt, 0.01, taylor_impl="xla")
    tinner = convert.planewave(np.asarray(jinner.BH1), ham=tham, dt=0.01,
                               device="cpu")
    two_blocks(jham, jt, JContinuous(inner=jinner, dt=0.01), tham, tt,
               Continuous(inner=tinner, dt=0.01), 6, calc_one_rdm=True,
               calc_two_rdm="structure_factor")


# ------------------------------------------------------------- driver ---

def test_afqmc_one_rdm_hubbard(tmp_path):
    import h5py

    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    trial = free_electron_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=20, dt=0.05, nsteps=5, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "rdm.h5")
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1,
                                            "one_rdm": True}},
               filename=fn, device="cpu")
    assert not af.use_fast_block
    rows = af.run()
    with h5py.File(fn, "r") as f:
        keys = sorted(f["basic/one_rdm"])
        rdms = np.stack([f["basic/one_rdm"][k][()] for k in keys])
        assert sorted(f["basic/energies"]) == keys
    assert rdms.shape == (4, 2, 9, 9)
    tmat = ham.T.numpy()
    for b in range(4):
        g = rdms[b]
        assert np.trace(g[0]).real == pytest.approx(3.0, abs=1e-4)
        assert np.trace(g[1]).real == pytest.approx(3.0, abs=1e-4)
        e1b = np.sum(tmat[0] * g[0] + tmat[1] * g[1]).real
        assert e1b == pytest.approx(rows[b, 6].real, abs=1e-3)


def test_afqmc_structure_factor_ueg(tmp_path):
    import h5py

    ham = make_ueg(2, 2, rs=1.0, ecut=0.5, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "sk.h5")
    rows = AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {
                     "energy_eval_freq": 1, "one_rdm": True,
                     "two_rdm": "structure_factor"}},
                 filename=fn, device="cpu").run()
    with h5py.File(fn, "r") as f:
        grp = f["basic/two_rdm"]
        sk = np.stack([grp[k][()] for k in sorted(grp)])
    assert sk.shape == (3, 2, 2, ham.nq)
    vq = ham.vqvec.numpy()
    for b in range(3):
        pe = np.sum(vq * sk[b].sum(axis=(0, 1))).real / (2.0 * ham.vol)
        assert pe == pytest.approx(rows[b, 7].real, abs=1e-4)
    with pytest.raises(NotImplementedError, match="structure_factor"):
        hub = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
        AFQMC(hub, free_electron_trial(hub, **CPU), qmc,
              estimator_options={"mixed": {"two_rdm": "structure_factor"}},
              device="cpu")
