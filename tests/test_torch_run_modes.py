"""Port parity: the zero-temperature run modes against JAX.

float64, the same inputs on both sides (JAX objects carried across with
pauxy_tpu_torch.utils.convert):
  * the free-projection mixed accumulator (Hubbard and Generic), one free
    projection step (continuous, discrete), one local-energy
    (``hybrid=False``) step, the whole-lattice direct update and the
    momentum-space kinetic half step, each with JAX's draws: 1e-10;
  * pinned_kinetic and make_hubbard(pinning_fields=True), and
    spin_project_init (natural orbitals and free electron): 1e-10;
  * two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
    with JAX's draws injected in JAX's order (keys = split(block_key,
    nsteps); kprop, kpop, kest = split(key, 3); continuous fields
    normal(kprop, (w, X)), free-projection bits bernoulli(kprop, 0.5,
    (w, M)), direct-update uniforms uniform(kprop, (w, M)), sweep uniforms
    uniform(kprop, (M, w))), rtol 1e-8 / atol 1e-10, for continuous free
    projection, discrete free projection, the direct update,
    ``kinetic_kspace`` and ``hybrid=False`` (Hubbard and Generic). The
    continuous blocks hold JAX's log-determinants to the phase branch of
    its TPU kernel and the port's kernel B (arg det in (-pi, pi]);
  * AFQMC(...) runs every one of these modes through its options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.models import hubbard as jhubbard
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.ops import clinalg as jclinalg
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.propagation.hirsch import make_hirsch as j_make_hirsch
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import hubbard as thubbard
from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.models import free_electron_trial as t_free_electron
from pauxy_tpu_torch.models import make_hubbard as t_make_hubbard
from pauxy_tpu_torch.propagation import hirsch as thirsch
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight", "phase", "eloc")
TRIAL_TENSORS = ("rchola", "rcholb", "rh1a", "rh1b", "exx_supera",
                 "exx_superb")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def port_state(js):
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu")


def hubbard_system(ktwist=None, nx=3, ny=3, nup=4, ndown=3):
    jham = make_hubbard(nup=nup, ndown=ndown, U=4.0, nx=nx, ny=ny,
                        ktwist=ktwist)
    jtr = free_electron_trial(jham)
    tham = convert.hubbard(np.asarray(jham.T), jham.U, jham.symmetric,
                           nx=nx, ny=ny, nup=nup, ndown=ndown, device="cpu")
    ttr = convert.trial(np.asarray(jtr.psia), np.asarray(jtr.psib),
                        jtr.etrial, device="cpu")
    return jham, jtr, tham, ttr


def generic_system(nmo=6, nelec=(2, 2), seed=3):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    jham = j_make_generic(nelec, h1e, chol, enuc)
    jtr = jtrial.rhf_identity_trial(jham)
    tham = convert.generic(np.asarray(jham.H1), np.asarray(jham.h1e_mod),
                           np.asarray(jham.chol), ecore=jham.ecore,
                           nup=jham.nup, ndown=jham.ndown, device="cpu")
    ttr = convert.trial(np.asarray(jtr.psia), np.asarray(jtr.psib),
                        jtr.etrial, device="cpu",
                        **{k: getattr(jtr, k) for k in TRIAL_TENSORS})
    return jham, jtr, tham, ttr


def hirsch_port(jprop):
    return convert.hirsch(
        np.asarray(jprop.BT2), np.asarray(jprop.auxf),
        np.asarray(jprop.aux_wfac), dt=jprop.dt, charge=jprop.charge,
        gamma=jprop.gamma, sweep_kernel="scan",
        free_projection=jprop.free_projection,
        two_body_mode=jprop.two_body_mode,
        btk=None if jprop.btk is None else np.asarray(jprop.btk),
        nx=jprop.nx, ny=jprop.ny, device="cpu")


def continuous_port(jprop):
    inner = jprop.inner
    if hasattr(inner, "U"):
        tin = convert.hubbard_continuous(
            np.asarray(inner.BH1), np.asarray(inner.mf_shift), dt=inner.dt,
            U=inner.U, charge=inner.charge, device="cpu")
    else:
        tin = convert.generic_continuous(
            np.asarray(inner.BH1), np.asarray(inner.mf_shift),
            np.asarray(inner.chol), dt=inner.dt, device="cpu")
    return Continuous(inner=tin, dt=jprop.dt,
                      free_projection=jprop.free_projection,
                      hybrid=jprop.hybrid, force_bias=jprop.force_bias)


def perturbed(jtr, nw, seed):
    js = j_init_walkers(jtr, nw, total_weight=float(nw))
    rng = np.random.default_rng(seed)

    def noisy(x):
        x = np.asarray(x)
        return jnp.asarray(x + 0.1 * (rng.standard_normal(x.shape)
                                      + 1j * rng.standard_normal(x.shape)))

    js = js.replace(phia=noisy(js.phia), phib=noisy(js.phib),
                    weight=jnp.asarray(rng.uniform(0.3, 2.0, nw)),
                    phase=jnp.asarray(np.exp(1j * rng.uniform(-2, 2, nw))),
                    eloc=jnp.asarray(rng.normal(size=nw) - 8.0 + 0j),
                    hybrid_energy=jnp.asarray(rng.normal(size=nw) + 0j))
    return js.replace(log_ovlp=jgreens.log_overlap(js.phia, jtr.psia)
                      + jgreens.log_overlap(js.phib, jtr.psib))


@pytest.fixture
def tpu_branch(monkeypatch):
    """JAX's log-determinant with arg det in (-pi, pi], its TPU kernel's
    branch (and the port's kernel B's); jit caches cleared around it."""
    slogdet = jclinalg.slogdet

    def wrapped(s):
        ld = slogdet(s)
        return (ld.real + 1j * jnp.angle(jnp.exp(1j * ld.imag))).astype(
            ld.dtype)

    jax.clear_caches()
    monkeypatch.setattr(jclinalg, "slogdet", wrapped)
    yield
    jax.clear_caches()


# ---- pieces ---------------------------------------------------------------

@pytest.mark.parametrize("model", ["hubbard", "generic"])
@pytest.mark.parametrize("eval_energy", [True, False])
def test_free_projection_mixed_update_matches_jax(model, eval_energy):
    jham, jtr, tham, ttr = (hubbard_system() if model == "hubbard"
                            else generic_system())
    js = perturbed(jtr, 6, seed=1)
    aj = jmixed.update(jham, jtr, js, eval_energy, free_projection=True)
    at = tmixed.update(tham, ttr, port_state(js), eval_energy,
                       free_projection=True)
    close(at.numpy(), aj)


def test_pinned_hubbard_matches_jax():
    close(thubbard.pinned_kinetic(1.0, 4, 3),
          jhubbard.pinned_kinetic(1.0, 4, 3))
    jham = make_hubbard(nup=6, ndown=6, U=4.0, nx=4, ny=3,
                        pinning_fields=True)
    tham = t_make_hubbard(6, 6, U=4.0, nx=4, ny=3, pinning_fields=True,
                          **CPU)
    close(tham.T.numpy(), jham.T)
    close(tham.h1e_mod.numpy(), jham.h1e_mod)
    assert not tham.T.is_complex()
    # Spin-dependent fields: the two hopping matrices differ.
    assert np.abs(tham.T[0].numpy() - tham.T[1].numpy()).max() == 0.2
    conv = convert.hubbard(np.asarray(jham.T), 4.0, False, nx=4, ny=3,
                           nup=6, ndown=6, device="cpu")
    close(conv.h1e_mod.numpy(), jham.h1e_mod)
    jt, tt = free_electron_trial(jham), t_free_electron(tham, **CPU)
    assert tt.etrial == pytest.approx(float(jt.etrial), abs=1e-10)


@pytest.mark.parametrize("init_walker", [None, "free_electron"])
def test_spin_project_init_matches_jax(init_walker):
    jham, jtr, tham, _ = hubbard_system(nup=4, ndown=3)
    tt = ttrial.uhf_trial(tham, seed=7, **CPU)
    jt = jtrial.uhf_trial(jham, seed=7)
    close(tt.psia.numpy(), jt.psia)
    jnew, jnoons = jtrial.spin_project_init(jham, jt, init_walker)
    tnew, tnoons = ttrial.spin_project_init(tham, tt, init_walker)
    close(tnew.inita.numpy(), jnew.inita)
    close(tnew.initb.numpy(), jnew.initb)
    if init_walker is None:
        close(tnoons, jnoons)
    else:
        assert tnoons is None and jnoons is None
    # Only the initial determinant moves.
    close(tnew.psia.numpy(), tt.psia.numpy())
    assert tnew.etrial == tt.etrial
    assert not np.allclose(tnew.inita.numpy(), tt.inita.numpy())


def test_kinetic_kspace_half_step_matches_jax():
    jham, jtr, tham, ttr = hubbard_system(nx=4, ny=3, nup=5, ndown=4)
    jprop = j_make_hirsch(jham, jtr, 0.05, kinetic_kspace=True)
    tprop = thirsch.make_hirsch(tham, ttr, 0.05, kinetic_kspace=True, **CPU)
    close(tprop.btk.numpy(), jprop.btk)
    assert (tprop.nx, tprop.ny) == (4, 3)
    dense = thirsch.make_hirsch(tham, ttr, 0.05, **CPU)
    js = perturbed(jtr, 5, seed=2)
    ts = port_state(js)
    jnew = jprop._kinetic_half_step(jtr, js)
    tnew = tprop._kinetic_half_step(ttr, ts)
    for f in ("phia", "phib", "weight"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))
    # The same half step as the dense B_{T/2}.
    dnew = dense._kinetic_half_step(ttr, ts)
    close(tnew.phia.numpy(), dnew.phia.numpy())
    with pytest.raises(ValueError, match="circulant"):
        _, _, th2, tt2 = hubbard_system(ktwist=[0.01, -0.02])
        thirsch.make_hirsch(th2, tt2, 0.05, kinetic_kspace=True, **CPU)


@pytest.mark.parametrize("charge", [False, True])
def test_direct_update_matches_jax(charge):
    jham, jtr, tham, ttr = hubbard_system(ktwist=[0.01, -0.02])
    jprop = j_make_hirsch(jham, jtr, 0.05, charge_decomposition=charge,
                          two_body_mode="direct")
    tprop = hirsch_port(jprop)
    js = perturbed(jtr, 6, seed=3)
    key = jax.random.key(4)
    jnew, jfields = jprop._two_body_direct(jtr, js, key)
    rs = t(jax.random.uniform(key, (6, 9), dtype=jnp.float64))
    tnew, tfields = tprop._two_body_direct(ttr, port_state(js), rs=rs)
    np.testing.assert_array_equal(tfields.numpy(), np.asarray(jfields))
    for f in ("phia", "phib", "weight", "log_ovlp"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))


def test_discrete_free_projection_step_matches_jax():
    jham, jtr, tham, ttr = hubbard_system(ktwist=[0.01, -0.02])
    jprop = j_make_hirsch(jham, jtr, 0.05, charge_decomposition=True,
                          free_projection=True)
    tprop = hirsch_port(jprop)
    js = perturbed(jtr, 6, seed=5)
    key = jax.random.key(6)
    jnew = jprop.propagate(jtr, js, key, jnp.asarray(-3.0 + 0j))
    bits = t(jax.random.bernoulli(key, 0.5, (6, 9)))
    tnew = tprop.propagate(ttr, port_state(js), None, -3.0, bits)
    for f in ("phia", "phib", "weight", "phase", "log_ovlp"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))


@pytest.mark.parametrize("model", ["hubbard", "generic"])
def test_continuous_free_projection_step_matches_jax(model):
    jham, jtr, tham, ttr = (hubbard_system() if model == "hubbard"
                            else generic_system())
    inner = (j_mhc(jham, jtr, 0.05) if model == "hubbard"
             else j_mgc(jham, jtr, 0.05))
    jprop = JContinuous(inner=inner, dt=0.05, free_projection=True,
                        force_bias=False)
    tprop = continuous_port(jprop)
    js = perturbed(jtr, 6, seed=7)
    key = jax.random.key(8)
    jnew = jprop.propagate(jtr, js, key, jnp.asarray(-2.0 + 0j))
    xi = t(jax.random.normal(key, (6, jham.nfields), dtype=jnp.float64))
    tnew = tprop.propagate(ttr, port_state(js), None, -2.0, xi)
    for f in ("phia", "phib", "weight", "phase", "log_ovlp"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))


@pytest.mark.parametrize("model", ["hubbard", "generic"])
def test_local_energy_step_matches_jax(model, tpu_branch):
    jham, jtr, tham, ttr = (hubbard_system() if model == "hubbard"
                            else generic_system())
    inner = (j_mhc(jham, jtr, 0.05) if model == "hubbard"
             else j_mgc(jham, jtr, 0.05))
    jprop = JContinuous(inner=inner, dt=0.05, hybrid=False)
    tprop = continuous_port(jprop)
    js = perturbed(jtr, 6, seed=9)
    key = jax.random.key(10)
    eshift = float(jtr.etrial) + 0.3
    jnew = jprop.propagate(jtr, js, key, jnp.asarray(eshift + 0j), ham=jham)
    xi = t(jax.random.normal(key, (6, jham.nfields), dtype=jnp.float64))
    tnew = tprop.propagate(ttr, port_state(js), None, eshift, xi, ham=tham)
    for f in ("phia", "phib", "weight", "eloc", "hybrid_energy",
              "log_ovlp"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))
    with pytest.raises(ValueError, match="needs ham"):
        tprop.propagate(ttr, port_state(js), None, eshift, xi)


# ---- two blocks against JAX's run_block -----------------------------------

def jax_noise(block_key, nsteps, draw):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(draw(kprop)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


def two_blocks(jham, jtr, jprop, tham, ttr, tprop, nw, draw, eshifts,
               free_projection=False):
    js = j_init_walkers(jtr, nw, total_weight=float(nw))
    ts = port_state(js)
    opts = dict(nsteps=10, nstblz=5, npop_control=2, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=2)
    for block, eshift in enumerate(eshifts):
        key = jax.random.key(41 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jtr, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(10 * block, jnp.int32),
            free_projection=free_projection, **opts)
        ts, tacc, tbp, titcf = tafqmc.run_block(
            tham, ttr, tprop, ts, None, eshift, 10 * block,
            free_projection=free_projection, noise=jax_noise(key, 10, draw),
            **opts)
        assert tbp.shape == (2, 0) == titcf.shape
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("phia", "phib", "weight", "unscaled_weight", "phase",
                  "eloc", "log_detr"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)
    return ts


@pytest.mark.parametrize("model", ["hubbard", "generic"])
def test_continuous_free_projection_blocks_match_jax(model):
    jham, jtr, tham, ttr = (hubbard_system() if model == "hubbard"
                            else generic_system())
    inner = (j_mhc(jham, jtr, 0.02) if model == "hubbard"
             else j_mgc(jham, jtr, 0.02))
    jprop = JContinuous(inner=inner, dt=0.02, free_projection=True,
                        force_bias=False)
    nf = jham.nfields
    ts = two_blocks(jham, jtr, jprop, tham, ttr, continuous_port(jprop), 8,
                    lambda k: jax.random.normal(k, (8, nf), jnp.float64),
                    (0.0, float(jtr.etrial)), free_projection=True)
    assert np.abs(np.abs(ts.phase.numpy()) - 1).max() < 1e-12


def test_discrete_free_projection_blocks_match_jax():
    jham, jtr, tham, ttr = hubbard_system(ktwist=[0.01, -0.02])
    jprop = j_make_hirsch(jham, jtr, 0.02, charge_decomposition=True,
                          free_projection=True)
    two_blocks(jham, jtr, jprop, tham, ttr, hirsch_port(jprop), 8,
               lambda k: jax.random.bernoulli(k, 0.5, (8, 9)),
               (0.0, -7.0), free_projection=True)


def test_direct_update_blocks_match_jax():
    jham, jtr, tham, ttr = hubbard_system(ktwist=[0.01, -0.02])
    jprop = j_make_hirsch(jham, jtr, 0.02, two_body_mode="direct")
    two_blocks(jham, jtr, jprop, tham, ttr, hirsch_port(jprop), 8,
               lambda k: jax.random.uniform(k, (8, 9), jnp.float64),
               (0.0, -7.0))


def test_kinetic_kspace_blocks_match_jax():
    jham, jtr, tham, ttr = hubbard_system(nx=4, ny=3, nup=5, ndown=4)
    jprop = j_make_hirsch(jham, jtr, 0.02, kinetic_kspace=True,
                          sweep_kernel="scan")
    two_blocks(jham, jtr, jprop, tham, ttr, hirsch_port(jprop), 8,
               lambda k: jax.random.uniform(k, (12, 8), jnp.float64),
               (0.0, -9.0))


@pytest.mark.parametrize("model", ["hubbard", "generic"])
def test_local_energy_blocks_match_jax(model, tpu_branch):
    jham, jtr, tham, ttr = (hubbard_system() if model == "hubbard"
                            else generic_system())
    inner = (j_mhc(jham, jtr, 0.02) if model == "hubbard"
             else j_mgc(jham, jtr, 0.02))
    jprop = JContinuous(inner=inner, dt=0.02, hybrid=False)
    nf = jham.nfields
    two_blocks(jham, jtr, jprop, tham, ttr, continuous_port(jprop), 8,
               lambda k: jax.random.normal(k, (8, nf), jnp.float64),
               (0.0, float(jtr.etrial)))


# ---- the driver -----------------------------------------------------------

DRIVER_CASES = {
    "continuous_free_projection": ({"free_projection": True}, "Hubbard"),
    "discrete_free_projection": ({"hubbard_stratonovich": "discrete",
                                  "free_projection": True}, "Hubbard"),
    "direct_update": ({"hubbard_stratonovich": "discrete",
                       "single_site_update": False}, "Hubbard"),
    "kinetic_kspace": ({"hubbard_stratonovich": "discrete",
                        "kinetic_kspace": True}, "Hubbard"),
    "local_energy": ({"hybrid": False}, "Hubbard"),
    "generic_local_energy": ({"hybrid": False}, "Generic"),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_afqmc_runs_the_mode(case):
    popts, model = DRIVER_CASES[case]
    if model == "Hubbard":
        ham = t_make_hubbard(5, 4, U=4.0, nx=4, ny=3, **CPU)
        trial = t_free_electron(ham, **CPU)
    else:
        h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=2)
        ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
        trial = rhf_identity_trial(ham, **CPU)
    af = AFQMC(ham, trial, QMCOpts(nwalkers=6, dt=0.02, nsteps=4, nblocks=3,
                                   nstblz=2, rng_seed=3),
               propagator_options=popts,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    assert not af.use_fast_block
    rows = af.run()
    assert rows.shape == (3, 11) and np.isfinite(rows).all()
    if popts.get("free_projection"):
        phase = af.state.phase.numpy()
        assert np.abs(np.abs(phase) - 1).max() < 1e-12
