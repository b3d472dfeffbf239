"""Port parity: back propagation and its walker buffers against JAX.

float64 throughout, the same inputs on both sides (the JAX objects carried
across with pauxy_tpu_torch.utils.convert):
  * init_walkers with the BP/ITCF buffers, the free-projection
    orthogonalise, greens.gab, HubbardContinuous's force_bias / apply_vhs /
    bp_dagger_fields / mf_core, local_energy_generic_cholesky_G (also in
    small chunks), back_propagate_continuous / _hirsch, bp_weights (None,
    'partial', 'full'), back_prop.update (nbp_len, two_rdm='full', EKT):
    1e-10;
  * bp_weights' guard |cos| > 1e-300 reads |cos| > 0 in float32, as JAX's;
  * population control moves the buffers with their parents;
  * two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
    with JAX's draws injected in JAX's order (keys = split(block_key,
    nsteps); kprop, kpop, kest = split(key, 3)), rtol 1e-8 / atol 1e-10 on
    the mixed, BP and ITCF accumulators and the walkers: discrete + BP +
    ITCF on the sweep kernel's route and on the scan route, continuous
    Hubbard + BP with restore_weights 'partial' and two splits, Generic +
    BP + EKT + the full 2-RDM;
    The continuous blocks hold JAX's log-determinants to the phase branch
    its TPU kernel and the port's kernel B give, arg det in (-pi, pi]
    (``arctan2``, ``pauxy_tpu/ops/batchla_pallas.py:203``): JAX's CPU
    fallback sums the pivots' logs unwrapped, and the hybrid energy's
    imaginary part, with the BP phase factor exp(i Im log_imp), depends
    on that branch;
  * the HDF5 groups and dataset names of a BP + ITCF run equal JAX's;
  * a BP + ITCF run of the port pulls in no jax.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import back_prop as jbp
from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.ops import clinalg as jclinalg
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.propagation.hirsch import make_hirsch as j_make_hirsch
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu.qmc import AFQMC as JAFQMC
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu.walkers import pop_control as jpc
from pauxy_tpu.walkers import state as jstate
from pauxy_tpu_torch.estimators import back_prop as tbp
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import free_electron_trial as t_free_electron
from pauxy_tpu_torch.models import make_hubbard as t_make_hubbard
from pauxy_tpu_torch.ops import greens as tgreens
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import pop_control as tpc
from pauxy_tpu_torch.walkers import state as tstate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    hist = {f: np.asarray(getattr(js, f)) for f in convert.HISTORY_FIELDS
            if getattr(js, f) is not None}
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu",
                                **hist)


def hubbard_objects(jham, jtr):
    tham = convert.hubbard(np.asarray(jham.T), jham.U, jham.symmetric,
                           nx=jham.nx, ny=jham.ny, nup=jham.nup,
                           ndown=jham.ndown, device="cpu")
    ttr = convert.trial(np.asarray(jtr.psia), np.asarray(jtr.psib),
                        jtr.etrial, device="cpu")
    return tham, ttr


def generic_objects(jham, jtr):
    tham = convert.generic(np.asarray(jham.H1), np.asarray(jham.h1e_mod),
                           np.asarray(jham.chol), ecore=jham.ecore,
                           nup=jham.nup, ndown=jham.ndown, device="cpu")
    ttr = convert.trial(np.asarray(jtr.psia), np.asarray(jtr.psib),
                        jtr.etrial, device="cpu",
                        **{k: getattr(jtr, k) for k in TRIAL_TENSORS})
    return tham, ttr


def hirsch_port(jprop, route="scan"):
    return convert.hirsch(
        np.asarray(jprop.BT2), np.asarray(jprop.auxf),
        np.asarray(jprop.aux_wfac), dt=jprop.dt, charge=jprop.charge,
        gamma=jprop.gamma, sweep_kernel=route,
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
            np.asarray(inner.chol), dt=inner.dt,
            taylor_impl=inner.taylor_impl, device="cpu")
    return Continuous(inner=tin, dt=jprop.dt,
                      free_projection=jprop.free_projection,
                      hybrid=jprop.hybrid, force_bias=jprop.force_bias)


def history_state(jtr, nw, nprop, nfields, seed, itcf=True, discrete=False):
    """A JAX walker state with filled buffers: perturbed walkers and
    historic wavefunctions, random fields (integers for the discrete
    propagator) and factors."""
    js = j_init_walkers(jtr, nw, total_weight=float(nw), nprop_tot=nprop,
                        nfields=nfields, itcf=itcf)
    rng = np.random.default_rng(seed)

    def noisy(x, s=0.1):
        x = np.asarray(x)
        return x + s * (rng.standard_normal(x.shape)
                        + 1j * rng.standard_normal(x.shape))

    if discrete:
        configs = rng.integers(0, 2, size=(nw, nprop, nfields)) + 0j
    else:
        configs = 0.7 * (rng.standard_normal((nw, nprop, nfields))
                         + 0.2j * rng.standard_normal((nw, nprop, nfields)))
    cos = rng.uniform(0.5, 1.0, (nw, nprop))
    cos[0, 1] = 0.0                                      # restored to 0
    extra = {}
    if itcf:
        extra = dict(phia_right=jnp.asarray(noisy(js.phia)),
                     phib_right=jnp.asarray(noisy(js.phib)))
    js = js.replace(
        phia=jnp.asarray(noisy(js.phia)), phib=jnp.asarray(noisy(js.phib)),
        weight=jnp.asarray(rng.uniform(0.3, 2.0, nw)),
        configs=jnp.asarray(configs), cos_fac=jnp.asarray(cos),
        weight_fac=jnp.asarray(np.exp(1j * rng.uniform(-0.3, 0.3,
                                                       (nw, nprop)))),
        phia_old=jnp.asarray(noisy(js.phia_old)),
        phib_old=jnp.asarray(noisy(js.phib_old)), **extra)
    return js.replace(log_ovlp=jgreens.log_overlap(js.phia, jtr.psia)
                      + jgreens.log_overlap(js.phib, jtr.psib))


def hubbard4(**kw):
    jham = make_hubbard(nup=kw.get("nup", 5), ndown=kw.get("ndown", 4),
                        U=4.0, nx=kw.get("nx", 3), ny=kw.get("ny", 3),
                        ktwist=kw.get("ktwist"))
    jtr = free_electron_trial(jham)
    return jham, jtr


def generic_system(nmo=6, nelec=(2, 2), seed=3):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    jham = j_make_generic(nelec, h1e, chol, enuc)
    jtr = jtrial.rhf_identity_trial(jham)
    return jham, jtr


# ---- walker state ---------------------------------------------------------

@pytest.mark.parametrize("itcf", [False, True])
def test_init_walkers_with_buffers_matches_jax(itcf):
    jham, jtr = hubbard4()
    js = j_init_walkers(jtr, 6, total_weight=6.0, nprop_tot=4, nfields=9,
                        itcf=itcf)
    _, ttr = hubbard_objects(jham, jtr)
    ts = tstate.init_walkers(ttr, 6, total_weight=6.0, nprop_tot=4,
                             nfields=9, itcf=itcf)
    for f in STATE_FIELDS + convert.HISTORY_FIELDS:
        jv = getattr(js, f)
        if jv is None:
            assert getattr(ts, f) is None, f
            continue
        assert getattr(ts, f).dtype == t(jv).dtype, f
        close(getattr(ts, f).numpy(), jv)
    plain = tstate.init_walkers(ttr, 6)
    assert plain.configs is None and plain.phia_right is None
    close(plain.phase.numpy(), np.ones(6))


def test_free_projection_orthogonalise_matches_jax():
    jham, jtr = hubbard4()
    js = history_state(jtr, 6, 4, 9, seed=1)
    ts = port_state(js)
    jnew = jstate.orthogonalise(js, free_projection=True)
    tnew = tstate.orthogonalise(ts, free_projection=True)
    for f in ("phia", "phib", "weight", "log_detr", "log_ovlp", "phase"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))
    # The overlap stays, |det R| moves into the weight.
    close(tnew.log_ovlp.numpy(), ts.log_ovlp.numpy())


@pytest.mark.parametrize("method", ["comb", "pair_branch"])
def test_pop_control_moves_buffers_with_their_parents(method):
    jham, jtr = hubbard4()
    js = history_state(jtr, 8, 4, 9, seed=2)
    js = js.replace(weight=jnp.asarray([0.05, 3.0, 0.5, 1.0, 1.0, 1.0, 0.02,
                                        4.0]))
    ts = port_state(js)
    key = jax.random.key(5)
    shape = () if method == "comb" else (4,)
    u = t(jax.random.uniform(key, shape, dtype=jnp.float64)).reshape(-1)
    jnew = jpc.pop_control(js, key, 8.0, method)
    tnew = tpc.pop_control(ts, 8.0, method, uniforms=u)
    parents, _ = (tpc.comb_parents(ts.weight, 8.0, u.reshape(()))
                  if method == "comb"
                  else tpc.pair_branch_parents(ts.weight, 8.0, u)[::2])
    assert len(set(parents.tolist())) < 8            # someone was cloned
    for f in convert.HISTORY_FIELDS + ("phase", "eloc"):
        close(getattr(tnew, f).numpy(), getattr(jnew, f))
        close(getattr(tnew, f).numpy(), getattr(ts, f)[parents].numpy())


# ---- pieces ---------------------------------------------------------------

def test_gab_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 9, 4)) + 1j * rng.standard_normal((5, 9, 4))
    b = rng.standard_normal((5, 9, 4)) + 1j * rng.standard_normal((5, 9, 4))
    close(tgreens.gab(t(a), t(b)).numpy(),
          jgreens.gab(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("charge", [True, False])
def test_hubbard_continuous_pieces_match_jax(charge):
    jham, jtr = hubbard4(ktwist=[0.01, -0.02])
    jin = j_mhc(jham, jtr, 0.05, charge_decomposition=charge)
    tin = continuous_port(JContinuous(inner=jin, dt=0.05)).inner
    js = history_state(jtr, 5, 2, 9, seed=4, itcf=False)
    ga = jgreens.greens_function(js.phia, jtr.psia)
    gb = jgreens.greens_function(js.phib, jtr.psib)
    _, ttr = hubbard_objects(jham, jtr)
    ts = port_state(js)
    tga = tgreens.greens_function(ts.phia, ttr.psia)
    tgb = tgreens.greens_function(ts.phib, ttr.psib)
    close(tin.force_bias(ttr, tga, tgb).numpy(),
          jin.force_bias(jtr, ga, gb))
    x = np.asarray(js.configs[:, 0])
    for tout, jout in zip(tin.apply_vhs(ts.phia, ts.phib, t(x)),
                          jin.apply_vhs(js.phia, js.phib, jnp.asarray(x))):
        close(tout.numpy(), jout)
    close(tin.bp_dagger_fields(t(x)).numpy(),
          jin.bp_dagger_fields(jnp.asarray(x)))
    close(tin.mf_core.numpy(), jin.mf_core)
    # exp(VHS(y)) is the adjoint of exp(VHS(x)).
    eye = torch.eye(9, dtype=torch.complex128).expand(5, 9, 9)
    ea, _ = tin.apply_vhs(eye, eye, t(x))
    eda, _ = tin.apply_vhs(eye, eye, tin.bp_dagger_fields(t(x)))
    close(eda.numpy(), ea.conj().transpose(-1, -2).resolve_conj().numpy())


@pytest.mark.parametrize("max_elems", [None, 40])
def test_local_energy_generic_cholesky_g_matches_jax(max_elems):
    jham, jtr = generic_system()
    tham, _ = generic_objects(jham, jtr)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((2, 7, 6, 6)) + 1j * rng.standard_normal(
        (2, 7, 6, 6))
    jout = jle.local_energy_generic_cholesky_G(jham, jnp.asarray(g[0]),
                                               jnp.asarray(g[1]))
    tout = tle.local_energy_generic_cholesky_G(tham, t(g[0]), t(g[1]),
                                               max_elems=max_elems)
    for a, b in zip(tout, jout):
        close(a.numpy(), b)
    fn = tmixed.energy_estimator_G(tham)
    close(fn(t(g[0]), t(g[1]))[0].numpy(), jout[0])


@pytest.mark.parametrize("discrete", [False, True])
@pytest.mark.parametrize("nstblz", [2, 5])
def test_back_propagate_matches_jax(discrete, nstblz):
    jham, jtr = hubbard4(ktwist=[0.01, -0.02])
    _, ttr = hubbard_objects(jham, jtr)
    if discrete:
        jprop = j_make_hirsch(jham, jtr, 0.05, sweep_kernel="scan")
        tprop = hirsch_port(jprop)
        fn_j, fn_t = jbp.back_propagate_hirsch, tbp.back_propagate_hirsch
    else:
        jprop = JContinuous(inner=j_mhc(jham, jtr, 0.05), dt=0.05)
        tprop = continuous_port(jprop)
        fn_j = jbp.back_propagate_continuous
        fn_t = tbp.back_propagate_continuous
    js = history_state(jtr, 5, 7, 9, seed=6, discrete=discrete)
    for tout, jout in zip(fn_t(tprop, ttr, t(js.configs), nstblz),
                          fn_j(jprop, jtr, js.configs, nstblz)):
        close(tout.numpy(), jout)


@pytest.mark.parametrize("restore", [None, "partial", "full"])
def test_bp_weights_match_jax(restore):
    jham, jtr = hubbard4()
    js = history_state(jtr, 6, 4, 9, seed=7)
    w = tbp.bp_weights(port_state(js), restore)
    close(w.numpy(), jbp.bp_weights(js, restore))
    if restore == "full":
        assert w[0] == 0 and (w[1:] != 0).all()


def test_bp_weights_guard_in_float32_reads_nonzero():
    """JAX's |cos| > 1e-300 rounds to |cos| > 0 in float32: a cosine
    product of 1e-30 is kept and a zero one dropped; in float64 a product
    below 1e-300 is dropped."""
    jham, jtr = hubbard4()
    ts = port_state(history_state(jtr, 3, 2, 9, seed=8))

    def weights(cos, cdtype, jcdtype):
        rdtype = cos.dtype
        st = tstate.WalkerState(
            phia=ts.phia, phib=ts.phib, weight=ts.weight.to(rdtype),
            unscaled_weight=ts.weight.to(rdtype), log_ovlp=ts.log_ovlp,
            hybrid_energy=ts.hybrid_energy, log_detr=ts.log_detr.to(rdtype),
            total_weight=ts.total_weight.to(rdtype), cos_fac=cos,
            weight_fac=torch.ones(3, 2, dtype=cdtype))
        jst = jstate.WalkerState(
            phia=None, phib=None,
            weight=jnp.asarray(ts.weight.to(rdtype).numpy()),
            unscaled_weight=None, phase=None, log_ovlp=None,
            hybrid_energy=None, eloc=None, log_detr=None, total_weight=None,
            cos_fac=jnp.asarray(cos.numpy()),
            weight_fac=jnp.ones((3, 2), jcdtype))
        w = tbp.bp_weights(st, "full")
        assert w.dtype == cdtype
        return (w != 0).tolist(), (np.asarray(
            jbp.bp_weights(jst, "full")) != 0).tolist()

    c32 = torch.tensor([[1e-20, 1e-10], [0.0, 1.0], [0.5, 1.0]],
                       dtype=torch.float32)
    assert weights(c32, torch.complex64, jnp.complex64) == (
        [True, False, True], [True, False, True])
    c64 = torch.tensor([[1e-310, 1.0], [0.0, 1.0], [0.5, 1.0]],
                       dtype=torch.float64)
    assert weights(c64, torch.complex128, jnp.complex128) == (
        [False, False, True], [False, False, True])


UPDATE_CASES = {
    "hubbard_discrete": dict(model="hubbard", discrete=True),
    "hubbard_continuous_split": dict(model="hubbard", nbp_len=3,
                                     restore="partial"),
    "generic_ekt_two_rdm": dict(model="generic", ekt=True, two_rdm="full",
                                restore="full"),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_back_prop_update_matches_jax(case):
    kw = UPDATE_CASES[case]
    discrete = kw.get("discrete", False)
    if kw["model"] == "hubbard":
        jham, jtr = hubbard4(ktwist=[0.01, -0.02])
        tham, ttr = hubbard_objects(jham, jtr)
        nf = 9
    else:
        jham, jtr = generic_system()
        tham, ttr = generic_objects(jham, jtr)
        nf = jham.nchol
    if discrete:
        jprop = j_make_hirsch(jham, jtr, 0.05, sweep_kernel="scan")
        tprop = hirsch_port(jprop)
    elif kw["model"] == "hubbard":
        jprop = JContinuous(inner=j_mhc(jham, jtr, 0.05), dt=0.05)
        tprop = continuous_port(jprop)
    else:
        jprop = JContinuous(inner=j_mgc(jham, jtr, 0.05), dt=0.05)
        tprop = continuous_port(jprop)
    js = history_state(jtr, 5, 6, nf, seed=9, itcf=False, discrete=discrete)
    opts = dict(nstblz=4, restore_weights=kw.get("restore"),
                discrete=discrete, eval_ekt=kw.get("ekt", False),
                nbp_len=kw.get("nbp_len"), calc_two_rdm=kw.get("two_rdm"))
    jacc = jbp.update(jham, jtr, jprop, js,
                      jmixed.energy_estimator_G(jham, jtr), **opts)
    tacc = tbp.update(tham, ttr, tprop, port_state(js),
                      tmixed.energy_estimator_G(tham), **opts)
    assert tacc.shape[0] == tbp.bp_acc_size(tham, kw.get("two_rdm"),
                                            kw.get("ekt", False))
    close(tacc.numpy(), jacc)


def test_structure_factor_and_unknown_two_rdm_raise():
    jham, jtr = hubbard4()
    tham, _ = hubbard_objects(jham, jtr)
    with pytest.raises(NotImplementedError, match="UEG"):
        tbp.bp_two_rdm_size(tham, "structure_factor")
    with pytest.raises(NotImplementedError):
        tbp.bp_two_rdm_size(tham, "half")
    assert tbp.bp_two_rdm_size(tham, "full") == 9 ** 4


# ---- two blocks against JAX's run_block -----------------------------------

@pytest.fixture
def tpu_branch(monkeypatch):
    """JAX's log-determinant with arg det wrapped into (-pi, pi], the
    branch of its TPU kernel (and of the port's kernel B); the jit caches
    are cleared on both sides of the test so no trace of the other branch
    is reused."""
    slogdet = jclinalg.slogdet

    def wrapped(s):
        ld = slogdet(s)
        return (ld.real + 1j * jnp.angle(jnp.exp(1j * ld.imag))).astype(
            ld.dtype)

    jax.clear_caches()
    monkeypatch.setattr(jclinalg, "slogdet", wrapped)
    yield
    jax.clear_caches()


def sweep_draws(kprop, nw, m):
    return jax.random.uniform(kprop, (m, nw), dtype=jnp.float64)


def normal_draws(nf):
    return lambda kprop, nw, m: jax.random.normal(kprop, (nw, nf),
                                                  dtype=jnp.float64)


def jax_noise(block_key, nsteps, nw, m, draw):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(draw(kprop, nw, m)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


def two_blocks(jham, jtr, jprop, tham, ttr, tprop, nw, draw, jextras,
               eshifts, free_projection=False, energy_eval_freq=1):
    """Two blocks of both run_blocks from the same initial walkers; every
    accumulator and the walkers at rtol 1e-8 / atol 1e-10. Returns the
    port's accumulators."""
    nhist = jextras.get("nprop_tot") or jextras.get("nbp", 0)
    js = j_init_walkers(jtr, nw, total_weight=float(nw),
                        nprop_tot=nhist or None,
                        nfields=jham.nfields if nhist else None,
                        itcf=bool(jextras.get("nitcf")))
    ts = port_state(js)
    text = tafqmc.Extras(**jextras)
    opts = dict(nsteps=10, nstblz=5, npop_control=1, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=energy_eval_freq)
    m = jham.nbasis
    out = []
    for block, eshift in enumerate(eshifts):
        key = jax.random.key(31 + block)
        js, jacc, jbp_acc, jitcf = jafqmc.run_block(
            jham, jtr, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(10 * block, jnp.int32),
            free_projection=free_projection, **opts, **jextras)
        ts, tacc, tbp_acc, titcf = tafqmc.run_block(
            tham, ttr, tprop, ts, None, eshift, 10 * block,
            free_projection=free_projection, extras=text,
            noise=jax_noise(key, 10, nw, m, draw), **opts)
        for a, b in ((tacc, jacc), (tbp_acc, jbp_acc), (titcf, jitcf)):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                       atol=1e-10)
        fields = ("phia", "phib", "weight", "unscaled_weight", "phase",
                  "eloc") + convert.HISTORY_FIELDS
        for f in fields:
            if getattr(js, f) is None:
                continue
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)
        out.append((tacc, tbp_acc, titcf))
    return out


@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_discrete_bp_itcf_blocks_match_jax(route):
    jham, jtr = hubbard4(nup=3, ndown=3)
    tham, ttr = hubbard_objects(jham, jtr)
    jprop = j_make_hirsch(jham, jtr, 0.05, sweep_kernel="scan")
    tprop = hirsch_port(jprop, route)
    assert route == "scan" or tham.T.is_complex() is False
    jextras = dict(nbp=4, bp_eval_energy=True, bp_restore="full",
                   nprop_tot=4, nitcf=3, itcf_stable=route == "kernel",
                   itcf_stack_size=1)
    out = two_blocks(jham, jtr, jprop, tham, ttr, tprop, 8, sweep_draws,
                     jextras, (0.0, -9.0))
    # Two BP and two ITCF measurements a block (steps 4 and 8, 12 and 16).
    assert all(float(o[1][0, 3]) != 0 and float(o[2][0, 0]) != 0
               for o in out)


def test_discrete_bp_itcf_stack_size_blocks_match_jax():
    jham, jtr = hubbard4(nup=3, ndown=3, ktwist=[0.01, -0.02])
    tham, ttr = hubbard_objects(jham, jtr)
    jprop = j_make_hirsch(jham, jtr, 0.05, sweep_kernel="scan")
    jextras = dict(nbp=5, bp_eval_energy=True, nprop_tot=5, nitcf=4,
                   itcf_stable=True, itcf_stack_size=2)
    two_blocks(jham, jtr, jprop, tham, ttr, hirsch_port(jprop), 6,
               sweep_draws, jextras, (0.0, -9.0))


def test_continuous_hubbard_bp_partial_blocks_match_jax(tpu_branch):
    jham, jtr = hubbard4(ktwist=[0.01, -0.02])
    tham, ttr = hubbard_objects(jham, jtr)
    jprop = JContinuous(inner=j_mhc(jham, jtr, 0.05), dt=0.05)
    jextras = dict(nbp=4, bp_nsplit=2, bp_eval_energy=True,
                   bp_restore="partial", nprop_tot=4)
    two_blocks(jham, jtr, jprop, tham, ttr, continuous_port(jprop), 8,
               normal_draws(9), jextras, (0.0, -10.0))


def test_generic_bp_ekt_blocks_match_jax(tpu_branch):
    jham, jtr = generic_system()
    tham, ttr = generic_objects(jham, jtr)
    jprop = JContinuous(inner=j_mgc(jham, jtr, 0.01), dt=0.01)
    jextras = dict(nbp=5, bp_eval_energy=True, bp_eval_ekt=True,
                   bp_two_rdm="full", nprop_tot=5)
    two_blocks(jham, jtr, jprop, tham, ttr, continuous_port(jprop), 6,
               normal_draws(jham.nchol), jextras, (0.0, float(jtr.etrial)))


# ---- driver ---------------------------------------------------------------

BP_ITCF = {"mixed": {"energy_eval_freq": 1},
           "back_propagation": {"tau_bp": 0.2, "evaluate_energy": True},
           "itcf": {"tau_max": 0.15, "tau_eqlb": 0.05, "stable": True,
                    "kspace": True}}


def test_h5_layout_of_bp_itcf_run_matches_jax(tmp_path):
    kw = dict(nwalkers=6, dt=0.05, nsteps=4, nblocks=3, rng_seed=2)
    popts = {"hubbard_stratonovich": "discrete"}
    jham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    JAFQMC(jham, free_electron_trial(jham), JQMCOpts(**kw),
           propagator_options=popts, estimator_options=BP_ITCF,
           filename=str(tmp_path / "jax.h5")).run()
    ham = t_make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    af = AFQMC(ham, t_free_electron(ham, **CPU), QMCOpts(**kw),
               propagator_options=popts, estimator_options=BP_ITCF,
               filename=str(tmp_path / "port.h5"), device="cpu")
    af.run()

    def layout(path):
        names = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: names.__setitem__(
                n, (o.shape, o.dtype.kind) if isinstance(o, h5py.Dataset)
                else None))
        return names

    port, ref = layout(tmp_path / "port.h5"), layout(tmp_path / "jax.h5")
    assert port == ref
    assert "back_propagated/energies_4/000000000" in port
    assert "itcf/k_space_greens_function/000000002" in port
    assert len(af.bp_reporter.rows) == 3 == len(af.itcf_reporter.rows)


@pytest.mark.parametrize("eopts,match", [
    ({"back_propagation": {"tau_bp": 0.2, "nsplit": 3}}, "nsplit"),
    ({"itcf": {"tau_max": 0.15, "stack_size": 2}}, "stack_size"),
    ({"back_propagation": {"tau_bp": 0.2}, "itcf": {"tau_max": 0.1}},
     "tau_max"),
])
def test_bp_itcf_option_errors_match_jax(eopts, match):
    jham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    with pytest.raises(ValueError, match=match):
        JAFQMC(jham, free_electron_trial(jham),
               JQMCOpts(nwalkers=4, dt=0.05, nsteps=2, nblocks=1),
               estimator_options=eopts, filename=os.devnull)
    ham = t_make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    with pytest.raises(ValueError, match=match):
        AFQMC(ham, t_free_electron(ham, **CPU),
              QMCOpts(nwalkers=4, dt=0.05, nsteps=2, nblocks=1),
              estimator_options=eopts, device="cpu")


def test_bp_itcf_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import make_hubbard, "
        "free_electron_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02], "
        "device='cpu', dtype='double')\n"
        "af = AFQMC(ham, free_electron_trial(ham, device='cpu', "
        "dtype='double'), QMCOpts(nwalkers=6, dt=0.05, nsteps=4, "
        "nblocks=2), propagator_options={'hubbard_stratonovich': "
        "'discrete'}, estimator_options={'back_propagation': {'tau_bp': "
        "0.2}, 'itcf': {'tau_max': 0.2}}, device='cpu')\n"
        "rows = af.run()\n"
        "assert rows.shape == (2, 11) and len(af.bp_reporter.rows) == 2\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pauxy_tpu', "
        "'h5py')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
