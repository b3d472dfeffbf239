"""Port parity: the multi-determinant (NOMSD / PHMSD) trials against JAX.

float64, the same inputs on both sides (numpy from a seed; JAX objects
carried across with pauxy_tpu_torch.utils.convert where a test compares one
step or block):
  * multi_slater_trial built by each package (orbitals, the span init,
    G_host, etrial, the per-determinant rchol / rh1), phmsd_trial and
    recompute_ci_coeffs (PHMSD and NOMSD branches): 1e-10;
  * greens_function_multi_det and log_overlap_multi_det on random walkers,
    and on walkers set exactly to a determinant (an exactly singular S_d,
    JAX's -inf + 0j log-det): 1e-10, finite;
  * local_energy_generic_opt_multi, the Generic force bias (det-weighted
    half-rotated and full-G branches), the Hubbard force bias from the
    det-weighted G, and mixed.update (Generic fast path, Hubbard dense-G
    det average): 1e-10;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws
    injected (normal(kprop, (w, X)), comb's uniform(kpop, ())), rtol 1e-8 /
    atol 1e-10, for NOMSD and PHMSD, Generic and Hubbard (continuous); a
    D = 1 expansion against the single-determinant block
    with the same draws;
  * AFQMC(...).run() with each trial, the refusals JAX keeps (back
    propagation and the ITCF with a multi-determinant trial), and no jax
    import.
"""

import itertools
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
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import multi_slater as jms
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.continuous import trial_greens as j_trial_greens
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.utils.transfer import HostArray
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import make_generic, make_hubbard
from pauxy_tpu_torch.models import multi_slater as tms
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.propagation.continuous import trial_greens
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.utils.testing import (
    generate_hamiltonian as t_generate_hamiltonian)
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")
MSD_GENERIC = ("rchola", "rcholb", "rh1a", "rh1b")


# JAX's device functions compiled whole: much faster here than op by op.
j_greens = jax.jit(jms.greens_function_multi_det)
j_log_overlap = jax.jit(jms.log_overlap_multi_det)
j_energy_multi = jax.jit(jle.local_energy_generic_opt_multi)
j_update = jax.jit(jmixed.update, static_argnames=(
    "eval_energy", "free_projection", "calc_one_rdm", "calc_two_rdm"))
j_force_bias = jax.jit(lambda inner, tr, ga, gb: inner.force_bias(tr, ga, gb))
j_trial_greens_jit = jax.jit(j_trial_greens)


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def port_trial(jt):
    """The port's trial from the JAX one's arrays."""
    return convert.multi_slater_trial(
        *(np.asarray(getattr(jt, k)) for k in ("psia", "psib", "coeffs",
                                               "inita", "initb")),
        G_host=np.asarray(jt.G_host.arr), etrial=jt.etrial, device="cpu",
        **{k: None if getattr(jt, k) is None else np.asarray(getattr(jt, k))
           for k in MSD_GENERIC})


def jax_trial(tt):
    """The JAX trial from the port's arrays (skips JAX's host construction,
    whose eager set-up is slow on the CPU)."""
    def arr(k):
        x = getattr(tt, k)
        return None if x is None else jnp.asarray(x.numpy())

    return jms.MultiSlaterTrial(
        **{k: arr(k) for k in ("psia", "psib", "coeffs", "inita", "initb")
           + MSD_GENERIC},
        G_host=HostArray(tt.G_host), etrial=tt.etrial)


def hubbard_pair(nup=3, ndown=3, nx=3, ny=3):
    jham = j_make_hubbard(nup=nup, ndown=ndown, U=4.0, nx=nx, ny=ny)
    tham = make_hubbard(nup, ndown, U=4.0, nx=nx, ny=ny, **CPU)
    return jham, tham


def generic_pair(nmo, nelec, seed):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    jham = j_make_generic(nelec, h1e, chol, enuc)
    tham = make_generic(nelec, h1e, chol, enuc, **CPU)
    return jham, tham


def random_msd(rng, ndets, m, ne, scale=1.0):
    psi = rng.standard_normal((ndets, m, ne)) + 1j * scale * (
        rng.standard_normal((ndets, m, ne)))
    coeffs = rng.standard_normal(ndets) + 1j * scale * (
        rng.standard_normal(ndets))
    return psi, coeffs


def walkers(rng, nw, m, na, nb, scale=1.0):
    phi = rng.standard_normal((nw, m, na + nb)) + 1j * scale * (
        rng.standard_normal((nw, m, na + nb)))
    return phi[:, :, :na], phi[:, :, na:]


# --------------------------------------------------------- construction ---

@pytest.mark.parametrize("model", ["hubbard", "generic"])
def test_multi_slater_trial_matches_jax(model):
    rng = np.random.default_rng(2)
    if model == "hubbard":
        jham, tham = hubbard_pair()
    else:
        jham, tham = generic_pair(7, (3, 2), 4)
    m, ne = jham.nbasis, jham.nup + jham.ndown
    psi, coeffs = random_msd(rng, 3, m, ne)
    jt = jms.multi_slater_trial(jham, psi, coeffs)
    tt = tms.multi_slater_trial(tham, psi, coeffs, **CPU)
    assert tt.ndets == 3 and (tt.nup, tt.ndown) == (jham.nup, jham.ndown)
    for k in ("psia", "psib", "coeffs", "inita", "initb") + MSD_GENERIC:
        if getattr(jt, k) is None:
            assert getattr(tt, k) is None
        else:
            close(getattr(tt, k).numpy(), getattr(jt, k))
    close(tt.G_host, np.asarray(jt.G_host.arr))
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10, abs=1e-10)
    carried = port_trial(jt)
    for k in ("psia", "psib", "coeffs", "inita", "initb") + MSD_GENERIC:
        if getattr(tt, k) is not None:
            close(getattr(carried, k).numpy(), getattr(tt, k).numpy())
    # An explicit init and default coefficients.
    init = psi[0]
    jt = jms.multi_slater_trial(jham, psi, init=init)
    tt = tms.multi_slater_trial(tham, psi, init=init, **CPU)
    close(tt.coeffs.numpy(), np.ones(3))
    close(tt.G_host, np.asarray(jt.G_host.arr))


def test_phmsd_trial_and_recompute_ci_coeffs_match_jax():
    jham, tham = generic_pair(5, (2, 2), 6)
    occ = list(itertools.combinations(range(5), 2))[:4]
    occa = [o for o in occ for _ in occ]
    occb = [o for _ in occ for o in occ]
    jc, je = jms.recompute_ci_coeffs(jham, occa=occa, occb=occb)
    tc, te = tms.recompute_ci_coeffs(tham, occa=occa, occb=occb)
    assert te == pytest.approx(je, rel=1e-12, abs=1e-12)
    close(np.abs(tc), np.abs(jc))
    jt = jms.phmsd_trial(jham, jc, occa, occb)
    tt = tms.phmsd_trial(tham, jc, occa, occb, **CPU)
    for k in ("psia", "psib", "inita", "initb"):
        close(getattr(tt, k).numpy(), getattr(jt, k))
    close(tt.G_host, np.asarray(jt.G_host.arr))
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
    # The non-orthogonal branch (generalized eigenproblem).
    rng = np.random.default_rng(5)
    psi = np.stack([np.linalg.qr(rng.standard_normal((5, 4)))[0]
                    for _ in range(3)])
    jc, je = jms.recompute_ci_coeffs(jham, psi, 2)
    tc, te = tms.recompute_ci_coeffs(tham, psi, 2)
    assert te == pytest.approx(je, rel=1e-10)
    close(np.abs(tc), np.abs(jc))


# ------------------------------------------------------ Green's function ---

def test_greens_and_overlap_match_jax():
    rng = np.random.default_rng(7)
    _, tham = hubbard_pair()
    psi, coeffs = random_msd(rng, 3, 9, 6)
    tt = tms.multi_slater_trial(tham, psi, coeffs, **CPU)
    jt = jax_trial(tt)
    pa, pb = walkers(rng, 5, 9, 3, 3)
    jmd = j_greens(jt, jnp.asarray(pa), jnp.asarray(pb))
    tmd = tms.greens_function_multi_det(tt, t(pa), t(pb))
    for f in jmd._fields:
        close(getattr(tmd, f).numpy(), getattr(jmd, f))
    close(tms.log_overlap_multi_det(tt, t(pa), t(pb)).numpy(),
          j_log_overlap(jt, jnp.asarray(pa), jnp.asarray(pb)))
    # Without the full G, the rest is the same.
    half = tms.greens_function_multi_det(tt, t(pa), t(pb), want_g=False)
    assert half.G is None and half.Gi is None
    close(half.Ghalfa.numpy(), tmd.Ghalfa.numpy(), 0)
    close(half.log_ovlp.numpy(), tmd.log_ovlp.numpy(), 0)


def test_singular_determinant_matches_jax():
    """Walkers set exactly to the first PHMSD determinant: S_d of the
    second one is [[1, 0], [0, 0]], whose log-det JAX gives as -inf + 0j;
    G, the weights and the overlap stay finite and equal JAX's."""
    tham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **CPU)
    tt = tms.phmsd_trial(tham, coeffs=[0.95, 0.05], occa=[(0, 1), (0, 2)],
                         occb=[(0, 1), (0, 1)], **CPU)
    jt = jax_trial(tt)
    pa = np.broadcast_to(np.asarray(jt.psia[0]), (4, 4, 2)).copy()
    pb = np.broadcast_to(np.asarray(jt.psib[0]), (4, 4, 2)).copy()
    jmd = j_greens(jt, jnp.asarray(pa), jnp.asarray(pb))
    tmd = tms.greens_function_multi_det(tt, t(pa), t(pb))
    for f in jmd._fields:
        got = getattr(tmd, f).numpy()
        assert np.isfinite(got).all(), f
        close(got, getattr(jmd, f))
    lo = tms.log_overlap_multi_det(tt, t(pa), t(pb)).numpy()
    assert np.isfinite(lo).all()
    close(lo, j_log_overlap(jt, jnp.asarray(pa), jnp.asarray(pb)))
    # The default initial walker overlaps every determinant.
    tmd = tms.greens_function_multi_det(tt, tt.inita[None], tt.initb[None])
    assert np.abs(tmd.det_weights.numpy()).min() > 0


def test_walker_on_a_determinant_of_the_full_space():
    """Walkers exactly on the first determinant of a full-space PHMSD
    expansion: the other determinants' S_d are exactly singular, past single
    excitations with a zero pivot before the last (JAX's log-det, and so
    its overlap, is nan there). The port's G, weights and overlap are
    finite and the overlap is conj(c_0); the energy drops the orthogonal
    determinants' terms, so it is E_FCI only near the determinant (the
    trial is the exact ground state)."""
    _, tham = generic_pair(4, (2, 2), 7)
    occ = list(itertools.combinations(range(4), 2))
    occa = [o for o in occ for _ in occ]
    occb = [o for _ in occ for o in occ]
    coeffs, e0 = tms.recompute_ci_coeffs(tham, occa=occa, occb=occb)
    tt = tms.phmsd_trial(tham, coeffs, occa, occb, **CPU)
    pa = tt.psia[0].expand(3, -1, -1).contiguous()
    pb = tt.psib[0].expand(3, -1, -1).contiguous()
    md = tms.greens_function_multi_det(tt, pa, pb)
    lo = tms.log_overlap_multi_det(tt, pa, pb)
    for x in (md.G, md.det_weights, md.log_ovlp, lo):
        assert torch.isfinite(x).all()
    close(np.exp(lo.numpy()), np.conj(coeffs[0]), 1e-12)
    close(np.exp(md.log_ovlp.numpy()), np.conj(coeffs[0]), 1e-12)
    rng = np.random.default_rng(1)
    near = [x + 1e-3 * t(rng.standard_normal(x.shape) + 0j) for x in (pa, pb)]
    md = tms.greens_function_multi_det(tt, *near)
    e = tle.local_energy_generic_opt_multi(tt, md.Ghalfa, md.Ghalfb,
                                           md.det_weights, tham.ecore)[0]
    close(e.numpy(), e0, 1e-10)


def test_single_det_limit():
    """D = 1 reproduces the single-determinant Green's function and
    overlap."""
    rng = np.random.default_rng(3)
    _, tham = hubbard_pair()
    psi = rng.standard_normal((9, 6)) + 1j * rng.standard_normal((9, 6))
    msd = tms.multi_slater_trial(tham, psi[None], np.ones(1), **CPU)
    sd = ttrial.trial_from_orbitals(tham, psi, **CPU)
    pa, pb = walkers(rng, 3, 9, 3, 3)
    ga, gb, lo = trial_greens(msd, t(pa), t(pb), want_g=True)
    sa, sb, slo = trial_greens(sd, t(pa), t(pb), want_g=True)
    close(ga.G.numpy(), sa.G.numpy(), 1e-9)
    close(gb.G.numpy(), sb.G.numpy(), 1e-9)
    close(np.exp(lo.numpy() - slo.numpy()), 1.0, 1e-9)


# --------------------------------------------- energies and force bias ---

def test_generic_energy_and_force_bias_match_jax():
    rng = np.random.default_rng(7)
    jham, tham = generic_pair(9, (3, 3), 7)
    psi, coeffs = random_msd(rng, 4, 9, 6, 0.1)
    tt = tms.multi_slater_trial(tham, psi, coeffs, **CPU)
    jt = jax_trial(tt)
    pa, pb = walkers(rng, 5, 9, 3, 3, 0.1)
    jpa, jpb = jnp.asarray(pa), jnp.asarray(pb)
    jmd = j_greens(jt, jpa, jpb)
    tmd = tms.greens_function_multi_det(tt, t(pa), t(pb))
    want = j_energy_multi(jt, jmd.Ghalfa, jmd.Ghalfb, jmd.det_weights,
                          jham.ecore)
    got = tle.local_energy_generic_opt_multi(tt, tmd.Ghalfa, tmd.Ghalfb,
                                             tmd.det_weights, tham.ecore)
    for a, b in zip(got, want):
        close(a.numpy(), b)
    jinner = j_mgc(jham, jt, 0.01)
    tinner = convert.generic_continuous(
        np.asarray(jinner.BH1), np.asarray(jinner.mf_shift),
        np.asarray(jinner.chol), dt=0.01, device="cpu")
    jga, jgb, _ = j_trial_greens_jit(jt, jpa, jpb)
    tga, tgb, _ = trial_greens(tt, t(pa), t(pb), want_g=True)
    close(tinner.force_bias(tt, tga, tgb).numpy(),
          j_force_bias(jinner, jt, jga, jgb))
    close(tinner.force_bias(tt, tga._replace(Ghalf=None),
                            tgb._replace(Ghalf=None)).numpy(),
          j_force_bias(jinner, jt, jga._replace(Ghalf=None),
                       jgb._replace(Ghalf=None)))
    # The mixed estimator's step (the fast per-determinant energy).
    js = j_init_walkers(jt, 5).replace(phia=jpa, phib=jpb)
    ts = init_walkers(tt, 5)
    ts.phia, ts.phib = t(pa), t(pb)
    close(tmixed.update(tham, tt, ts, True).numpy(),
          j_update(jham, jt, js, True))


def test_hubbard_force_bias_and_mixed_update_match_jax():
    rng = np.random.default_rng(11)
    jham, tham = hubbard_pair()
    psi, coeffs = random_msd(rng, 3, 9, 6)
    tt = tms.multi_slater_trial(tham, psi, coeffs, **CPU)
    jt = jax_trial(tt)
    pa, pb = walkers(rng, 4, 9, 3, 3)
    jpa, jpb = jnp.asarray(pa), jnp.asarray(pb)
    jinner = j_mhc(jham, jt, 0.01)
    tinner = convert.hubbard_continuous(
        np.asarray(jinner.BH1), np.asarray(jinner.mf_shift), dt=0.01,
        U=4.0, charge=True, device="cpu")
    jga, jgb, _ = j_trial_greens_jit(jt, jpa, jpb)
    tga, tgb, _ = trial_greens(tt, t(pa), t(pb), want_g=True)
    close(tinner.force_bias(tt, tga, tgb).numpy(),
          j_force_bias(jinner, jt, jga, jgb))
    js = j_init_walkers(jt, 4).replace(phia=jpa, phib=jpb)
    ts = init_walkers(tt, 4)
    close(ts.log_ovlp.numpy(), j_init_walkers(jt, 4).log_ovlp)
    ts.phia, ts.phib = t(pa), t(pb)
    for rdm in (False, True):
        close(tmixed.update(tham, tt, ts, True, calc_one_rdm=rdm).numpy(),
              j_update(jham, jt, js, True, calc_one_rdm=rdm))


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


def port_inner(jinner):
    if hasattr(jinner, "U"):
        return convert.hubbard_continuous(
            np.asarray(jinner.BH1), np.asarray(jinner.mf_shift),
            dt=jinner.dt, U=jinner.U, charge=jinner.charge, device="cpu")
    return convert.generic_continuous(
        np.asarray(jinner.BH1), np.asarray(jinner.mf_shift),
        np.asarray(jinner.chol), dt=jinner.dt, device="cpu")


def two_blocks(jham, jt, jinner, tham, tt, nw, dt, **mixed_opts):
    """Two blocks of both run_blocks from the same walkers with JAX's
    draws: the mixed accumulators, weights and walkers at rtol 1e-8."""
    jprop = JContinuous(inner=jinner, dt=dt)
    tprop = Continuous(inner=port_inner(jinner), dt=dt)
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    ts = init_walkers(tt, nw, total_weight=float(nw))
    opts = dict(nsteps=5, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    accs = []
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(41 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(5 * block, jnp.int32), free_projection=False,
            **mixed_opts, **opts)
        ts, tacc, _, _ = tafqmc.run_block(
            tham, tt, tprop, ts, None, eshift, 5 * block,
            noise=jax_noise(key, 5, nw, jham.nfields), **mixed_opts, **opts)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib", "log_ovlp", "hybrid_energy"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)
        accs.append(tacc)
    return accs


def test_nomsd_generic_blocks_match_jax():
    jham, tham = generic_pair(6, (2, 2), 31)
    rng = np.random.default_rng(17)
    eye = np.eye(6)[:, :4]
    psi = np.stack([eye, eye + 0.05 * rng.standard_normal(eye.shape)])
    tt = tms.multi_slater_trial(tham, psi, np.array([0.95, 0.05]), **CPU)
    jt = jax_trial(tt)
    two_blocks(jham, jt, j_mgc(jham, jt, 0.005), tham, tt, 8, 0.005)


def test_phmsd_generic_blocks_match_jax():
    jham, tham = generic_pair(4, (2, 2), 5)
    occ = list(itertools.combinations(range(4), 2))
    occa = [o for o in occ for _ in occ]
    occb = [o for _ in occ for o in occ]
    coeffs, _ = tms.recompute_ci_coeffs(tham, occa=occa, occb=occb)
    tt = tms.phmsd_trial(tham, coeffs, occa, occb, **CPU)
    jt = jax_trial(tt)
    two_blocks(jham, jt, j_mgc(jham, jt, 0.01), tham, tt, 6, 0.01)


@pytest.mark.parametrize("family", ["nomsd", "phmsd"])
def test_msd_hubbard_blocks_match_jax(family):
    if family == "nomsd":
        jham, tham = hubbard_pair()
        fe = ttrial.free_electron_trial(tham, **CPU)
        base = torch.cat([fe.psia, fe.psib], dim=1).numpy()
        rng = np.random.default_rng(5)
        pert = base + 0.05 * rng.standard_normal(base.shape)
        tt = tms.multi_slater_trial(tham, np.stack([base, pert]),
                                    np.array([0.9, 0.1]), **CPU)
    else:
        # A 6-site ring's PHMSD in the site basis, its coefficients from
        # the rediagonalisation (Slater-Condon elements).
        jham, tham = hubbard_pair(2, 2, 6, 1)
        occ = [(0, 1), (0, 3), (1, 4), (2, 5)]
        occa = [o for o in occ for _ in occ]
        occb = [o for _ in occ for o in occ]
        coeffs, _ = tms.recompute_ci_coeffs(tham, occa=occa, occb=occb)
        tt = tms.phmsd_trial(tham, coeffs, occa, occb, **CPU)
    jt = jax_trial(tt)
    two_blocks(jham, jt, j_mhc(jham, jt, 0.01), tham, tt, 8, 0.01)


def test_one_determinant_block_equals_single_det_block():
    """A D = 1 expansion through the block gives the single-determinant
    block's numbers with the same draws."""
    _, tham = hubbard_pair()
    sd = ttrial.free_electron_trial(tham, **CPU)
    psi = torch.cat([sd.psia, sd.psib], dim=1).numpy()
    msd = tms.multi_slater_trial(tham, psi[None], init=psi, **CPU)
    rng = np.random.default_rng(0)
    noise = BlockNoise(t(rng.standard_normal((5, 6, 9))),
                       t(rng.uniform(size=(5, 1))))
    opts = dict(nsteps=5, nstblz=2, npop_control=2, pop_method="comb",
                target_weight=6.0, energy_eval_freq=1)
    out = []
    for trial in (sd, msd):
        from pauxy_tpu_torch.propagation.hubbard import (
            make_hubbard_continuous)
        prop = Continuous(inner=make_hubbard_continuous(tham, trial, 0.01,
                                                        **CPU), dt=0.01)
        state = init_walkers(trial, 6, total_weight=6.0)
        state, acc, _, _ = tafqmc.run_block(tham, trial, prop, state, None,
                                            0.0, 0, noise=noise, **opts)
        out.append((acc.numpy(), state.weight.numpy()))
    close(out[1][0][0], out[0][0][0], 1e-9)
    close(out[1][1], out[0][1], 1e-9)


# ------------------------------------------------------------- driver ---

def test_afqmc_runs_multi_determinant_trials():
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    fe = ttrial.free_electron_trial(ham, **CPU)
    base = torch.cat([fe.psia, fe.psib], dim=1).numpy()
    rng = np.random.default_rng(5)
    trial = tms.multi_slater_trial(
        ham, np.stack([base, base + 0.05 * rng.standard_normal(base.shape)]),
        np.array([0.9, 0.1]), **CPU)
    qmc = QMCOpts(nwalkers=6, dt=0.01, nsteps=4, nblocks=2, nstblz=2,
                  rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    assert not af.use_fast_block
    rows = af.run()
    assert np.isfinite(rows).all() and -12 < rows[-1, 5].real < -5
    h1e, chol, enuc, _ = t_generate_hamiltonian(6, (2, 2), seed=31)
    gham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    occ = [(0, 1), (0, 2)]
    gtrial = tms.phmsd_trial(gham, [0.9, 0.1], occ, occ, **CPU)
    rows = AFQMC(gham, gtrial, qmc,
                 propagator_options={"taylor_impl": "pallas"},
                 device="cpu").run()
    assert np.isfinite(rows).all()
    for eopts in ({"back_propagation": {"tau_bp": 0.04}},
                  {"itcf": {"tau_max": 0.04}}):
        with pytest.raises(NotImplementedError, match="single-determinant"):
            AFQMC(ham, trial, qmc, estimator_options=eopts, device="cpu")
    with pytest.raises(NotImplementedError, match="continuous"):
        AFQMC(ham, trial, qmc,
              propagator_options={"hubbard_stratonovich": "discrete"},
              device="cpu")


def test_generate_hamiltonian_copy_matches_jax():
    for a, b in zip(t_generate_hamiltonian(6, (2, 2), seed=31, nchol=20),
                    generate_hamiltonian(6, (2, 2), seed=31, nchol=20)):
        close(a, b, 0)


def test_multi_slater_run_pulls_in_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from pauxy_tpu_torch.models import make_hubbard, phmsd_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, device='cpu',"
        " dtype='double')\n"
        "tr = phmsd_trial(ham, [0.9, 0.1], [(0, 1), (0, 2)], [(0, 1),"
        " (0, 1)], device='cpu', dtype='double')\n"
        "AFQMC(ham, tr, QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),"
        " device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
