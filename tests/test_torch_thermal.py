"""Port tests for the finite-temperature pieces against the JAX package.

All in float64 on the CPU, the same inputs (numpy, from a seed) through
both packages:

* QDT stratification: the product's Green's function and log det G at
  1e-10 (relative to max|G| and to |log det G|), on random stacks and on a
  beta = 16 free-fermion stack (16 bins of exp(-h)), where log det G must
  also equal the exact -sum log(1 + e^{-beta eps});
* ``make_one_body_trial``: mu, left_table, bin_full and P at 1e-10 for the
  3x3 Hubbard model (mu bisected) and a small UEG;
* ``make_ueg``'s tables exactly, ``ops/ueg_sparse`` and ``local_energy_ueg``
  at 1e-10;
* the propagator set-up (BH1, mf_shift, mf_const_fac) at 1e-12;
* one slice with JAX's xi injected: G, log_m0, weight and hybrid energy at
  rtol 1e-8, and the prefix-cached refold against a full re-stratification
  (equal up to rounding: the fold sequence is the same, merely cached);
* population control moving every per-walker field of the thermal state,
  the stack and the prefix carry included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import thermal as jth
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models.thermal_trial import make_one_body_trial as j_mobt
from pauxy_tpu.ops import ueg_sparse as jsparse
from pauxy_tpu.propagation.thermal import make_thermal_propagator as j_mtp
from pauxy_tpu.walkers import pop_control as jpc
from pauxy_tpu.walkers import thermal_state as jtws
from pauxy_tpu_torch.estimators import local_energy as le
from pauxy_tpu_torch.estimators import thermal as th
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
from pauxy_tpu_torch.models.ueg import make_ueg
from pauxy_tpu_torch.ops import ueg_sparse
from pauxy_tpu_torch.propagation.thermal import make_thermal_propagator
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import pop_control as pc
from pauxy_tpu_torch.walkers import thermal_state as tws

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
# The JAX references under jit: traced once per shape instead of each of
# their loops being compiled on every eager call.
JAX_QDT_LOGDET = jax.jit(jth.greens_function_qdt_logdet)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = np_(a), np_(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def hubbard_pair(U=4.0):
    return (j_make_hubbard(nup=3, ndown=3, U=U, nx=3, ny=3),
            make_hubbard(3, 3, U=U, nx=3, ny=3, **CPU))


def ueg_pair(ecut=1.0):
    return (j_make_ueg(nup=1, ndown=1, rs=1.0, ecut=ecut),
            make_ueg(1, 1, rs=1.0, ecut=ecut, **CPU))


# ---------------------------------------------------------------- QDT ---

@pytest.mark.parametrize("m,nbins", [(5, 1), (9, 4), (19, 3)])
def test_qdt_greens_and_logdet_match_jax(m, nbins):
    rng = np.random.default_rng(m)
    stack = (np.eye(m) + 0.4 * (rng.normal(size=(3, 2, nbins, m, m))
                                + 1j * rng.normal(size=(3, 2, nbins, m, m))))
    gj, ldj = (np.asarray(x) for x in
               JAX_QDT_LOGDET(jnp.asarray(stack)))
    g, ld = th.greens_function_qdt_logdet(torch.from_numpy(stack))
    assert rel(g, gj) < 1e-10
    d = np_(ld) - ldj
    assert np.abs(d.real).max() < 1e-10 * np.abs(ldj).max()
    assert np.abs(np.angle(np.exp(1j * d.imag))).max() < 1e-10
    gp = th.greens_function_qdt(torch.from_numpy(stack))
    assert rel(gp, gj) < 1e-10
    q, d_, t = th.qdt_product(torch.from_numpy(stack))
    a = np.eye(m)
    for i in range(nbins):
        a = stack[:, :, i] @ a
    qdt = np_(q) @ (np_(d_)[..., :, None] * np_(t))
    assert rel(qdt, a) < 1e-10


def test_qdt_beta16_free_fermions():
    """16 bins of exp(-h) for the 3x3 lattice: cond(A) ~ e^{16 * 6}; G and
    log det G against JAX and the exact free-fermion values."""
    _, ham = hubbard_pair(U=0.0)
    h = ham.T[0].numpy()
    b = scipy.linalg.expm(-h)
    stack = np.broadcast_to(b, (2, 2, 16, 9, 9)).astype(np.complex128)
    g, ld = th.greens_function_qdt_logdet(torch.from_numpy(stack))
    gj, ldj = (np.asarray(x) for x in JAX_QDT_LOGDET(jnp.asarray(stack)))
    eps, u = np.linalg.eigh(h)
    g_exact = (u / (1.0 + np.exp(-16.0 * eps))) @ u.T
    ld_exact = -np.sum(np.log1p(np.exp(-16.0 * eps)))
    assert np.isfinite(np_(ld)).all()
    assert rel(g[0, 0], g_exact) < 1e-10
    assert rel(g, gj) < 1e-10
    assert np.abs(np_(ld).real - ld_exact).max() < 1e-10 * abs(ld_exact)
    assert np.abs(np_(ld) - ldj).max() < 1e-10 * abs(ld_exact)


def test_one_rdm_and_particle_number():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(4, 2, 6, 6)) + 1j * rng.normal(size=(4, 2, 6, 6))
    p = th.one_rdm_from_G(torch.from_numpy(g))
    pj = jth.one_rdm_from_G(jnp.asarray(g))
    np.testing.assert_array_equal(np_(p), np.asarray(pj))
    np.testing.assert_allclose(np_(th.particle_number(p)),
                               np.asarray(jth.particle_number(pj)),
                               rtol=1e-14)
    bt = np.stack([scipy.linalg.expm(-0.3 * np.diag(np.arange(6.0)))] * 2)
    np.testing.assert_allclose(th.one_rdm_stable_host(bt, 5),
                               jth.one_rdm_stable_host(bt, 5), atol=1e-14)


# -------------------------------------------------------------- trial ---

@pytest.mark.parametrize("system", ["hubbard", "ueg"])
def test_one_body_trial_matches_jax(system):
    if system == "hubbard":
        jham, ham = hubbard_pair()
        kw = dict(beta=0.5, dt=0.05)
    else:
        jham, ham = ueg_pair()
        kw = dict(beta=0.25, dt=0.025, mu=0.245)
    jt = j_mobt(jham, **kw)
    t = make_one_body_trial(ham, **kw, **CPU)
    assert t.stack_size == jt.stack_size and t.nbins == jt.nbins
    assert t.num_slices == jt.num_slices
    assert abs(t.mu - jt.mu) < 1e-10 and abs(t.nav - jt.nav) < 1e-10
    for name in ("dmat", "dmat_inv", "left_table", "bin_full"):
        assert rel(getattr(t, name), getattr(jt, name)) < 1e-10, name
    assert rel(t.P_host, jt.P_host.arr) < 1e-10
    assert rel(t.G_host, jt.G_host.arr) < 1e-10


# ---------------------------------------------------------------- UEG ---

@pytest.mark.parametrize("ecut", [0.5, 1.0, 2.0])
def test_make_ueg_tables_exact(ecut):
    jham, ham = ueg_pair(ecut)
    for name in ("kpq_idx", "kpq_mask", "pmq_idx", "pmq_mask"):
        np.testing.assert_array_equal(np_(getattr(ham, name)),
                                      np.asarray(getattr(jham, name)))
    for name in ("H1", "h1e_mod", "vqvec"):
        np.testing.assert_array_equal(np_(getattr(ham, name)),
                                      np.asarray(getattr(jham, name)))
    np.testing.assert_array_equal(ham.basis, np.asarray(jham.basis))
    np.testing.assert_array_equal(ham.qvecs, np.asarray(jham.qvecs))
    for name in ("vol", "kfac", "ecore", "ef", "nbasis", "nq", "nfields"):
        assert getattr(ham, name) == getattr(jham, name), name


def test_ueg_sparse_and_energy_match_jax():
    jham, ham = ueg_pair(2.0)
    m = ham.nbasis
    jsp = jsparse.make_sparse_rho(jham, np.float64)
    sp = ueg_sparse.make_sparse_rho(ham, torch.float64)
    for name in ("qmap", "fac", "kpq_idx", "kpq_fac", "qfac"):
        np.testing.assert_array_equal(np_(getattr(sp, name)),
                                      np.asarray(getattr(jsp, name)))
    rng = np.random.default_rng(4)
    g = rng.normal(size=(3, m, m)) + 1j * rng.normal(size=(3, m, m))
    c1 = rng.normal(size=(3, ham.nq)) + 1j * rng.normal(size=(3, ham.nq))
    c2 = rng.normal(size=(3, ham.nq)) + 1j * rng.normal(size=(3, ham.nq))
    for a, b in zip(ueg_sparse.rho_expectations(sp, torch.from_numpy(g)),
                    jax.jit(jsparse.rho_expectations)(jsp, jnp.asarray(g))):
        assert rel(a, b) < 1e-12
    assert rel(ueg_sparse.assemble_vhs(sp, torch.from_numpy(c1),
                                       torch.from_numpy(c2)),
               jax.jit(jsparse.assemble_vhs)(jsp, jnp.asarray(c1),
                                             jnp.asarray(c2))
               ) < 1e-12
    ga, gb = g, 0.5 * g.conj()
    for a, b in zip(le.local_energy_ueg(ham, torch.from_numpy(ga),
                                        torch.from_numpy(gb)),
                    jax.jit(jle.local_energy_ueg)(jham, jnp.asarray(ga),
                                                  jnp.asarray(gb))):
        assert rel(a, b) < 1e-10
    # The q-chunked exchange is independent of the chunking.
    gt = torch.from_numpy(g)
    full = le.exchange_greens_function_ueg(ham, gt, q_chunk=ham.nq)
    assert rel(le.exchange_greens_function_ueg(ham, gt, q_chunk=7), full) \
        < 1e-13
    assert rel(le.exchange_greens_function_ueg(ham, gt, max_elems=m * m),
               full) < 1e-13


# -------------------------------------------------------- propagator ---

def setup(system, stack_size=None, nw=4, options=None):
    if system == "hubbard":
        jham, ham = hubbard_pair()
        kw = dict(beta=0.5, dt=0.05, mu=0.9)
    else:
        jham, ham = ueg_pair()
        kw = dict(beta=0.25, dt=0.025, mu=0.245)
    jt = j_mobt(jham, stack_size=stack_size, **kw)
    t = make_one_body_trial(ham, stack_size=stack_size, **kw, **CPU)
    jp = j_mtp(jham, jt, kw["dt"], options=options)
    p = make_thermal_propagator(ham, t, kw["dt"], options, **CPU)
    return jham, ham, jt, t, jp, p, nw


@pytest.mark.parametrize("system", ["hubbard", "ueg"])
def test_propagator_setup_matches_jax(system):
    _, _, _, _, jp, p, _ = setup(system)
    assert rel(p.inner.BH1, jp.inner.BH1) < 1e-12
    if system == "hubbard":
        assert rel(p.inner.mf_shift, jp.inner.mf_shift) < 1e-12
    else:
        assert not np_(p.inner.mf_shift).any()
        assert p.inner.mf_shift.shape == jp.inner.mf_shift.shape
    assert abs(p.mf_const_fac - jp.mf_const_fac) < 1e-12
    assert (p.force_bias, p.fb_bound, p.free_projection) == (
        jp.force_bias, jp.fb_bound, jp.free_projection)


def jax_propagate(jp):
    """JAX's propagate under one jit (ts traced), so that each slice does
    not retrace its loops."""
    return jax.jit(lambda trial, state, key, ts: jp.propagate(
        trial, state, key, ts))


def jax_state_to_port(js):
    return convert.thermal_walker_state(
        **{k: np.asarray(getattr(js, k)) for k in (
            "stack", "right", "G", "log_m0", "weight", "unscaled_weight",
            "phase", "total_weight", "hybrid_energy", "pq", "pd", "pt")},
        device="cpu")


@pytest.mark.parametrize("system,stack_size,options", [
    ("hubbard", None, None), ("hubbard", 2, None), ("ueg", 2, None),
    ("hubbard", 2, {"free_projection": True})])
def test_slices_with_injected_fields_match_jax(system, stack_size, options):
    """Slices 0..5 (with stack_size 2: bin entries and the prefix fold)
    with JAX's draws: G, log_m0, weight, phase and hybrid energy at rtol
    1e-8, phaseless and free projection."""
    _, _, jt, t, jp, p, nw = setup(system, stack_size, options=options)
    js = jtws.init_thermal_walkers(jt, nw)
    s = tws.init_thermal_walkers(t, nw)
    assert rel(s.G, js.G) < 1e-12 and rel(s.stack, js.stack) < 1e-12
    jprop = jax_propagate(jp)
    key = jax.random.PRNGKey(5)
    for ts in range(6):
        key, k = jax.random.split(key)
        xi = np.asarray(jax.random.normal(k, (nw, p.nfields),
                                          dtype=jnp.float64))
        js = jprop(jt, js, k, ts)
        s = p.propagate(t, s, ts, torch.from_numpy(xi.copy()))
        for name in ("G", "log_m0", "weight", "phase", "hybrid_energy",
                     "stack", "pq", "pd", "pt"):
            np.testing.assert_allclose(np_(getattr(s, name)),
                                       np.asarray(getattr(js, name)),
                                       rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("system", ["hubbard", "ueg"])
def test_convert_builds_the_port_objects_from_jax(system):
    """utils/convert from the JAX objects' arrays gives the objects the
    port's own builders give, and a slice of them matches JAX's."""
    jham, ham, jt, t, jp, p, nw = setup(system, stack_size=2)
    if system == "ueg":
        cham = convert.ueg(
            *(np.asarray(getattr(jham, k)) for k in (
                "H1", "h1e_mod", "kpq_idx", "kpq_mask", "pmq_idx",
                "pmq_mask", "vqvec")),
            basis=np.asarray(jham.basis), qvecs=np.asarray(jham.qvecs),
            rs=jham.rs, ecut=jham.ecut, vol=jham.vol, kfac=jham.kfac,
            ecore=jham.ecore, nup=jham.nup, ndown=jham.ndown, device="cpu")
        for name, buf in ham.named_buffers():
            assert torch.equal(getattr(cham, name), buf), name
        extra = dict(ham=cham)
    else:
        extra = dict(U=jham.U)
    ct = convert.one_body_trial(
        *(np.asarray(getattr(jt, k)) for k in (
            "dmat", "dmat_inv", "left_table", "bin_full")),
        mu=jt.mu, beta=jt.beta, dt=jt.dt, num_slices=jt.num_slices,
        stack_size=jt.stack_size, nav=jt.nav, P_host=jt.P_host.arr,
        G_host=jt.G_host.arr, device="cpu")
    for name in ("dmat", "dmat_inv", "left_table", "bin_full"):
        assert rel(getattr(ct, name), getattr(t, name)) < 1e-12, name
    cp = convert.thermal_propagator(
        system, np.asarray(jp.inner.BH1), np.asarray(jp.inner.mf_shift),
        dt=jp.dt, mf_const_fac=jp.mf_const_fac, device="cpu", **extra)
    assert rel(cp.inner.BH1, p.inner.BH1) < 1e-12
    if system == "ueg":
        assert torch.equal(cp.inner.sp.qmap, p.inner.sp.qmap)
        assert torch.equal(cp.inner.sp.fac, p.inner.sp.fac)
    js = jtws.init_thermal_walkers(jt, nw)
    s = tws.init_thermal_walkers(ct, nw)
    k = jax.random.PRNGKey(2)
    xi = np.asarray(jax.random.normal(k, (nw, cp.nfields),
                                      dtype=jnp.float64))
    js = jax_propagate(jp)(jt, js, k, 0)
    s = cp.propagate(ct, s, 0, torch.from_numpy(xi.copy()))
    for name in ("G", "log_m0", "weight"):
        np.testing.assert_allclose(np_(getattr(s, name)),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


def test_prefix_cached_refold_matches_full_refold():
    """The per-slice G from the prefix carry equals a full
    re-stratification of the stack (the same fold sequence, cached; equal
    to rounding, not bit for bit: ROADMAP notes the refold is bit-exact
    only with exact matmuls)."""
    _, _, _, t, _, p, nw = setup("hubbard", stack_size=2)
    s = tws.init_thermal_walkers(t, nw)
    rng = np.random.default_rng(2)
    for ts in range(t.num_slices):
        s = p.propagate(t, s, ts, torch.from_numpy(
            rng.normal(size=(nw, p.nfields))))
        g, ld = tws.greens_function(s.stack)
        assert rel(s.G, g) < 1e-10
        d = np_(s.log_m0 - ld)
        assert np.abs(d.real).max() < 1e-10 * np.abs(np_(ld)).max()


@pytest.mark.parametrize("method", ["comb", "pair_branch"])
def test_pop_control_moves_stack_and_prefix(method):
    """Every per-walker field follows its parent, as in JAX's gather."""
    _, _, jt, t, jp, p, _ = setup("hubbard", stack_size=2, nw=6)
    nw = 6
    js = jtws.init_thermal_walkers(jt, nw)
    jprop = jax_propagate(jp)
    key = jax.random.PRNGKey(9)
    for ts in range(3):
        key, k = jax.random.split(key)
        js = jprop(jt, js, k, ts)
    js = js.replace(weight=jnp.asarray([0.05, 3.0, 0.5, 1.5, 0.02, 0.9]))
    s = jax_state_to_port(js)
    key, k = jax.random.split(key)
    shape = () if method == "comb" else (nw // 2,)
    u = np.asarray(jax.random.uniform(k, shape, dtype=jnp.float64))
    jnew = jax.jit(jpc.pop_control, static_argnums=(2, 3))(
        js, k, float(nw), method)
    new = pc.pop_control(s, float(nw), method,
                         uniforms=torch.from_numpy(u.reshape(-1).copy()))
    for name in ("stack", "right", "G", "log_m0", "unscaled_weight",
                 "phase", "hybrid_energy", "pq", "pd", "pt"):
        np.testing.assert_array_equal(np_(getattr(new, name)),
                                      np.asarray(getattr(jnew, name)),
                                      err_msg=name)
    # The new weights come from the total, a sum taken in another order.
    for name in ("weight", "total_weight"):
        np.testing.assert_allclose(np_(getattr(new, name)),
                                   np.asarray(getattr(jnew, name)),
                                   rtol=1e-14, err_msg=name)
    # The population really moved.
    assert not np.array_equal(np_(new.stack), np_(s.stack))
