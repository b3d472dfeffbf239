"""Port parity: the Generic local-energy variants (exact ERIs, PNO,
stochastic RI), the stochastic-RI one-body step and the 3M Taylor route,
against JAX.

float64, the same inputs on both sides (numpy from a seed; each package
builds its own system and trial from the same arrays):
  * the trial's variant tensors (eri_aa / eri_bb / eri_ab, Ghalf0, the e0
    terms, the PNO channels as their products U VT): 1e-10;
  * the three energies on random half-rotated G, the stochastic-RI one
    with JAX's probes rademacher(key, (X, S)) injected, with and without
    the control variate: 1e-10;
  * _apply_bh1_stochastic with JAX's sketch rademacher(key, (M, S)), and
    the port's "xla_3m" route (the complex series) against JAX's 3M
    series: 1e-10;
  * two blocks of qmc/afqmc.run_block against JAX's with JAX's draws
    (split(kprop) into the fields' key and the sketches' k1, k2; the
    energy's probes from kest) for exact_eri, pno, stochastic_ri (the
    energy, with and without the control variate, and the one-body step)
    and taylor_impl="xla_3m": rtol 1e-8;
  * the exact_eri and pno (thresh 1e-13) energies equal the fast path's;
    stochastic RI's mean over probe sets approaches the exact energy;
  * the device rule and no jax in a variant run.
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
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.propagation import continuous as jcont
from pauxy_tpu.propagation import generic as jgen
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
from pauxy_tpu_torch.propagation import continuous as tcont
from pauxy_tpu_torch.propagation import generic as tgen
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")

VARIANTS = {
    "exact_eri": dict(exact_eri=True),
    "pno": dict(pno=True, thresh_pno=1e-6),
    "sri": dict(stochastic_ri=True, nsamples=6),
    "sri_cv": dict(stochastic_ri=True, nsamples=6, control_variate=True),
}


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def systems(variant, nmo=7, nelec=(3, 2), seed=5):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    kw = VARIANTS.get(variant, {})
    jham = j_make_generic(nelec, h1e, chol, enuc, **kw)
    tham = make_generic(nelec, h1e, chol, enuc, **kw, **CPU)
    return jham, jtrial.rhf_identity_trial(jham), tham, \
        rhf_identity_trial(tham, **CPU)


def random_ghalf(tt, nw=4, seed=3):
    rng = np.random.default_rng(seed)
    m = tt.psia.shape[0]

    def g(n):
        eye = np.eye(n, m)
        return eye[None] + 0.3 * (rng.standard_normal((nw, n, m))
                                  + 1j * rng.standard_normal((nw, n, m)))

    return g(tt.psia.shape[1]), g(tt.psib.shape[1])


# ------------------------------------------------------------ precomputes --

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_precomputes_match_jax(variant):
    jham, jt, tham, tt = systems(variant)
    for key in ("eri_aa", "eri_bb", "eri_ab", "ghalf0a", "ghalf0b"):
        j, p = getattr(jt, key), getattr(tt, key)
        assert (j is None) == (p is None), key
        if j is not None:
            close(p.numpy(), j)
    assert (jt.e0_terms is None) == (tt.e0_terms is None)
    if jt.e0_terms is not None:
        close(np.array(tt.e0_terms), np.array(jt.e0_terms))
    for ch in ("pno_aa", "pno_bb", "pno_ab"):
        j, p = getattr(jt, ch), getattr(tt, ch)
        assert (j is None) == (p is None), ch
        if j is None:
            continue
        for k in range(3):
            close(p[k].numpy(), j[k])
        # The kept SVD factors, sign-free: the truncated pair matrices.
        close(torch.matmul(p[3], p[4]).numpy(),
              np.asarray(j[3]) @ np.asarray(j[4]))


# ------------------------------------------------------------- energies ---

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_energies_match_jax(variant):
    jham, jt, tham, tt = systems(variant)
    ga, gb = random_ghalf(tt)
    jga, jgb = jnp.asarray(ga), jnp.asarray(gb)
    if variant.startswith("sri"):
        key = jax.random.key(7)
        theta = jax.random.rademacher(key, (tham.nchol, tham.nsamples))
        got = tle.local_energy_generic_stochastic_ri(
            tt, t(ga), t(gb), tham.ecore, t(theta), tham.control_variate)
        want = jle.local_energy_generic_stochastic_ri(
            jt, jga, jgb, jham.ecore, key, jham.nsamples,
            jham.control_variate)
    else:
        fn = "local_energy_generic_" + variant
        got = getattr(tle, fn)(tt, t(ga), t(gb), tham.ecore)
        want = getattr(jle, fn)(jt, jga, jgb, jham.ecore)
    for a, b in zip(got, want):
        close(a.numpy(), b)


@pytest.mark.parametrize("variant", ["exact_eri", "pno"])
def test_exact_variants_equal_the_fast_energy(variant):
    """Exact ERIs, and PNO with a threshold below every dropped singular
    value, give the half-rotated Cholesky energy."""
    kw = dict(VARIANTS[variant])
    if variant == "pno":
        kw["thresh_pno"] = 1e-13
    h1e, chol, enuc, _ = generate_hamiltonian(7, (3, 2), seed=5)
    tham = make_generic((3, 2), h1e, chol, enuc, **kw, **CPU)
    tt = rhf_identity_trial(tham, **CPU)
    ga, gb = random_ghalf(tt, seed=11)
    fast = tle.local_energy_generic_opt(tt, t(ga), t(gb), tham.ecore)
    got = getattr(tle, "local_energy_generic_" + variant)(
        tt, t(ga), t(gb), tham.ecore)
    for a, b in zip(got, fast):
        close(a.numpy(), b.numpy(), 1e-9)


def test_stochastic_ri_mean_approaches_exact():
    h1e, chol, enuc, _ = generate_hamiltonian(7, (3, 2), seed=5)
    tham = make_generic((3, 2), h1e, chol, enuc, stochastic_ri=True,
                        nsamples=8, **CPU)
    tt = rhf_identity_trial(tham, **CPU)
    ga, gb = random_ghalf(tt, nw=2, seed=13)
    exact = tle.local_energy_generic_opt(tt, t(ga), t(gb), tham.ecore)[0]
    gen = torch.Generator().manual_seed(3)
    draws = torch.stack([tle.local_energy_generic_stochastic_ri(
        tt, t(ga), t(gb), tham.ecore,
        tle.rademacher((tham.nchol, 8), torch.float64, gen), False)[0]
        for _ in range(400)])
    se = draws.real.std(0) / 20.0
    assert (torch.abs(draws.real.mean(0) - exact.real) < 4 * se).all()


# ---------------------------------------------------------- propagation ---

def test_stochastic_half_step_and_3m_series_match_jax():
    _, _, tham, tt = systems("exact_eri")
    prop = tgen.make_generic_continuous(tham, tt, 0.01, **CPU)
    rng = np.random.default_rng(2)
    pa = rng.standard_normal((3, 7, 3)) + 1j * rng.standard_normal((3, 7, 3))
    pb = rng.standard_normal((3, 7, 2)) + 1j * rng.standard_normal((3, 7, 2))
    key = jax.random.key(9)
    theta = jax.random.rademacher(key, (7, 5), dtype=jnp.int32)
    ja, jb = jcont._apply_bh1_stochastic(jnp.asarray(prop.BH1.numpy()),
                                         jnp.asarray(pa), jnp.asarray(pb),
                                         key, 5)
    a, b = tcont._apply_bh1_stochastic(prop.BH1, t(pa), t(pb), t(theta))
    close(a.numpy(), ja)
    close(b.numpy(), jb)
    # A diagonal one-body propagator is applied exactly.
    diag = torch.diagonal(prop.BH1, dim1=-2, dim2=-1)
    a, _ = tcont._apply_bh1_stochastic(diag, t(pa), t(pb), t(theta))
    close(a.numpy(), diag[0][None, :, None].numpy() * pa)
    vhs = 0.1 * (rng.standard_normal((3, 7, 7))
                 + 1j * rng.standard_normal((3, 7, 7)))
    phi = rng.standard_normal((3, 7, 5)) + 1j * rng.standard_normal(
        (3, 7, 5))
    # The port's "xla_3m" route runs the complex series; it equals JAX's
    # 3M (three real products) series.
    got = tgen.taylor_series(t(vhs), t(phi), 6, "xla_3m")
    close(got.numpy(), jgen.apply_exponential_taylor_3m(
        jnp.asarray(vhs), jnp.asarray(phi), 6))


def jax_noise(block_key, nsteps, nw, nx, m, prop_sri, nsamples):
    """JAX's draws in its order: kprop, kpop, kest = split(key, 3); with
    the stochastic-RI step kprop, kbh = split(kprop), k1, k2 = split(kbh);
    the energy's probes rademacher(kest, (X, S))."""
    xi, pop, est = [], [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, kest = jax.random.split(key, 3)
        if prop_sri:
            kprop, kbh = jax.random.split(kprop)
            k1, k2 = jax.random.split(kbh)
            sketches = [t(jax.random.rademacher(k, (m, prop_sri),
                                                dtype=jnp.int32))
                        for k in (k1, k2)]
        fields = t(jax.random.normal(kprop, (nw, nx), dtype=jnp.float64))
        xi.append(tcont.RIDraws(fields, *sketches) if prop_sri else fields)
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
        if nsamples:
            est.append(np.asarray(jax.random.rademacher(kest,
                                                        (nx, nsamples))))
    return BlockNoise(xi if prop_sri else torch.stack(xi),
                      t(np.array(pop)), t(np.array(est)) if est else None)


BLOCK_CASES = {
    "exact_eri": ("exact_eri", {}),
    "pno": ("pno", {}),
    "sri": ("sri", {}),
    "sri_cv": ("sri_cv", {}),
    "sri_step": ("fast", {"stochastic_ri": True, "nsamples": 4}),
    "xla_3m": ("fast", {"taylor_impl": "xla_3m"}),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_blocks_match_jax(case):
    variant, popts = BLOCK_CASES[case]
    jham, jt, tham, tt = systems(variant, nmo=6, nelec=(2, 2), seed=13)
    nw, nsteps = 6, 5
    sri = popts.get("nsamples", 0) if popts.get("stochastic_ri") else 0
    impl = popts.get("taylor_impl", "xla")
    jprop = jcont.Continuous(
        inner=jgen.make_generic_continuous(jham, jt, 0.01, taylor_impl=impl),
        dt=0.01, stochastic_ri=bool(sri), ri_nsamples=sri or 20)
    tprop = tcont.Continuous(
        inner=tgen.make_generic_continuous(tham, tt, 0.01, taylor_impl=impl,
                                           **CPU),
        dt=0.01, stochastic_ri=bool(sri), ri_nsamples=sri or 20)
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    ts = init_walkers(tt, nw, total_weight=float(nw))
    opts = dict(nsteps=nsteps, nstblz=5, npop_control=1, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(31 + block)
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(nsteps * block, jnp.int32), free_projection=False,
            **opts)
        noise = jax_noise(key, nsteps, nw, tham.nchol, tham.nbasis, sri,
                          tham.nsamples)
        ts, tacc, _, _ = tafqmc.run_block(tham, tt, tprop, ts, None, eshift,
                                          nsteps * block, noise=noise,
                                          **opts)
        # Real parts: the hybrid energy's imaginary part carries JAX's
        # unwrapped CPU log-det branch.
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


# -------------------------------------------------------------- AFQMC ---

def test_variant_runs_device_rule_and_refusals():
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_generic((2, 2), h1e, chol, enuc, exact_eri=True)
    with pytest.raises(ValueError, match="nsamples"):
        make_generic((2, 2), h1e, chol, enuc, stochastic_ri=True, **CPU)
    with pytest.raises(ValueError, match="thresh_pno"):
        make_generic((2, 2), h1e, chol, enuc, pno=True, **CPU)
    ham = make_generic((2, 2), h1e, chol, enuc, stochastic_ri=True,
                       nsamples=4, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=2)
    rows = AFQMC(ham, trial, qmc, estimator_options={
        "mixed": {"energy_eval_freq": 1}}, device="cpu").run()
    assert np.isfinite(rows).all()
    # As in JAX, the local-energy update has no probes for the
    # stochastic-RI energy.
    with pytest.raises(ValueError, match="probes"):
        AFQMC(ham, trial, qmc, propagator_options={"hybrid": False},
              device="cpu").run()


def test_variant_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import make_generic,"
        " rhf_identity_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "from pauxy_tpu_torch.utils.testing import generate_hamiltonian\n"
        "kw = dict(device='cpu', dtype='double')\n"
        "h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=2)\n"
        "for v in ({'exact_eri': True}, {'pno': True, 'thresh_pno': 1e-8},"
        " {'stochastic_ri': True, 'nsamples': 3}):\n"
        "    ham = make_generic((2, 2), h1e, chol, enuc, **v, **kw)\n"
        "    AFQMC(ham, rhf_identity_trial(ham, **kw), QMCOpts(nwalkers=4,"
        " dt=0.01, nsteps=2, nblocks=1), propagator_options={"
        "'taylor_impl': 'xla_3m', 'stochastic_ri': True},"
        " device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
