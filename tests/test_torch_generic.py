"""Port parity for the Generic (Cholesky ab-initio) pieces against JAX.

float64 on the CPU, the same random Hamiltonians
(``pauxy_tpu.utils.testing.generate_hamiltonian``) and orbitals in both
packages, tolerance rtol 1e-10 (atol 1e-12) unless stated:
  * make_generic's H1, h1e_mod and chol (also from the flat [M^2, X] chol);
  * the trial's half-rotated rchol, rh1, exchange supermatrices and etrial
    for the RHF-identity, free-electron and a complex trial, stored real
    exactly where JAX stores them real; the host local energy;
  * make_generic_continuous's mf_shift and BH1, the force bias, and the
    Taylor exp(VHS)-apply of both taylor_impl routes;
  * local_energy_generic_opt on each of JAX's three exchange routes: the
    supermatrix; the exchange kernel's route for a real rchol (the cap
    lowered in both packages, so the trial has no supermatrix; JAX takes its
    einsum route on the CPU, the port the kernel's plain version); the
    einsum route for a complex rchol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation import generic as jgen
from pauxy_tpu.utils.testing import generate_hamiltonian, random_wavefunction
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                    rhf_identity_trial, trial_from_orbitals)
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.ops import exx_cuda, greens as tgreens
from pauxy_tpu_torch.ops.contract import cr_einsum, rc_einsum
from pauxy_tpu_torch.propagation import generic as tgen

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
TRIALS = ("rhf", "free", "complex")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=1e-12)


def systems(kind="rhf", nmo=8, nelec=(3, 2), seed=3):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    jham = j_make_generic(nelec, h1e, chol, enuc)
    tham = make_generic(nelec, h1e, chol, enuc, **CPU)
    if kind == "rhf":
        jt = jtrial.rhf_identity_trial(jham)
        tt = rhf_identity_trial(tham, **CPU)
    elif kind == "free":
        jt = jtrial.free_electron_trial(jham)
        tt = free_electron_trial(tham, **CPU)
    else:
        psi = random_wavefunction(nmo, nelec, seed=seed + 1)
        jt = jtrial.trial_from_orbitals(jham, psi)
        tt = trial_from_orbitals(tham, psi, **CPU)
    return jham, jt, tham, tt


def walkers(trial, w=5, seed=0):
    """Walkers [w, M, n] near the trial's orbitals, both spins."""
    rng = np.random.default_rng(seed)
    out = []
    for psi in (np.asarray(trial.psia), np.asarray(trial.psib)):
        noise = rng.normal(size=(w,) + psi.shape) + 1j * rng.normal(
            size=(w,) + psi.shape)
        out.append(psi[None] + 0.3 * noise)
    return out


def greens_pair(jt, tt, phia, phib):
    jg = (jgreens.greens_function(jnp.asarray(phia), jt.psia),
          jgreens.greens_function(jnp.asarray(phib), jt.psib))
    tg = (tgreens.greens_function(torch.from_numpy(phia), tt.psia, False),
          tgreens.greens_function(torch.from_numpy(phib), tt.psib, False))
    return jg, tg


def test_make_generic_matches_jax():
    h1e, chol, enuc, _ = generate_hamiltonian(7, (3, 2), seed=5)
    jham = j_make_generic((3, 2), h1e, chol, enuc)
    for c in (chol, chol.reshape(49, -1)):
        tham = make_generic((3, 2), h1e, c, enuc, **CPU)
        for key in ("H1", "h1e_mod", "chol"):
            close(getattr(tham, key).numpy(), getattr(jham, key))
        assert tham.chol.dtype == torch.float64
        assert (tham.nbasis, tham.nchol, tham.nfields) == (
            jham.nbasis, jham.nchol, jham.nfields)
        assert (tham.ecore, tham.nup, tham.ndown) == (jham.ecore, 3, 2)
    # The energy variants are ported: their flags are JAX's.
    for kw in (dict(exact_eri=True), dict(pno=True, thresh_pno=1e-8),
               dict(stochastic_ri=True, nsamples=4, control_variate=True)):
        jv = j_make_generic((3, 2), h1e, chol, enuc, **kw)
        tv = make_generic((3, 2), h1e, chol, enuc, **kw, **CPU)
        for key in ("exact_eri", "stochastic_ri", "nsamples",
                    "control_variate", "pno", "thresh_pno"):
            assert getattr(tv, key) == getattr(jv, key)


@pytest.mark.parametrize("kind", TRIALS)
def test_trial_precomputes_match_jax(kind):
    jham, jt, tham, tt = systems(kind)
    for key in ("psia", "psib", "rchola", "rcholb", "rh1a", "rh1b",
                "exx_supera", "exx_superb"):
        j, t = getattr(jt, key), getattr(tt, key)
        assert (j is None) == (t is None), key
        if j is not None:
            assert t.is_complex() == np.iscomplexobj(j), key
            close(t.numpy(), j)
    assert tt.etrial == pytest.approx(jt.etrial, rel=1e-10)
    close(tt.G_host, np.asarray(jt.G_host.arr))
    g = np.asarray(jt.G_host.arr)
    for a, b in zip(tle.local_energy_G_host(tham, g),
                    jle.local_energy_G_host(jham, g)):
        close(a, b)


@pytest.mark.parametrize("kind", TRIALS)
def test_supermatrix_cap_matches_jax(kind, monkeypatch):
    """Over the cap (lowered here) neither package builds a supermatrix."""
    monkeypatch.setattr(jtrial, "EXX_SUPER_MAX_ELEMS", 100)
    monkeypatch.setattr(ttrial, "EXX_SUPER_MAX_ELEMS", 100)
    _, jt, _, tt = systems(kind)
    assert jt.exx_supera is None and tt.exx_supera is None
    assert jt.exx_superb is None and tt.exx_superb is None


@pytest.mark.parametrize("kind", TRIALS)
def test_propagator_setup_and_force_bias_match_jax(kind):
    jham, jt, tham, tt = systems(kind)
    jprop = jgen.make_generic_continuous(jham, jt, 0.01)
    tprop = tgen.make_generic_continuous(tham, tt, 0.01, **CPU)
    close(tprop.mf_shift.numpy(), jprop.mf_shift)
    close(tprop.BH1.numpy(), jprop.BH1)
    close(tprop.chol.numpy(), jprop.chol)
    assert tprop.taylor_impl == "xla" and tprop.exp_order == 6
    phia, phib = walkers(jt, w=6, seed=1)
    (jga, jgb), (tga, tgb) = greens_pair(jt, tt, phia, phib)
    close(tprop.force_bias(tt, tga, tgb).numpy(),
          jprop.force_bias(jt, jga, jgb))
    x = np.random.default_rng(2).normal(size=(3, jham.nchol)) + 0.5j
    close(tprop.bp_dagger_fields(torch.from_numpy(x)).numpy(),
          jprop.bp_dagger_fields(jnp.asarray(x)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_apply_vhs_matches_jax(impl):
    jham, jt, tham, tt = systems("complex")
    jprop = jgen.make_generic_continuous(jham, jt, 0.02, taylor_impl="xla")
    tprop = tgen.make_generic_continuous(tham, tt, 0.02, taylor_impl=impl,
                                         **CPU)
    phia, phib = walkers(jt, w=4, seed=3)
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(4, jham.nchol)) + 0.3j * rng.normal(
        size=(4, jham.nchol))
    ja, jb = jprop.apply_vhs(jnp.asarray(phia), jnp.asarray(phib),
                             jnp.asarray(xs))
    ta, tb = tprop.apply_vhs(torch.from_numpy(phia), torch.from_numpy(phib),
                             torch.from_numpy(xs))
    close(ta.numpy(), ja)
    close(tb.numpy(), jb)


def test_apply_vhs_bf16_tier_matches_jax_pallas_interpret():
    """taylor_impl="pallas_bf16" on a CPU tensor takes the bf16 plain
    series: within 1e-3 of JAX's Pallas bf16 branch (interpret mode) on
    the same VHS, and within JAX's 5e-3 of the float64 series."""
    from pauxy_tpu.ops.taylor_pallas import apply_taylor_pallas

    jham, jt, tham, tt = systems("complex")
    jprop = jgen.make_generic_continuous(jham, jt, 0.02, taylor_impl="xla")
    tprop = tgen.make_generic_continuous(tham, tt, 0.02,
                                         taylor_impl="pallas_bf16", **CPU)
    phia, phib = walkers(jt, w=4, seed=5)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(4, jham.nchol)) + 0.3j * rng.normal(
        size=(4, jham.nchol))
    ta, tb = tprop.apply_vhs(torch.from_numpy(phia), torch.from_numpy(phib),
                             torch.from_numpy(xs))
    got = np.concatenate([ta.numpy(), tb.numpy()], -1)
    vhs = np.einsum("pqx,wx->wpq", np.asarray(jham.chol),
                    1j * 0.02 ** 0.5 * xs)
    ref = np.asarray(apply_taylor_pallas(
        jnp.asarray(vhs), jnp.asarray(np.concatenate([phia, phib], -1)), 6,
        lowp=True, interpret=True))
    ja, jb = jprop.apply_vhs(jnp.asarray(phia), jnp.asarray(phib),
                             jnp.asarray(xs))
    exact = np.concatenate([np.asarray(ja), np.asarray(jb)], -1)
    scale = np.abs(exact).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale
    assert np.abs(got - exact).max() <= 5e-3 * scale


@pytest.mark.parametrize("w,m,n", [(1, 6, 3), (5, 9, 7), (3, 16, 5)])
def test_apply_exponential_taylor_matches_jax(w, m, n):
    rng = np.random.default_rng(w + m + n)
    vhs = 0.2 * (rng.normal(size=(w, m, m)) + 1j * rng.normal(size=(w, m, m)))
    phi = rng.normal(size=(w, m, n)) + 1j * rng.normal(size=(w, m, n))
    ref = jgen.apply_exponential_taylor(jnp.asarray(vhs), jnp.asarray(phi))
    out = tgen.apply_exponential_taylor(torch.from_numpy(vhs),
                                        torch.from_numpy(phi))
    close(out.numpy(), ref)


@pytest.mark.parametrize("route", ["supermatrix", "kernel", "einsum"])
def test_local_energy_generic_opt_matches_jax(route, monkeypatch):
    if route != "supermatrix":
        monkeypatch.setattr(jtrial, "EXX_SUPER_MAX_ELEMS", 100)
        monkeypatch.setattr(ttrial, "EXX_SUPER_MAX_ELEMS", 100)
    kind = "complex" if route == "einsum" else "rhf"
    jham, jt, tham, tt = systems(kind, nmo=9, nelec=(4, 3), seed=11)
    assert (tt.exx_supera is None) == (route != "supermatrix")
    assert tt.rchola.is_complex() == (route == "einsum")
    phia, phib = walkers(jt, w=7, seed=5)
    (jga, jgb), (tga, tgb) = greens_pair(jt, tt, phia, phib)
    before = exx_cuda.launches
    ej = jle.local_energy_generic_opt(jt, jga.Ghalf, jgb.Ghalf, jham.ecore)
    et = tle.local_energy_generic_opt(tt, tga.Ghalf, tgb.Ghalf, tham.ecore)
    assert exx_cuda.launches == before        # CPU tensors: plain versions
    for a, b in zip(et, ej):
        close(a.numpy(), b)
    # Each walker's energy equals the host kernel on its full G.
    g = np.stack([np.asarray(jga.G[0]), np.asarray(jgb.G[0])])
    close(et[0][0].item(), tle.local_energy_G_host(tham, g)[0], 1e-9)


@pytest.mark.parametrize("route", ["kernel", "einsum"])
def test_exx_routes_chunk_like_jax(route):
    """The Cholesky-axis chunking of the einsum route (JAX's lax.scan)
    gives the single-einsum answer."""
    rng = np.random.default_rng(6)
    rc = rng.normal(size=(13, 4, 10))
    if route == "einsum":
        rc = rc + 1j * rng.normal(size=rc.shape)
    gh = rng.normal(size=(6, 4, 10)) + 1j * rng.normal(size=(6, 4, 10))
    ref = jle._exx(jnp.asarray(rc), jnp.asarray(gh), max_elems=6 * 16 * 3)
    full = tle._exx(torch.from_numpy(rc), torch.from_numpy(gh))
    chunked = exx_cuda.exx_plain(torch.from_numpy(rc), torch.from_numpy(gh),
                                 max_elems=6 * 16 * 3)
    close(full.numpy(), ref)
    close(chunked.numpy(), ref)


def test_taylor_impl_values():
    _, _, tham, tt = systems("rhf", nmo=5, nelec=(2, 2))
    with pytest.raises(ValueError, match="'pallas'"):
        tgen.make_generic_continuous(tham, tt, 0.01,
                                     taylor_impl="pallas_interpret", **CPU)
    # "xla_3m" builds and runs the complex series, which equals JAX's 3M
    # series (test_torch_generic_variants.py).
    assert tgen.make_generic_continuous(
        tham, tt, 0.01, taylor_impl="xla_3m", **CPU).taylor_impl == "xla_3m"
    bf16 = tgen.make_generic_continuous(tham, tt, 0.01,
                                        taylor_impl="pallas_bf16", **CPU)
    assert bf16.taylor_impl == "pallas_bf16"
    with pytest.raises(ValueError):
        tgen.make_generic_continuous(tham, tt, 0.01, taylor_impl="fast",
                                     **CPU)
    prop = tgen.make_generic_continuous(tham, tt, 0.01, taylor_impl="pallas",
                                        **CPU)
    assert prop.taylor_impl == "pallas"


@pytest.mark.parametrize("wc,zc", [(False, True), (True, True),
                                   (True, False), (False, False)])
def test_cr_einsum_promotes_like_jax(wc, zc):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 3)) + (1j * rng.normal(size=(4, 3)) if wc else 0)
    z = rng.normal(size=(5, 3)) + (1j * rng.normal(size=(5, 3)) if zc else 0)
    ref = np.einsum("xm,wm->wx", w, z)
    tw = torch.from_numpy(w).to(torch.float32 if not wc else torch.complex64)
    tz = torch.from_numpy(z)
    close(cr_einsum("xm,wm->wx", torch.from_numpy(w), tz).numpy(), ref)
    close(rc_einsum("wm,xm->wx", tz, torch.from_numpy(w)).numpy(), ref)
    # Mixed precision promotes rather than raising.
    out = cr_einsum("xm,wm->wx", tw, tz)
    assert out.dtype == torch.promote_types(tw.dtype, tz.dtype)
    close(out.numpy(), ref, 1e-6)
