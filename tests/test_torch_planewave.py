"""Port parity: the zero-temperature UEG (plane waves) against JAX.

float64 on the CPU, the same seeded numpy inputs through both packages,
1e-10 relative to the largest reference entry:
  * ``make_ueg``'s FFT-cube maps (gmap, qmap, qmesh) exactly, and
    ``convert.ueg`` deriving them as ``make_ueg`` does;
  * the cube helpers ``fft3`` / ``ifft3`` / ``neg_perm``: the port's
    ``torch.fft`` against JAX's matmul DFT, which JAX takes on the CPU for
    every odd cube up to its cap (the two agree to ~1e-12 in float64);
  * ``fft_coulomb_terms``; ``_fft_spin_terms`` unchunked, chunked
    (pair_chunk < n) and with a per-walker bra; ``structure_factor_ueg``
    by the FFT and the dense route, element by element (the energy is
    invariant under q -> -q, S(k) is not); ``local_energy_ueg_half``;
  * ``PlaneWave``: BH1, both force-bias routes (FFT and gather), build_vhs,
    apply_vhs on each ``taylor_impl`` route, bp_dagger_fields;
  * the fused force bias (``ops/pw_force_bias_cuda``'s plain version, the
    CPU's cube route) against the torch.fft route of ``fft_coulomb_terms``
    and against JAX's ``fft_coulomb_terms`` / ``PlaneWave.force_bias``,
    for the identity trial, a dense random trial, unequal nup / ndown and
    an empty spin; the shape rule ``fits`` (cube edges, types, the basis's
    support, any n); the trial's cached transformed cubes equal fft3 of
    its cube and are rebuilt only for other orbitals; a cube the rule
    refuses takes the plain version (torch.fft);
  * two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
    with JAX's normals injected, rtol 1e-8 / atol 1e-10 on the
    accumulators, weights and walkers, for taylor_impl "xla" and "pallas"
    (the kernel's plain version on the CPU; JAX's XLA route is the float64
    reference), and with back propagation's structure factor;
  * back_prop.update with two_rdm="structure_factor" (FFT route with the
    per-walker bra, and the dense route of a system without cube maps);
    the BP S(k) contracts with v_q to the BP two-body energy;
  * AFQMC runs the UEG by default on the card (raises without one) and on
    the CPU when asked, and pulls in no jax.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import back_prop as jbp
from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.estimators import mixed as jmixed
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation import pw_fft as jpw
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.planewave import make_planewave as j_mpw
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import back_prop as tbp
from pauxy_tpu_torch.estimators import local_energy as tle
from pauxy_tpu_torch.estimators import mixed as tmixed
from pauxy_tpu_torch.models import make_ueg, rhf_identity_trial
from pauxy_tpu_torch.ops import greens as tgreens
from pauxy_tpu_torch.ops import pw_force_bias_cuda, taylor_cuda
from pauxy_tpu_torch.propagation import pw_fft as tpw
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.propagation.planewave import make_planewave
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")
UEG_FIELDS = ("H1", "h1e_mod", "kpq_idx", "kpq_mask", "pmq_idx", "pmq_mask",
              "vqvec")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, tol=1e-10):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def t(x):
    return torch.from_numpy(np.array(x))


def port_ueg(jham, maps=True):
    kw = {}
    if maps:
        kw = dict(gmap=np.asarray(jham.gmap), qmap=np.asarray(jham.qmap),
                  qmesh=jham.qmesh)
    return convert.ueg(*(np.asarray(getattr(jham, k)) for k in UEG_FIELDS),
                       basis=np.asarray(jham.basis),
                       qvecs=np.asarray(jham.qvecs), rs=jham.rs,
                       ecut=jham.ecut, vol=jham.vol, kfac=jham.kfac,
                       ecore=jham.ecore, nup=jham.nup, ndown=jham.ndown,
                       device="cpu", **kw)


def strip_maps(ham):
    """The system without its FFT-cube maps: the gather routes."""
    ham.gmap = ham.qmap = None
    ham.qmesh = None
    return ham


def port_trial(jt):
    return convert.trial(np.asarray(jt.psia), np.asarray(jt.psib),
                         jt.etrial, device="cpu")


def ueg_system(nup=7, ndown=7, ecut=1.0, rs=1.0):
    jham = j_make_ueg(nup=nup, ndown=ndown, rs=rs, ecut=ecut)
    jt = jtrial.rhf_identity_trial(jham)
    return jham, jt, port_ueg(jham), port_trial(jt)


def walkers(rng, nw, m, n, scale=0.2):
    """Random walkers near the identity trial's orbitals."""
    eye = np.eye(m)[:, :n]
    return eye[None] + scale * (rng.normal(size=(nw, m, n))
                                + 1j * rng.normal(size=(nw, m, n)))


def both_greens(jt, tt, phia, phib):
    jga = jgreens.greens_function(jnp.asarray(phia), jt.psia)
    jgb = jgreens.greens_function(jnp.asarray(phib), jt.psib)
    tga = tgreens.greens_function(t(phia), tt.psia)
    tgb = tgreens.greens_function(t(phib), tt.psib)
    return (jga, jgb), (tga, tgb)


# ---------------------------------------------------------------- maps ---

@pytest.mark.parametrize("ecut", [0.5, 1.0, 2.0])
def test_fft_maps_match_jax(ecut):
    jham = j_make_ueg(nup=2, ndown=2, rs=1.0, ecut=ecut)
    ham = make_ueg(2, 2, rs=1.0, ecut=ecut, **CPU)
    np.testing.assert_array_equal(np_(ham.gmap), np.asarray(jham.gmap))
    np.testing.assert_array_equal(np_(ham.qmap), np.asarray(jham.qmap))
    assert ham.qmesh == tuple(jham.qmesh)
    derived = port_ueg(jham, maps=False)
    for name, buf in ham.named_buffers():
        assert torch.equal(getattr(derived, name), buf), name
    assert derived.qmesh == ham.qmesh


@pytest.mark.parametrize("shape", [(3, 3, 3), (9, 9, 9), (5, 7, 9)])
def test_fft_helpers_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    ng = int(np.prod(shape))
    x = rng.normal(size=(2, 3, ng)) + 1j * rng.normal(size=(2, 3, ng))
    close(tpw.fft3(t(x), shape), jpw.fft3(jnp.asarray(x), shape))
    close(tpw.ifft3(t(x), shape), jpw.ifft3(jnp.asarray(x), shape))
    np.testing.assert_array_equal(np_(tpw.neg_perm(shape)),
                                  jpw.neg_perm(shape))
    idx = rng.permutation(ng)[:11]
    arr = rng.normal(size=(4, 11)) + 1j * rng.normal(size=(4, 11))
    close(tpw.to_cube(t(arr), t(idx), ng),
          jpw.to_cube(jnp.asarray(arr), jnp.asarray(idx), ng))


# ------------------------------------------------------------- energies ---

def test_fft_coulomb_terms_match_jax():
    jham, jt, ham, tt = ueg_system()
    rng = np.random.default_rng(3)
    gh = rng.normal(size=(4, 7, ham.nbasis)) + 1j * rng.normal(
        size=(4, 7, ham.nbasis))
    psi = np.linalg.qr(rng.normal(size=(ham.nbasis, 7))
                       + 1j * rng.normal(size=(ham.nbasis, 7)))[0]
    want = jle.fft_coulomb_terms(jnp.asarray(psi), jnp.asarray(gh),
                                 jham.gmap, jham.qmap, jham.qmesh)
    got = tle.fft_coulomb_terms(t(psi), t(gh), ham.gmap, ham.qmap,
                                ham.qmesh)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("case", ["unchunked", "chunked", "bra",
                                  "bra_chunked", "empty"])
def test_fft_spin_terms_match_jax(case):
    jham, jt, ham, tt = ueg_system()
    rng = np.random.default_rng(len(case))
    nw, m = 3, ham.nbasis
    n = 0 if case == "empty" else 7
    gh = rng.normal(size=(nw, n, m)) + 1j * rng.normal(size=(nw, n, m))
    shape = (nw, m, n) if case.startswith("bra") else (m, n)
    psi = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    chunk = 3 if "chunked" in case else 8
    want = jle._fft_spin_terms(jnp.asarray(psi), jnp.asarray(gh), jham.gmap,
                               jham.qmap, jham.qmesh, pair_chunk=chunk)
    got = tle._fft_spin_terms(t(psi), t(gh), ham.gmap, ham.qmap, ham.qmesh,
                              pair_chunk=chunk)
    for a, b in zip(got, want):
        if case == "empty":
            assert np.abs(np_(a)).max() == 0 and np.abs(np_(b)).max() == 0
        else:
            close(a, b)


@pytest.mark.parametrize("route", ["fft", "dense", "bra"])
def test_structure_factor_matches_jax(route):
    jham, jt, ham, tt = ueg_system()
    rng = np.random.default_rng(11)
    m, nw = ham.nbasis, 3
    phia, phib = walkers(rng, nw, m, 7), walkers(rng, nw, m, 7)
    (jga, jgb), (tga, tgb) = both_greens(jt, tt, phia, phib)
    if route == "fft":
        jf = ((jt.psia, jga.Ghalf), (jt.psib, jgb.Ghalf))
        tf = ((tt.psia, tga.Ghalf), (tt.psib, tgb.Ghalf))
    elif route == "dense":
        jf = ((jga.G, None), (jgb.G, None))
        tf = ((tga.G, None), (tgb.G, None))
    else:
        bra_a, bra_b = walkers(rng, nw, m, 7), walkers(rng, nw, m, 7)
        jf = ((jnp.asarray(bra_a),
               jbp.bp_half_greens_function(jnp.asarray(bra_a),
                                           jnp.asarray(phia))),
              (jnp.asarray(bra_b),
               jbp.bp_half_greens_function(jnp.asarray(bra_b),
                                           jnp.asarray(phib))))
        tf = ((t(bra_a), tbp.bp_half_greens_function(t(bra_a), t(phia))),
              (t(bra_b), tbp.bp_half_greens_function(t(bra_b), t(phib))))
    want = np.asarray(jle.structure_factor_ueg(jham, jf))
    got = np_(tle.structure_factor_ueg(ham, tf))
    assert got.shape == (nw, 2, 2, ham.nq)
    # Element by element, block by block: the q labelling matters here.
    for s1 in range(2):
        for s2 in range(2):
            close(got[:, s1, s2], want[:, s1, s2])


@pytest.mark.parametrize("nelec", [(7, 7), (3, 1)])
def test_local_energy_ueg_half_matches_jax(nelec):
    jham, jt, ham, tt = ueg_system(*nelec)
    rng = np.random.default_rng(sum(nelec))
    m = ham.nbasis
    phia = walkers(rng, 3, m, nelec[0])
    phib = walkers(rng, 3, m, nelec[1])
    (jga, jgb), (tga, tgb) = both_greens(jt, tt, phia, phib)
    want = jle.local_energy_ueg_half(jham, jt, jga.Ghalf, jgb.Ghalf)
    got = tle.local_energy_ueg_half(ham, tt, tga.Ghalf, tgb.Ghalf)
    for a, b in zip(got, want):
        close(a, b)
    # The gather kernels on the full G give the same energy.
    dense = tle.local_energy_ueg(ham, tga.G, tgb.G)
    for a, b in zip(got, dense):
        close(a, b, 1e-9)
    assert tmixed.energy_estimator(ham, tt)(tga, tgb)[0].equal(got[0])


# ---------------------------------------------------------- propagator ---

def port_planewave(jprop, ham, impl="xla"):
    return convert.planewave(np.asarray(jprop.BH1), ham=ham, dt=jprop.dt,
                             taylor_impl=impl, device="cpu")


def test_planewave_setup_and_force_bias_match_jax():
    jham, jt, ham, tt = ueg_system()
    jprop = j_mpw(jham, jt, 0.05, taylor_impl="xla")
    prop = make_planewave(ham, tt, 0.05, taylor_impl="xla", **CPU)
    close(prop.BH1, jprop.BH1, 1e-12)
    assert prop.BH1.shape == (2, ham.nbasis) and prop.qmesh == jham.qmesh
    conv = port_planewave(jprop, ham)
    assert torch.equal(conv.sp.qmap, prop.sp.qmap)
    assert torch.equal(conv.BH1, prop.BH1)
    rng = np.random.default_rng(5)
    m = ham.nbasis
    phia, phib = walkers(rng, 4, m, 7), walkers(rng, 4, m, 7)
    (jga, jgb), (tga, tgb) = both_greens(jt, tt, phia, phib)
    want = np.asarray(jprop.force_bias(jt, jga, jgb))
    close(prop.force_bias(tt, tga, tgb), want)
    # The gather route (no cube maps, full G) gives the same bias.
    jgather = dataclasses.replace(jprop, qmesh=None)
    gather = make_planewave(strip_maps(port_ueg(jham)), tt, 0.05, **CPU)
    assert gather.uses_full_g and not prop.uses_full_g
    close(gather.force_bias(tt, tga, tgb), want)
    close(np.asarray(jgather.force_bias(jt, jga, jgb)), want)


# ---------------------------------------------------- fused force bias ---

FB_SPINS = {"identity": (7, 7), "dense": (7, 7), "unequal": (5, 2),
            "empty": (3, 0)}


def orbitals(rng, m, n):
    """Orthonormal random complex orbitals [m, n] (n may be 0)."""
    if n == 0:
        return np.zeros((m, 0), dtype=complex)
    return np.linalg.qr(rng.normal(size=(m, n))
                        + 1j * rng.normal(size=(m, n)))[0]


def half_greens(rng, nw, n, m):
    """A walker-like half-rotated G [w, n, M]: the identity's rows plus
    noise."""
    gh = 0.3 * (rng.normal(size=(nw, n, m)) + 1j * rng.normal(size=(nw, n, m)))
    gh[:, :, :n] += np.eye(n)
    return gh


@pytest.mark.parametrize("case", list(FB_SPINS))
def test_fused_force_bias_matches_fft_route_and_jax(case):
    nup, ndown = FB_SPINS[case]
    jham = j_make_ueg(nup=nup, ndown=ndown, rs=1.0, ecut=1.0)
    m = jham.nbasis
    rng = np.random.default_rng(17)
    if case == "identity":
        jt = jtrial.rhf_identity_trial(jham)
    else:
        jt = jtrial.trial_from_orbitals(jham, np.concatenate(
            [orbitals(rng, m, nup), orbitals(rng, m, ndown)], axis=1))
    ham, tt = port_ueg(jham), port_trial(jt)
    gha, ghb = half_greens(rng, 4, nup, m), half_greens(rng, 4, ndown, m)
    jprop = j_mpw(jham, jt, 0.05, taylor_impl="xla")
    prop = make_planewave(ham, tt, 0.05, **CPU)
    assert pw_force_bias_cuda.fits(prop.fb_tables, torch.complex128)
    got = prop.force_bias(tt, types.SimpleNamespace(Ghalf=t(gha)),
                          types.SimpleNamespace(Ghalf=t(ghb)))
    # The torch.fft route it replaces on the card, spin by spin.
    terms = [tle.fft_coulomb_terms(psi, t(gh), ham.gmap, ham.qmap,
                                   ham.qmesh)
             for psi, gh in ((tt.psia, gha), (tt.psib, ghb)) if gh.shape[1]]
    t1 = prop.sp.qfac * sum(k for k, _ in terms)
    t2 = prop.sp.qfac * sum(p for _, p in terms)
    route = -prop.sqrt_dt * torch.cat([1j * (t1 + t2), -(t1 - t2)], -1)
    close(got, route)
    want = jprop.force_bias(jt, types.SimpleNamespace(Ghalf=jnp.asarray(gha),
                                                      G=None),
                            types.SimpleNamespace(Ghalf=jnp.asarray(ghb),
                                                  G=None))
    close(got, np.asarray(want))
    jterms = [jle.fft_coulomb_terms(psi, jnp.asarray(gh), jham.gmap,
                                    jham.qmap, jham.qmesh)
              for psi, gh in ((jt.psia, gha), (jt.psib, ghb)) if gh.shape[1]]
    close(sum(k for k, _ in terms), np.asarray(sum(k for k, _ in jterms)))
    close(sum(p for _, p in terms), np.asarray(sum(p for _, p in jterms)))


def fb_tables(ecut, qmesh=None, dtype=torch.float64):
    """The kernel's tables for the basis of ``ecut`` on its (4 nmax + 1)
    cube (or ``qmesh``), a few q vectors, without building a system."""
    from pauxy_tpu_torch.models.ueg import fft_maps, plane_wave_basis
    _, basis, nmax = plane_wave_basis(ecut)
    qvecs = np.array([[1, 0, 0], [0, -1, 0], [1, 1, 2]])
    gmap, qmap, mesh = fft_maps(basis, qvecs, nmax)
    if qmesh is not None:
        n = np.array(qmesh)
        w = np.mod(basis, n)
        gmap = (w[:, 0] * n[1] + w[:, 1]) * n[2] + w[:, 2]
        mesh = tuple(qmesh)
    return pw_force_bias_cuda.make_tables(
        torch.from_numpy(gmap), torch.from_numpy(qmap), mesh,
        torch.ones(3, dtype=dtype), 0.1)


def test_force_bias_shape_rule():
    """The kernel takes the UEG's (4 nmax + 1)^3 cubes whose working set
    fits a block: up to 25^3 in complex64, 21^3 in complex128; not a
    cube of another edge or shape, a basis past the support box, or a
    real type. The number of electrons a spin does not enter."""
    c64, c128 = torch.complex64, torch.complex128
    want = {0.5: (5, True, True), 2.0: (9, True, True),
            4.5: (13, True, True), 8.0: (17, True, True),
            12.5: (21, True, True), 18.0: (25, True, False),
            24.5: (29, False, False)}
    for ecut, (edge, f64, f128) in want.items():
        tab = fb_tables(ecut)
        assert tab.qmesh == (edge,) * 3 and tab.box is not None
        assert pw_force_bias_cuda.fits(tab, c64) == f64, ecut
        assert pw_force_bias_cuda.fits(tab, c128) == f128, ecut
        assert not pw_force_bias_cuda.fits(tab, torch.float64)
        assert (pw_force_bias_cuda.smem_bytes(edge, c128)
                <= 232448) == f128
    # ecut 1: |n| <= 1 on a 9-cube, inside the support |n| <= 2.
    assert pw_force_bias_cuda.fits(fb_tables(1.0), c64)
    # Another edge, or a box, or a basis past the support: no kernel.
    assert not pw_force_bias_cuda.fits(fb_tables(2.0, (11, 11, 11)), c64)
    assert not pw_force_bias_cuda.fits(fb_tables(2.0, (9, 9, 13)), c64)
    assert not pw_force_bias_cuda.fits(fb_tables(8.0, (13, 13, 13)), c64)
    # Any n, 0 included, takes the same route: the plain version runs.
    tab = fb_tables(2.0)
    rng = np.random.default_rng(2)
    for na, nb in ((7, 7), (1, 0), (0, 3), (0, 0)):
        m = tab.gmap.shape[0]
        ct_f = pw_force_bias_cuda.trial_cubes(
            t(orbitals(rng, m, na)), t(orbitals(rng, m, nb)), tab.gmap,
            tab.qmesh)
        out = pw_force_bias_cuda.force_bias(
            ct_f, t(half_greens(rng, 2, na, m)),
            t(half_greens(rng, 2, nb, m)), tab)
        assert out.shape == (2, 6) and bool(torch.isfinite(out).all())
        assert bool((out == 0).all()) == (na + nb == 0)


def test_trial_cubes_are_cached_fft3_of_the_trial():
    jham, jt, ham, tt = ueg_system(5, 2)
    prop = make_planewave(ham, tt, 0.05, **CPU)
    ng = int(np.prod(ham.qmesh))
    cubes = prop.trial_cubes(tt)
    for rows, psi in ((cubes[:5], tt.psia), (cubes[5:], tt.psib)):
        want = tpw.fft3(tpw.to_cube(psi.conj().T, ham.gmap, ng), ham.qmesh)
        assert torch.equal(rows, want)
    assert prop.trial_cubes(tt) is cubes
    # Other orbitals, or the same tensors changed in place: rebuilt.
    other = port_trial(jtrial.trial_from_orbitals(jham, np.concatenate(
        [orbitals(np.random.default_rng(4), ham.nbasis, n) for n in (5, 2)],
        axis=1)))
    assert not torch.equal(prop.trial_cubes(other), cubes)
    again = prop.trial_cubes(tt)
    assert torch.equal(again, cubes)
    tt.psia.mul_(-1)
    assert torch.equal(prop.trial_cubes(tt)[:5], -cubes[:5])
    tt.psia.mul_(-1)


def test_cube_past_the_kernel_takes_the_fft_route(monkeypatch):
    """A cube ``fits`` refuses runs the plain version (torch.fft), with
    the same force bias, and the kernel's wrapper is not called."""
    jham, jt, ham, tt = ueg_system(5, 2)
    prop = make_planewave(ham, tt, 0.05, **CPU)
    rng = np.random.default_rng(8)
    ga = types.SimpleNamespace(Ghalf=t(half_greens(rng, 3, 5, ham.nbasis)))
    gb = types.SimpleNamespace(Ghalf=t(half_greens(rng, 3, 2, ham.nbasis)))
    fused = prop.force_bias(tt, ga, gb)

    def refuse(*args):
        raise AssertionError("the fused force bias ran past the rule")

    plain, calls = pw_force_bias_cuda.force_bias_plain, []

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(pw_force_bias_cuda, "fits", lambda tab, dt: False)
    monkeypatch.setattr(pw_force_bias_cuda, "force_bias", refuse)
    monkeypatch.setattr(pw_force_bias_cuda, "force_bias_plain", counted)
    close(prop.force_bias(tt, ga, gb), fused, 1e-12)
    assert calls == [1]


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_bf16"])
def test_planewave_vhs_matches_jax(impl, monkeypatch):
    jham, jt, ham, tt = ueg_system()
    jprop = j_mpw(jham, jt, 0.05, taylor_impl="xla")
    prop = port_planewave(jprop, ham, impl)
    rng = np.random.default_rng(9)
    m, nw = ham.nbasis, 3
    x = rng.normal(size=(nw, ham.nfields)) + 0.1j * rng.normal(
        size=(nw, ham.nfields))
    close(prop.build_vhs(t(x)), jprop.build_vhs(jnp.asarray(x)))
    close(prop.bp_dagger_fields(t(x)), jprop.bp_dagger_fields(
        jnp.asarray(x)))
    phia, phib = walkers(rng, nw, m, 7), walkers(rng, nw, m, 7)
    calls = []
    fn = taylor_cuda.apply_taylor
    monkeypatch.setattr(taylor_cuda, "apply_taylor", lambda *a, **k: (
        calls.append(k.get("lowp", False)), fn(*a, **k))[1])
    a, b = prop.apply_vhs(t(phia), t(phib), t(x))
    ja, jb = jprop.apply_vhs(jnp.asarray(phia), jnp.asarray(phib),
                             jnp.asarray(x))
    assert calls == {"xla": [], "pallas": [False],
                     "pallas_bf16": [True]}[impl]
    if impl == "pallas_bf16":
        # The bf16 tier against JAX's Pallas bf16 branch (interpret mode,
        # float32 planes), and within JAX's own 5e-3 of the exact series.
        from pauxy_tpu.ops.taylor_pallas import apply_taylor_pallas
        vhs = jprop.build_vhs(jnp.asarray(x))
        ref = np.asarray(apply_taylor_pallas(
            vhs, jnp.concatenate([jnp.asarray(phia), jnp.asarray(phib)], -1),
            6, lowp=True, interpret=True))
        got = np.concatenate([np_(a), np_(b)], -1)
        close(got, ref, 1e-3)
        close(got, np.concatenate([np.asarray(ja), np.asarray(jb)], -1),
              5e-3)
        return
    close(a, ja)
    close(b, jb)


def test_taylor_impl_env_and_refusals(monkeypatch):
    _, _, ham, tt = ueg_system(2, 2, 0.5)
    monkeypatch.setenv("PAUXY_TPU_TAYLOR_UEG", "pallas_bf16")
    assert make_planewave(ham, tt, 0.01, **CPU).taylor_impl == "pallas_bf16"
    monkeypatch.delenv("PAUXY_TPU_TAYLOR_UEG")
    assert make_planewave(ham, tt, 0.01, **CPU).taylor_impl == "xla"
    with pytest.raises(ValueError, match="'pallas'"):
        make_planewave(ham, tt, 0.01, taylor_impl="pallas_interpret", **CPU)
    # "xla_3m" now builds, as in JAX (test_planewave_xla_3m_matches_jax).
    assert make_planewave(ham, tt, 0.01, taylor_impl="xla_3m",
                          **CPU).taylor_impl == "xla_3m"


def test_planewave_xla_3m_matches_jax(monkeypatch):
    """"xla_3m" runs the plain complex series, as JAX's make_planewave
    does for every tier not starting with "pallas"; no kernel is
    called."""
    jham, jt, ham, tt = ueg_system()
    jprop = j_mpw(jham, jt, 0.05, taylor_impl="xla_3m")
    prop = make_planewave(ham, tt, 0.05, taylor_impl="xla_3m", **CPU)
    assert jprop.taylor_impl == prop.taylor_impl == "xla_3m"
    close(prop.BH1, jprop.BH1)
    rng = np.random.default_rng(19)
    m, nw = ham.nbasis, 3
    x = rng.normal(size=(nw, ham.nfields)) + 0.1j * rng.normal(
        size=(nw, ham.nfields))
    phia, phib = walkers(rng, nw, m, 7), walkers(rng, nw, m, 7)
    calls = []
    fn = taylor_cuda.apply_taylor
    monkeypatch.setattr(taylor_cuda, "apply_taylor", lambda *a, **k: (
        calls.append(1), fn(*a, **k))[1])
    a, b = prop.apply_vhs(t(phia), t(phib), t(x))
    ja, jb = jprop.apply_vhs(jnp.asarray(phia), jnp.asarray(phib),
                             jnp.asarray(x))
    assert not calls
    close(a, ja)
    close(b, jb)


# ------------------------------------------------- blocks against JAX ---

def jax_noise(block_key, nsteps, nw, nf):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nf),
                                               dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (), dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(t(np.array(xi)), t(np.array(pop)))


def two_blocks(jham, jt, jinner, ham, tt, tinner, nw, dt, jextras=None,
               nsteps=5):
    """Two blocks of both run_blocks from the same walkers with JAX's
    draws; every accumulator, the weights and walkers at rtol 1e-8."""
    jextras = jextras or {}
    nhist = jextras.get("nbp", 0)
    jprop = JContinuous(inner=jinner, dt=dt)
    tprop = Continuous(inner=tinner, dt=dt)
    js = j_init_walkers(jt, nw, total_weight=float(nw),
                        nprop_tot=nhist or None,
                        nfields=jham.nfields if nhist else None)
    ts = init_walkers(tt, nw, total_weight=float(nw),
                      nprop_tot=nhist or None,
                      nfields=ham.nfields if nhist else None)
    opts = dict(nsteps=nsteps, nstblz=5, npop_control=1, pop_method="comb",
                target_weight=float(nw), energy_eval_freq=1)
    for block, eshift in enumerate((0.0, float(jt.etrial))):
        key = jax.random.key(41 + block)
        js, jacc, jbp_acc, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(nsteps * block, jnp.int32), free_projection=False,
            **opts, **jextras)
        ts, tacc, tbp_acc, _ = tafqmc.run_block(
            ham, tt, tprop, ts, None, eshift, nsteps * block,
            extras=tafqmc.Extras(**jextras),
            noise=jax_noise(key, nsteps, nw, jham.nfields), **opts)
        # Real parts: the hybrid energy's imaginary part carries JAX's
        # unwrapped CPU log-det branch.
        np.testing.assert_allclose(tacc.numpy()[0], np.asarray(jacc)[0],
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(tbp_acc.numpy(), np.asarray(jbp_acc),
                                   rtol=1e-8, atol=1e-10)
        for f in ("weight", "phia", "phib"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)
    return tbp_acc


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ueg_blocks_match_jax(impl, monkeypatch):
    jham, jt, ham, tt = ueg_system(3, 3, 1.0)
    jinner = j_mpw(jham, jt, 0.01, taylor_impl="xla")
    tinner = port_planewave(jinner, ham, impl)
    calls = []
    fn = taylor_cuda.apply_taylor
    monkeypatch.setattr(taylor_cuda, "apply_taylor", lambda *a, **k: (
        calls.append(1), fn(*a, **k))[1])
    before = taylor_cuda.launches
    two_blocks(jham, jt, jinner, ham, tt, tinner, 6, 0.01)
    assert bool(calls) == (impl == "pallas")
    assert taylor_cuda.launches == before


def test_ueg_bp_structure_factor_blocks_match_jax():
    jham, jt, ham, tt = ueg_system(3, 3, 1.0)
    jinner = j_mpw(jham, jt, 0.01, taylor_impl="xla")
    jextras = dict(nbp=4, bp_eval_energy=True, bp_two_rdm="structure_factor",
                   nprop_tot=4)
    bp = two_blocks(jham, jt, jinner, ham, tt, port_planewave(jinner, ham),
                    5, 0.01, jextras, nsteps=4)
    assert bp.shape[-1] == tbp.bp_acc_size(ham, "structure_factor", False)


@pytest.mark.parametrize("maps", [True, False])
def test_bp_structure_factor_update_matches_jax(maps):
    jham, jt, ham, tt = ueg_system(3, 3, 1.0)
    if not maps:
        jham = jham.replace(gmap=None, qmap=None, qmesh=None)
        ham = strip_maps(ham)
    jinner = j_mpw(jham, jt, 0.02, taylor_impl="xla")
    jprop = JContinuous(inner=jinner, dt=0.02)
    tprop = Continuous(inner=port_planewave(jinner, ham), dt=0.02)
    rng = np.random.default_rng(17)
    nw, nbp, m = 4, 3, ham.nbasis
    js = j_init_walkers(jt, nw, nprop_tot=nbp, nfields=jham.nfields)
    configs = 0.3 * rng.normal(size=(nw, nbp, jham.nfields)) + 0j
    old_a, old_b = walkers(rng, nw, m, 3), walkers(rng, nw, m, 3)
    js = js.replace(configs=jnp.asarray(configs),
                    phia_old=jnp.asarray(old_a), phib_old=jnp.asarray(old_b),
                    weight=jnp.asarray(rng.uniform(0.5, 1.5, nw)))
    ts = dataclasses.replace(
        init_walkers(tt, nw, nprop_tot=nbp, nfields=ham.nfields),
        configs=t(configs), phia_old=t(old_a), phib_old=t(old_b),
        weight=t(np.asarray(js.weight)))
    opts = dict(nstblz=2, restore_weights=None, discrete=False,
                calc_two_rdm="structure_factor")
    jacc = jbp.update(jham, jt, jprop, js,
                      jmixed.energy_estimator_G(jham, jt), **opts)
    tacc = tbp.update(ham, tt, tprop, ts, tmixed.energy_estimator_G(ham),
                      **opts)
    close(tacc, jacc)
    # The S(k) tail contracts with v_q to the BP two-body energy.
    a = np_(tacc)
    sk = a[4 + 2 * m * m:].reshape(2, 2, ham.nq)
    pe = np.sum(np_(ham.vqvec) * sk.sum(axis=(0, 1))) / (2 * ham.vol)
    assert abs(pe - a[2]) <= 1e-10 * abs(a[2])


# --------------------------------------------------------------- AFQMC ---

def test_afqmc_runs_the_ueg_with_bp_structure_factor(tmp_path):
    ham = make_ueg(2, 2, rs=1.0, ecut=0.5, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    af = AFQMC(ham, trial, QMCOpts(nwalkers=6, dt=0.01, nsteps=5, nblocks=2,
                                   nstblz=5, npop_control=1, rng_seed=3),
               estimator_options={
                   "mixed": {"energy_eval_freq": 1},
                   "back_propagation": {"tau_bp": 0.05,
                                        "two_rdm": "structure_factor"}},
               filename=str(tmp_path / "ueg.h5"), device="cpu")
    rows = af.run()
    assert rows.shape == (2, 11) and np.isfinite(rows).all()
    row = af.bp_reporter.rows[-1]
    sk = row["two_rdm_5"] / row["denominator_5"][0]
    pe = np.sum(np_(ham.vqvec) * sk.sum(axis=(0, 1))) / (2 * ham.vol)
    assert sk.shape == (2, 2, ham.nq)
    assert abs(pe - row["energies_5"][2]) < 1e-10


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ueg(2, 2, rs=1.0, ecut=0.5)
    ham = make_ueg(2, 2, rs=1.0, ecut=0.5, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.01, nsteps=1, nblocks=1))


def test_ueg_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import make_ueg, rhf_identity_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "ham = make_ueg(2, 2, rs=1.0, ecut=0.5, device='cpu', "
        "dtype='double')\n"
        "t = rhf_identity_trial(ham, device='cpu', dtype='double')\n"
        "AFQMC(ham, t, QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),"
        " propagator_options={'taylor_impl': 'pallas'},"
        " device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PAUXY_TPU_TAYLOR_UEG="pallas_bf16")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True)
