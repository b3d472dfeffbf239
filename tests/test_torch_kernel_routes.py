"""Routes by shape, kernel caps and tile plans of the port, on the CPU.

* Kernel A (ops/greens_cuda): ``max_n`` is the largest n whose walker
  (n x 2n complex values with the Green's function, n x n without) fits one
  block's shared memory; the route sends a CUDA tensor past it to the plain
  version before any launch.
* The Taylor kernel (ops/taylor_cuda): ``max_m`` from the kernel's shared
  memory layout, at least 257 in both types; the plan refuses cap + 1; the
  Generic propagator sends an M past the cap to the plain series.
* The exchange kernel (ops/exx_cuda): the tile plan stays within the
  thread and shared-memory budgets, and the tiled algorithm it describes
  (packed panels, index-block pairs weighted 2 off the diagonal, the
  partials' sum) gives exx_plain's result in float64 to 1e-12.
* ``matmul_precision``: on the CPU both drivers take every tier as a
  no-op, report "float32" and give the float32 run's rows bit for bit.
* The cap helpers are derived once: ``cpqr_cuda.max_m`` and
  ``taylor_cuda.max_m`` equal the largest m their layout formulas admit and
  a second call is a cache hit (``cache_info``), as are the Taylor and exx
  plans and kernel B's cap; kernel A's plan mirrors its launcher, and the
  cpqr route follows m.
* The Cholesky kernel's plan (ops/batchla_cuda.chol_plan): a group of the
  next power of two >= n lanes a matrix up to n = 32, one block a matrix
  above, the odd row stride where the block's matrices fit, every n up to
  the unchanged caps (170 complex64, 120 complex128) and none past them.
  The sweep kernel's plan (ops/sweep_cuda.plan): the next power of two
  >= max(na, nb) lanes a walker, up to 32 electrons in a spin.
"""

import types

import numpy as np
import pytest
import torch

from pauxy_tpu_torch.ops import (batchla_cuda, cpqr_cuda, cuda_build, exx_cuda,
                                 greens_cuda, sweep_cuda, taylor_cuda)

torch.set_num_threads(1)

C64, C128 = torch.complex64, torch.complex128
CPU = dict(device="cpu", dtype="double")


def cuda_like(shape, dtype):
    """Stands in for a CUDA tensor where only its device, type and shape
    are read (this machine may have no card)."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=torch.Size(shape))


@pytest.mark.parametrize("dtype,want_gh,cap", [
    (C128, True, 85), (C128, False, 120), (C64, True, 120),
    (C64, False, 170)])
def test_greens_max_n_from_the_layout(dtype, want_gh, cap):
    ncol = 2 if want_gh else 1
    per = lambda n: n * ncol * n * dtype.itemsize   # noqa: E731
    assert greens_cuda.max_n(dtype, want_gh) == cap
    assert per(cap) <= cuda_build.SMEM_MAX < per(cap + 1)
    assert greens_cuda.uses_kernel(cuda_like((2 * cap, cap, 8), dtype),
                                   want_gh)
    assert not greens_cuda.uses_kernel(
        cuda_like((2 * cap + 2, cap + 1, 8), dtype), want_gh)


def test_greens_route_on_the_cpu_is_the_plain_version(monkeypatch):
    """A CPU tensor past the cap takes the plain version; nothing reaches
    the kernel library."""
    monkeypatch.setattr(greens_cuda.cuda_build, "library", None)
    rng = np.random.default_rng(3)
    n, m, w = greens_cuda.max_n(C128) + 1, 2 * 86 + 4, 2
    psi = torch.from_numpy(rng.normal(size=(m, n)) + 0j)
    phi = (psi[:, :, None] + 0.3 * torch.from_numpy(
        rng.normal(size=(m, n, w)) + 0j)).contiguous()
    before = greens_cuda.launches
    ld, gh = greens_cuda.greens_lanes(psi, phi)
    ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi)
    assert greens_cuda.launches == before
    assert torch.equal(ld, ld_p) and torch.equal(gh, gh_p)
    assert not greens_cuda.uses_kernel(phi)


@pytest.mark.parametrize("dtype,cap", [(C64, 656), (C128, 556)])
def test_taylor_max_m_and_refusal_past_it(dtype, cap):
    tn = taylor_cuda.TILES[dtype][1]
    assert taylor_cuda.max_m(dtype) == cap >= 257
    assert taylor_cuda.smem_bytes(cap, tn, dtype) <= cuda_build.SMEM_MAX
    assert taylor_cuda.smem_bytes(cap + 1, tn, dtype) > cuda_build.SMEM_MAX
    assert taylor_cuda.plan(cap, 14, dtype) >= tn
    with pytest.raises(ValueError, match="largest the kernel takes"):
        taylor_cuda.plan(cap + 1, 14, dtype)
    assert taylor_cuda.fits(cap, dtype) and not taylor_cuda.fits(cap + 1,
                                                                 dtype)


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("m,ncol", [(16, 14), (128, 32), (228, 84),
                                    (257, 14), (257, 84)])
def test_taylor_plan_fits_the_budget(dtype, m, ncol):
    tm, tn, ks, ksp = taylor_cuda.TILES[dtype]
    cb = taylor_cuda.plan(m, ncol, dtype)
    assert cb % tn == 0
    assert taylor_cuda.threads(m, cb, dtype) <= taylor_cuda.MAX_THREADS[
        dtype]
    assert taylor_cuda.smem_bytes(m, cb, dtype) <= cuda_build.SMEM_MAX
    # The fewest parts: one part fewer would not fit.
    parts = -(-ncol // cb)
    if parts > 1:
        wider = cuda_build.round_up(-(-ncol // (parts - 1)), tn)
        assert (taylor_cuda.threads(m, wider, dtype)
                > taylor_cuda.MAX_THREADS[dtype]
                or taylor_cuda.smem_bytes(m, wider, dtype)
                > cuda_build.SMEM_MAX)
    if dtype == C64 and (m, ncol) == (228, 84):
        assert cb == 44       # two column halves of one walker, 20 warps
    if dtype == C64 and (m, ncol) == (128, 32):
        assert cb == 32       # the whole walker in one block


def test_generic_propagator_routes_past_the_taylor_cap(monkeypatch):
    """taylor_impl="pallas": M up to the cap goes to apply_taylor, M past it
    to the plain series, chosen by shape."""
    from pauxy_tpu_torch.propagation.generic import GenericContinuous
    calls = []
    real = taylor_cuda.apply_taylor

    def spy(vhs, phi, order=6):
        calls.append(vhs.shape[-1])
        return real(vhs, phi, order)

    monkeypatch.setattr(taylor_cuda, "apply_taylor", spy)
    rng = np.random.default_rng(5)
    for m in (12, taylor_cuda.max_m(C128) + 1):
        chol = torch.from_numpy(0.01 * rng.normal(size=(m, m, 1)))
        prop = GenericContinuous(torch.zeros(2, m, m, dtype=C128),
                                 torch.zeros(1, dtype=C128), chol, dt=0.01,
                                 taylor_impl="pallas")
        phia = torch.from_numpy(rng.normal(size=(1, m, 2)) + 0j)
        phib = torch.from_numpy(rng.normal(size=(1, m, 1)) + 0j)
        x = torch.ones(1, 1, dtype=C128)
        a, b = prop.apply_vhs(phia, phib, x)
        vhs = (1j * 0.1) * chol[..., 0].to(C128)[None]
        want = taylor_cuda.apply_taylor_plain(vhs, torch.cat([phia, phib],
                                                             -1))
        torch.testing.assert_close(torch.cat([a, b], -1), want, rtol=1e-12,
                                   atol=1e-12)
    assert calls == [12]


EXX_PLAN_SHAPES = [(30, 3, 12, 5), (512, 16, 128, 1024), (1024, 42, 228, 256),
                   (8, 60, 500, 256), (4, 130, 200, 256), (1023, 42, 228, 1)]


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("x,n,m,w", EXX_PLAN_SHAPES)
def test_exx_plan_fits_the_budget(dtype, x, n, m, w):
    tm, tn, ks, _, _ = exx_cuda.TILES[dtype]
    pl = exx_cuda.plan(x, n, m, w, dtype)
    assert pl.bsz <= exx_cuda.MAX_BLOCK and pl.bsz * pl.nb >= n
    assert pl.bsz * (pl.nb - 1) < n
    assert pl.rt % tm == 0 and pl.rt >= pl.xg * pl.bsz
    assert pl.ct % tn == 0 and pl.ct >= pl.wg * pl.bsz
    assert pl.kp % ks == 0 and m <= pl.kp < m + ks
    assert pl.threads <= exx_cuda.MAX_THREADS
    assert pl.smem <= cuda_build.SMEM_MAX
    assert pl.ng * pl.xg >= x and pl.nh * pl.wg >= w
    assert pl.apack == pl.ng * pl.nb * pl.kp * pl.rt
    assert pl.bpack == pl.nh * pl.nb * pl.kp * pl.ct
    assert pl.part == pl.ng * pl.nb * (pl.nb + 1) // 2 * w
    if dtype == C64 and (x, n, m) == (1024, 42, 228):
        assert (pl.bsz, pl.nb, pl.xg, pl.wg, pl.rt, pl.ct, pl.kp) == (
            42, 1, 3, 3, 128, 128, 240)
        assert pl.smem == 132240 and pl.threads == 512
    if dtype == C64 and (x, n, m) == (512, 16, 128):
        # 8 warps, two on each scheduler.
        assert (pl.xg, pl.wg, pl.rt, pl.ct, pl.threads) == (8, 4, 128, 64,
                                                            256)


def tiled_exx(rchol, ghalf, pl):
    """The algorithm of csrc/exx.cu in numpy: packed panels, T[I, J] and
    T[J, I] of each index-block pair, the transpose-trace of each (x, w)
    block, off-diagonal pairs weighted 2, partials summed in order."""
    nx, n, m = rchol.shape
    w = ghalf.shape[0]

    def pack(src, count, grp, rtot, ngrp):
        out = np.zeros((ngrp, pl.nb, pl.kp, rtot), dtype=src.dtype)
        for gi in range(ngrp):
            for blk in range(pl.nb):
                for lo in range(grp):
                    idx = gi * grp + lo
                    i1 = min(n, (blk + 1) * pl.bsz)
                    if idx >= count or blk * pl.bsz >= n:
                        continue
                    rows = src[idx, blk * pl.bsz:i1, :]      # [<=B, M]
                    out[gi, blk, :m, lo * pl.bsz:lo * pl.bsz + len(rows)] = \
                        rows.T
        return out

    a = pack(rchol, nx, pl.xg, pl.rt, pl.ng)
    b = pack(ghalf, w, pl.wg, pl.ct, pl.nh)
    pairs = [(i, j) for i in range(pl.nb) for j in range(i, pl.nb)]
    part = np.zeros((pl.ng, len(pairs), w), dtype=np.complex128)
    bs = pl.bsz
    for g in range(pl.ng):
        for h in range(pl.nh):
            for p, (bi, bj) in enumerate(pairs):
                t1 = a[g, bi].T @ b[h, bj]
                t2 = a[g, bj].T @ b[h, bi] if bi != bj else t1
                for wl in range(pl.wg):
                    wi = h * pl.wg + wl
                    if wi >= w:
                        continue
                    s = 0
                    for xl in range(pl.xg):
                        blk1 = t1[xl * bs:(xl + 1) * bs, wl * bs:(wl + 1) * bs]
                        blk2 = t2[xl * bs:(xl + 1) * bs, wl * bs:(wl + 1) * bs]
                        s += np.sum(blk1 * blk2.T)
                    part[g, p, wi] = s * (1 if bi == bj else 2)
    return part.reshape(-1, w).sum(0)


@pytest.mark.parametrize("x,n,m,w", [(30, 3, 12, 5), (7, 60, 20, 3),
                                     (4, 130, 16, 2), (9, 16, 40, 11)])
def test_exx_tiled_algorithm_matches_plain(x, n, m, w):
    rng = np.random.default_rng(x + n + m + w)
    rchol = rng.normal(size=(x, n, m)) / m ** 0.5
    ghalf = rng.normal(size=(w, n, m)) + 1j * rng.normal(size=(w, n, m))
    pl = exx_cuda.plan(x, n, m, w, C128)
    got = tiled_exx(rchol, ghalf, pl)
    want = exx_cuda.exx_plain(torch.from_numpy(rchol),
                              torch.from_numpy(ghalf)).numpy()
    scale = exx_cuda.exx_magnitude(torch.from_numpy(rchol),
                                   torch.from_numpy(ghalf)).numpy()
    assert np.all(np.abs(got - want) <= 1e-12 * scale)


def _hubbard_afqmc_rows(policy):
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    af = AFQMC(ham, free_electron_trial(ham, **CPU),
               QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1, rng_seed=3),
               propagator_options={"matmul_precision": policy},
               device="cpu")
    return af.matmul_precision, af.run()


@pytest.mark.parametrize("policy", ["bfloat16", "bfloat16_3x"])
def test_afqmc_refuses_lower_matmul_precision(policy):
    # The name stays; the refusal is gone. On the CPU a lower tier changes
    # nothing (as on JAX's CPU backend): the driver reports "float32" and
    # its rows are the float32 run's, bit for bit.
    tier, rows = _hubbard_afqmc_rows(policy)
    ref_tier, ref = _hubbard_afqmc_rows("float32")
    assert tier == ref_tier == "float32"
    assert np.isfinite(rows.real).all()
    np.testing.assert_array_equal(rows[:, :-1], ref[:, :-1])


@pytest.mark.parametrize("policy", [None, "float32"])
def test_afqmc_runs_with_float32_precision(policy):
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    af = AFQMC(ham, free_electron_trial(ham, **CPU),
               QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1, rng_seed=3),
               propagator_options={"matmul_precision": policy},
               device="cpu")
    rows = af.run()
    assert af.matmul_precision == "float32"
    assert np.isfinite(rows.real).all()


def _thermal_rows(policy):
    from pauxy_tpu_torch.models import make_hubbard
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    af = ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1,
                                          nblocks=1, beta=0.5, rng_seed=3),
                      propagator_options={"matmul_precision": policy},
                      device="cpu")
    return af.matmul_precision, af.run()


@pytest.mark.parametrize("policy", ["bfloat16", "bfloat16_3x"])
def test_thermal_afqmc_refuses_lower_matmul_precision(policy):
    # As the zero-temperature case: on the CPU the tier is a no-op.
    tier, rows = _thermal_rows(policy)
    ref_tier, ref = _thermal_rows("float32")
    assert tier == ref_tier == "float32"
    assert np.isfinite(rows.real).all()
    np.testing.assert_array_equal(rows[:, :-1], ref[:, :-1])


@pytest.mark.parametrize("policy", [None, "float32"])
def test_thermal_afqmc_runs_with_float32_precision(policy):
    from pauxy_tpu_torch.models import make_hubbard
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    af = ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1,
                                          nblocks=1, beta=0.5),
                      propagator_options={"matmul_precision": policy},
                      device="cpu")
    rows = af.run()
    assert af.matmul_precision == "float32"
    assert np.isfinite(rows.real).all()


def _largest(fits, start=1):
    """The largest m >= start with fits(m), walking up from start."""
    m = start
    while fits(m + 1):
        m += 1
    return m


@pytest.mark.parametrize("dtype,cap", [(C64, 165), (torch.float32, 165),
                                       (C128, 115), (torch.float64, 115)])
def test_cpqr_max_m_from_its_layout_and_cached(dtype, cap):
    cpqr_cuda.max_m.cache_clear()
    want = _largest(lambda m: cpqr_cuda.smem_bytes(m, dtype)
                    <= cuda_build.SMEM_MAX)
    assert cpqr_cuda.max_m(dtype) == want == cap
    before = cpqr_cuda.max_m.cache_info()
    assert cpqr_cuda.max_m(dtype) == cap
    after = cpqr_cuda.max_m.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)


@pytest.mark.parametrize("dtype,cap", [(C64, 656), (C128, 556)])
def test_taylor_max_m_from_its_layout_and_cached(dtype, cap):
    taylor_cuda.max_m.cache_clear()
    tn = taylor_cuda.TILES[dtype][1]
    want = _largest(lambda m: (
        taylor_cuda.smem_bytes(m, tn, dtype) <= cuda_build.SMEM_MAX
        and taylor_cuda.threads(m, tn, dtype)
        <= taylor_cuda.MAX_THREADS[dtype]))
    assert taylor_cuda.max_m(dtype) == want == cap
    before = taylor_cuda.max_m.cache_info()
    assert taylor_cuda.fits(cap, dtype) and not taylor_cuda.fits(cap + 1,
                                                                 dtype)
    after = taylor_cuda.max_m.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 2


@pytest.mark.parametrize("helper,args", [
    (taylor_cuda.plan, (228, 84, C64)),
    (exx_cuda.plan, (1024, 42, 228, 256, C64)),
    (batchla_cuda.inv_max_n, (C128,)),
    (greens_cuda.plan, (16, 7, C64, True)),
    (batchla_cuda.chol_plan, (42, C64)),
    (sweep_cuda.plan, (7, 7))])
def test_plans_and_caps_are_cached(helper, args):
    helper.cache_clear()
    first = helper(*args)
    assert helper(*args) is first
    info = helper.cache_info()
    assert (info.hits, info.misses) == (1, 1)


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("want_gh", [True, False])
@pytest.mark.parametrize("n", [1, 3, 7, 18, 24, "cap"])
def test_greens_plan_mirrors_the_launcher(dtype, want_gh, n):
    """Lanes the next power of two >= n (at most 32), walkers 64 / lanes
    unless their matrices overflow a block, the odd row stride where it
    fits, staging only when phi's slabs, psi and the matrices fit 48 KB."""
    cap = greens_cuda.max_n(dtype, want_gh)
    n = cap if n == "cap" else n
    m = 16 if n == 7 else 4 * n
    pl = greens_cuda.plan(m, n, dtype, want_gh)
    assert pl.lanes == min(32, 1 << (n - 1).bit_length())
    ncol = 2 * n if want_gh else n
    assert pl.ld in (ncol, ncol | 1)
    per = n * pl.ld * dtype.itemsize
    assert pl.walkers * pl.lanes <= greens_cuda.THREADS
    assert pl.walkers >= 1 and pl.walkers * per <= cuda_build.SMEM_MAX
    if n == 7 and dtype == C64 and want_gh:
        assert pl == greens_cuda.Plan(8, 8, 15, True)   # 128 blocks at W=1024
    if n == cap:
        assert not pl.staged and pl.walkers == 1
        with pytest.raises(ValueError, match="largest the kernel takes"):
            greens_cuda.plan(4 * cap + 4, cap + 1, dtype, want_gh)


@pytest.mark.parametrize("m,route", [(1, ("warp", 4)), (9, ("warp", 4)),
                                     (32, ("warp", 4)), (33, ("block", 1)),
                                     (93, ("block", 1)), (165, ("block", 1))])
def test_cpqr_route_follows_m(m, route):
    assert cpqr_cuda.route(m) == route


@pytest.mark.parametrize("dtype,cap", [(C64, 170), (C128, 120)])
def test_chol_plan_routes_by_n_up_to_the_cap(dtype, cap):
    """Lanes up to n = 32 (G = the next power of two >= n, lane r owning
    row r, 64 / G matrices a block), a 256-thread block a matrix from 33
    (thread t owning row t mod n); the row stride n | 1 where the block's
    matrices fit 227 KB, n at the complex64 cap; ValueError past the cap,
    which is clinalg.cholesky_qr's route to torch.linalg."""
    assert batchla_cuda.chol_max_n(dtype) == cap
    size = dtype.itemsize
    for n in list(range(1, 45)) + [93, cap - 1, cap]:
        pl = batchla_cuda.chol_plan(n, dtype)
        assert pl.ld in (n, n | 1) and pl.threads % pl.group == 0
        per_block = pl.threads // pl.group
        assert per_block * n * pl.ld * size <= cuda_build.SMEM_MAX
        if pl.ld == n and n % 2 == 0:
            assert per_block * n * (n + 1) * size > cuda_build.SMEM_MAX
        if n <= 32:
            assert pl.route == "lanes" and pl.rows == pl.group
            assert pl.group == 1 << (n - 1).bit_length()
            assert pl.threads == 64 and pl.group <= 32
        else:
            assert pl.route == "block" and pl.rows == n
            assert pl.threads == pl.group == 256
    assert batchla_cuda.chol_plan(7, C64) == batchla_cuda.CholPlan(
        "lanes", 64, 8, 8, 7)                   # 128 blocks at w = 1024
    assert batchla_cuda.chol_plan(42, C64) == batchla_cuda.CholPlan(
        "block", 256, 256, 42, 43)              # 6 threads a row
    assert batchla_cuda.chol_plan(170, C64).ld == 170
    for bad in (0, cap + 1):
        with pytest.raises(ValueError, match="what the kernel takes"):
            batchla_cuda.chol_plan(bad, dtype)


@pytest.mark.parametrize("na,nb,lanes", [(1, 1, 1), (3, 3, 4), (7, 7, 8),
                                         (4, 2, 4), (17, 5, 32),
                                         (32, 32, 32), (5, 32, 32)])
def test_sweep_plan_lanes_follow_the_larger_spin(na, nb, lanes):
    pl = sweep_cuda.plan(na, nb)
    assert pl == sweep_cuda.Plan(lanes, 64 // lanes, na | 1, nb | 1)
    assert pl.walkers * (na * pl.lda + nb * pl.ldb) * 8 <= 48 * 1024
    for bad in ((33, 1), (1, 33), (0, 3)):
        with pytest.raises(ValueError, match="what the kernel takes"):
            sweep_cuda.plan(*bad)
