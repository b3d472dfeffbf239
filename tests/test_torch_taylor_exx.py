"""The Taylor and exchange kernels' plain versions against the JAX package.

  * Taylor: ``taylor_cuda.apply_taylor_plain`` against the Pallas kernel in
    interpret mode (which computes in float32) at complex64 inputs,
    max|d| <= 1e-4 max|out|, and against JAX's XLA route in float64 at
    rtol 1e-10;
  * exx: ``exx_cuda.exx_plain`` against the Pallas kernel in interpret mode
    (float32), per walker |d_w| <= 1e-4 S_w with S_w = sum_x sum_ij
    |T_ij||T_ji| (exx sums X n^2 products that may cancel), and against
    JAX's ``_exx`` without a supermatrix (its einsum route on the CPU) in
    float64 at rtol 1e-10;
  * the Taylor kernel's bf16 tier: ``apply_taylor_plain(lowp=True)``
    against the Pallas kernel's bf16 branch in interpret mode at
    tests/test_generic.py:336-349's inputs and two more shapes (complex64,
    and complex128 whose planes go in as float32), max|d| <= 1e-3
    max|out|, and both within JAX's own 5e-3 of the exact series
    (complex128); the bf16 route's cap (``max_m_bf16``) and plan;
  * both wrappers take the plain version on a CPU tensor and launch nothing;
  * ``_exx`` sends every real rchol to the exchange kernel's wrapper,
    whatever its shape, and a complex one to the einsum route.
Walker counts 1, 5 and 37 (the Pallas kernels' blocks are 8 walkers), odd
M and n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.ops.exx_pallas import exx_pallas
from pauxy_tpu.ops.taylor_pallas import apply_taylor_pallas
from pauxy_tpu.propagation.generic import apply_exponential_taylor
from pauxy_tpu_torch.ops import exx_cuda, taylor_cuda

torch.set_num_threads(1)

WALKERS = [1, 5, 37]
TAYLOR_SHAPES = [(7, 5), (12, 9), (16, 14)]
EXX_SHAPES = [(30, 3, 12), (17, 5, 9), (11, 4, 13)]


def taylor_inputs(w, m, ncol, seed):
    rng = np.random.default_rng(seed)
    vhs = 0.15 * (rng.normal(size=(w, m, m)) + 1j * rng.normal(size=(w, m, m)))
    phi = rng.normal(size=(w, m, ncol)) + 1j * rng.normal(size=(w, m, ncol))
    return vhs, phi


# (w, M, C, seed, dtype): tests/test_generic.py:336-349's inputs, the UEG
# golden system's M = 33 with both spins' 14 columns, and an odd shape.
BF16_CASES = [(6, 20, 7, 0, np.complex64), (5, 33, 14, 1, np.complex64),
              (9, 17, 5, 2, np.complex128)]


def exx_inputs(x, n, m, w, seed):
    rng = np.random.default_rng(seed)
    rc = rng.normal(size=(x, n, m)) / np.sqrt(m)
    gh = rng.normal(size=(w, n, m)) + 1j * rng.normal(size=(w, n, m))
    return rc, gh


@pytest.mark.parametrize("w", WALKERS)
@pytest.mark.parametrize("m,ncol", TAYLOR_SHAPES)
def test_taylor_plain_matches_pallas_interpret(w, m, ncol):
    vhs, phi = taylor_inputs(w, m, ncol, seed=w * m + ncol)
    vhs, phi = vhs.astype(np.complex64), phi.astype(np.complex64)
    ref = np.asarray(apply_taylor_pallas(jnp.asarray(vhs), jnp.asarray(phi),
                                         interpret=True))
    out = taylor_cuda.apply_taylor_plain(torch.from_numpy(vhs),
                                         torch.from_numpy(phi)).numpy()
    assert out.dtype == np.complex64 and out.shape == (w, m, ncol)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("w", WALKERS)
@pytest.mark.parametrize("m,ncol", TAYLOR_SHAPES)
def test_taylor_plain_matches_xla_route(w, m, ncol):
    vhs, phi = taylor_inputs(w, m, ncol, seed=w + m * ncol)
    ref = apply_exponential_taylor(jnp.asarray(vhs), jnp.asarray(phi))
    before = taylor_cuda.launches
    out = taylor_cuda.apply_taylor(torch.from_numpy(vhs),
                                   torch.from_numpy(phi))
    assert taylor_cuda.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("w,m,ncol,seed,dtype", BF16_CASES)
def test_taylor_bf16_plain_matches_pallas_interpret(w, m, ncol, seed, dtype):
    rng = np.random.default_rng(seed)
    vhs = (0.1 * (rng.normal(size=(w, m, m))
                  + 1j * rng.normal(size=(w, m, m)))).astype(dtype)
    phi = (rng.normal(size=(w, m, ncol))
           + 1j * rng.normal(size=(w, m, ncol))).astype(dtype)
    ref = np.asarray(apply_taylor_pallas(jnp.asarray(vhs), jnp.asarray(phi),
                                         lowp=True, interpret=True))
    before = (taylor_cuda.launches, taylor_cuda.launches_bf16)
    out = taylor_cuda.apply_taylor(torch.from_numpy(vhs),
                                   torch.from_numpy(phi), lowp=True).numpy()
    assert (taylor_cuda.launches, taylor_cuda.launches_bf16) == before
    assert out.dtype == dtype and out.shape == (w, m, ncol)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-3 * scale
    exact = np.asarray(apply_exponential_taylor(
        jnp.asarray(vhs.astype(np.complex128)),
        jnp.asarray(phi.astype(np.complex128))))
    assert np.abs(out - exact).max() <= 5e-3 * scale
    assert np.abs(ref - exact).max() <= 5e-3 * scale
    # The float32 tier is far closer to the exact series.
    f32 = taylor_cuda.apply_taylor_plain(torch.from_numpy(vhs),
                                         torch.from_numpy(phi)).numpy()
    assert np.abs(f32 - exact).max() < np.abs(out - exact).max()


def test_taylor_bf16_cap_and_plan():
    cap = taylor_cuda.max_m_bf16()
    assert taylor_cuda.fits(cap, torch.complex64, lowp=True)
    assert not taylor_cuda.fits(cap + 1, torch.complex64, lowp=True)
    assert taylor_cuda.fits(cap + 1, torch.float32, lowp=True)
    smem = taylor_cuda.cuda_build.SMEM_MAX
    assert taylor_cuda.smem_bytes_bf16(cap, 8) <= smem
    assert taylor_cuda.smem_bytes_bf16(cap + 1, 8) > smem
    for m, ncol in ((257, 14), (33, 14), (128, 32), (228, 84), (cap, 14)):
        cb = taylor_cuda.plan_bf16(m, ncol)
        assert cb % 8 == 0 and taylor_cuda.smem_bytes_bf16(m, cb) <= smem
        parts = -(-ncol // cb)
        assert parts == 1 or taylor_cuda.smem_bytes_bf16(
            m, taylor_cuda.cuda_build.round_up(-(-ncol // (parts - 1)),
                                               8)) > smem
    assert taylor_cuda.plan_bf16(257, 14) == 16
    with pytest.raises(ValueError, match="bf16"):
        taylor_cuda.plan_bf16(cap + 1, 14)


@pytest.mark.parametrize("w", WALKERS)
@pytest.mark.parametrize("x,n,m", EXX_SHAPES)
def test_exx_plain_matches_pallas_interpret(w, x, n, m):
    rc, gh = exx_inputs(x, n, m, w, seed=x + n + m + w)
    rc, gh = rc.astype(np.float32), gh.astype(np.complex64)
    ref = np.asarray(exx_pallas(jnp.asarray(rc), jnp.asarray(gh),
                                interpret=True))
    trc, tgh = torch.from_numpy(rc), torch.from_numpy(gh)
    out = exx_cuda.exx_plain(trc, tgh).numpy()
    scale = exx_cuda.exx_magnitude(trc, tgh).numpy()
    assert out.dtype == np.complex64 and out.shape == (w,)
    assert np.all(np.abs(out - ref) <= 1e-4 * scale)
    assert np.all(np.abs(out) <= scale * (1 + 1e-6))


@pytest.mark.parametrize("w", WALKERS)
@pytest.mark.parametrize("x,n,m", EXX_SHAPES)
def test_exx_plain_matches_jax_einsum_route(w, x, n, m):
    rc, gh = exx_inputs(x, n, m, w, seed=3 * x + n + w)
    ref = jle._exx(jnp.asarray(rc), jnp.asarray(gh), exx_super=None)
    before = exx_cuda.launches
    out = exx_cuda.exx(torch.from_numpy(rc), torch.from_numpy(gh))
    assert exx_cuda.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_exx_kernel_shapes(monkeypatch):
    """A real rchol takes the kernel's route at every shape, including one
    whose walker exceeds a block's shared memory (the kernel stages column
    chunks); a complex rchol takes the einsum route. Both agree with JAX's
    ``_exx`` at rtol 1e-10."""
    from pauxy_tpu_torch.estimators import local_energy as tle

    calls = []
    kernel_route = exx_cuda.exx

    def spy(rchol, ghalf):
        calls.append(tuple(rchol.shape))
        return kernel_route(rchol, ghalf)

    monkeypatch.setattr(exx_cuda, "exx", spy)
    for x, n, m in ((3, 128, 400), (2, 130, 9), (30, 3, 12)):
        rc, gh = exx_inputs(x, n, m, 2, seed=x + n + m)
        ref = np.asarray(jle._exx(jnp.asarray(rc), jnp.asarray(gh)))
        out = tle._exx(torch.from_numpy(rc), torch.from_numpy(gh))
        assert calls[-1] == (x, n, m)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)
        crc = rc + 0.5j * rc[::-1]
        ref = np.asarray(jle._exx(jnp.asarray(crc), jnp.asarray(gh)))
        out = tle._exx(torch.from_numpy(crc), torch.from_numpy(gh))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)
    assert len(calls) == 3


# The resident route's caps by C (C padded to 8: at most 592, 512, 496 and
# 432 rows), worked out by hand from the shared-memory budget
# 8 cb (MP + 8) + 64 T (MP + 8) <= 232448 with T = ceil(MP / 16 / 8).
RESIDENT_CAPS = {1: 592, 7: 592, 8: 592, 14: 512, 16: 512, 32: 432}


@pytest.mark.parametrize("ncol", sorted(RESIDENT_CAPS))
def test_taylor_bf16_route_every_m(ncol):
    """For every M the bf16 kernel takes, route_bf16 picks the resident
    route with the smallest cluster whose CTA fits (shared memory, at most
    16 row tiles, the tiles covering M) up to the cap, and the streaming
    route with plan_bf16's columns from just past it to max_m_bf16."""
    tc = taylor_cuda
    smem = tc.cuda_build.SMEM_MAX
    cap = tc.max_m_resident(ncol)
    assert cap == RESIDENT_CAPS[ncol]
    assert tc.max_m_bf16() == 1808
    for m in range(1, tc.max_m_bf16() + 1):
        r = tc.route_bf16(m, ncol)
        assert tc.fits(m, torch.complex64, lowp=True)
        if m > cap:
            assert r == (("streaming", tc.plan_bf16(m, ncol), 1, 0))
            assert tc.smem_bytes_bf16(m, r.cb) <= smem
            continue
        mp = tc.cuda_build.round_up(m, 16)
        assert r.route == "resident" and r.cluster in (1, 2, 4, 8)
        assert r.cb == tc.cuda_build.round_up(ncol, 8) <= 32
        assert 1 <= r.tiles <= 16 and r.tiles == -(-mp // 16 // r.cluster)
        assert r.cluster * r.tiles * 16 >= mp
        assert tc.smem_bytes_resident(m, r.cb, r.tiles) <= smem
        for smaller in (1, 2, 4, 8):
            if smaller < r.cluster:
                assert tc.resident_plan(m, ncol, smaller) is None
    assert tc.route_bf16(cap, ncol).route == "resident"
    assert tc.route_bf16(cap + 1, ncol).route == "streaming"
    assert not tc.fits(tc.max_m_bf16() + 1, torch.complex64, lowp=True)


def test_taylor_bf16_route_edges():
    """The bench shape's plan and budget, the edge of each cluster size at
    C = 14, and C past 32 streaming at every M."""
    tc = taylor_cuda
    assert tc.route_bf16(257, 14) == ("resident", 16, 2, 9)
    assert tc.smem_bytes_resident(257, 16, 9) == 35840 + 161280
    assert tc.route_bf16(33, 14) == ("resident", 16, 1, 3)
    assert tc.route_bf16(128, 32) == ("resident", 32, 1, 8)
    assert tc.route_bf16(257, 32) == ("resident", 32, 4, 5)
    for edge, cluster, past in ((208, 1, 2), (288, 2, 4), (384, 4, 8)):
        assert tc.route_bf16(edge, 14).cluster == cluster
        assert tc.route_bf16(edge + 1, 14).cluster == past
    assert tc.route_bf16(512, 14) == ("resident", 16, 8, 4)
    assert tc.route_bf16(513, 14).route == "streaming"
    assert tc.max_m_resident(33) == 0
    assert tc.route_bf16(17, 33).route == "streaming"
    assert tc.route_bf16(228, 84) == ("streaming", tc.plan_bf16(228, 84), 1,
                                      0)


def test_taylor_bf16_forced_route_checked_before_launch():
    """The internal route argument takes only "streaming": another value
    raises before anything is launched."""
    vhs = torch.zeros(2, 33, 33, dtype=torch.complex64)
    phi = torch.zeros(2, 33, 14, dtype=torch.complex64)
    before = (taylor_cuda.launches_bf16, taylor_cuda.launches_bf16_resident,
              taylor_cuda.launches_bf16_streaming)
    for route in ("resident", "fast"):
        with pytest.raises(ValueError, match=f"route '{route}'"):
            taylor_cuda._apply_taylor_bf16(vhs, phi, 6, route=route)
    assert (taylor_cuda.launches_bf16, taylor_cuda.launches_bf16_resident,
            taylor_cuda.launches_bf16_streaming) == before
