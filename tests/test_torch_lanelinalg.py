"""Port parity: ops/lanelinalg (torch) against pauxy_tpu.ops.lanelinalg (JAX).

Same numpy inputs on both sides, float64/complex128 on the CPU. Tolerance
1e-10 relative; imaginary parts of log-determinants are compared modulo
2 pi (the branch of a sum of logs is not unique).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.ops import lanelinalg as jll
from pauxy_tpu_torch.ops import lanelinalg as tll

torch.set_num_threads(1)

RTOL = 1e-10

# Jitted once: eager op-by-op dispatch of the unrolled JAX code is slow.
j_gauss = jax.jit(jll.gauss)
j_slogdet = jax.jit(jll.slogdet)
j_cholesky_qr2 = jax.jit(jll.cholesky_qr2)


def rand_lanes(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def assert_logdet_close(a, b, n):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, np.abs(b.real).max())
    np.testing.assert_allclose(a.real, b.real, rtol=0, atol=RTOL * n * scale)
    dphase = np.angle(np.exp(1j * (a.imag - b.imag)))
    assert np.abs(dphase).max() <= RTOL * n * 10


@pytest.mark.parametrize("n,k,w", [(1, 1, 3), (3, 2, 5), (7, 16, 24),
                                   (12, 4, 9)])
def test_gauss_matches_jax(n, k, w):
    rng = np.random.default_rng(n * 100 + k)
    s = rand_lanes(rng, n, n, w)
    rhs = rand_lanes(rng, n, k, w)
    ld_j, x_j = j_gauss(jnp.asarray(s), jnp.asarray(rhs))
    ld_t, x_t = tll.gauss(torch.from_numpy(s), torch.from_numpy(rhs))
    assert_logdet_close(ld_t.numpy(), ld_j, n)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(x_j)).max())


def test_gauss_needs_pivoting_and_empty():
    s = np.zeros((2, 2, 1), np.complex128)
    s[:, :, 0] = [[0.0, 1.0], [1.0, 0.0]]
    ld, x = tll.gauss(torch.from_numpy(s), torch.from_numpy(s))
    np.testing.assert_allclose(np.exp(ld.numpy()), [-1.0], atol=1e-14)
    np.testing.assert_allclose(x.numpy()[:, :, 0], np.eye(2), atol=1e-14)
    ld0, _ = tll.gauss(torch.zeros(0, 0, 4, dtype=torch.complex128))
    assert ld0.shape == (4,) and not ld0.abs().any()


@pytest.mark.parametrize("n,w", [(3, 4), (7, 24)])
def test_slogdet_matches_jax(n, w):
    rng = np.random.default_rng(7 + n)
    s = rand_lanes(rng, n, n, w)
    assert_logdet_close(tll.slogdet(torch.from_numpy(s)).numpy(),
                        j_slogdet(jnp.asarray(s)), n)
    sign, la = np.linalg.slogdet(np.moveaxis(s, -1, 0))
    ld = tll.slogdet(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(ld.real, la, rtol=1e-12)
    np.testing.assert_allclose(np.exp(1j * ld.imag), sign, atol=1e-12)


@pytest.mark.parametrize("m,n,w", [(9, 3, 5), (16, 7, 24)])
def test_gram_and_cholesky_qr2_match_jax(m, n, w):
    rng = np.random.default_rng(m + n)
    phi = rand_lanes(rng, m, n, w)
    np.testing.assert_allclose(tll.gram(torch.from_numpy(phi)).numpy(),
                               np.asarray(jll.gram(jnp.asarray(phi))),
                               rtol=RTOL)
    q_j, ld_j = j_cholesky_qr2(jnp.asarray(phi))
    q_t, ld_t = tll.cholesky_qr2(torch.from_numpy(phi))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=RTOL)
    # log det R convention: |det phi^dag phi| = exp(2 log det R).
    q = np.moveaxis(q_t.numpy(), -1, 0)
    np.testing.assert_allclose(np.conj(np.swapaxes(q, 1, 2)) @ q,
                               np.broadcast_to(np.eye(n), (w, n, n)),
                               atol=1e-12)
    g = np.moveaxis(tll.gram(torch.from_numpy(phi)).numpy(), -1, 0)
    np.testing.assert_allclose(2 * ld_t.numpy(),
                               np.linalg.slogdet(g)[1], rtol=1e-10)


def test_cholesky_qr2_empty_columns():
    q, ld = tll.cholesky_qr2(torch.zeros(4, 0, 3, dtype=torch.complex128))
    assert q.shape == (4, 0, 3) and ld.shape == (3,) and not ld.any()


def test_matmul_left_and_overlap_lanes_match_jax():
    rng = np.random.default_rng(3)
    a = rand_lanes(rng, 16, 16)
    x = rand_lanes(rng, 16, 7, 10)
    psi = rand_lanes(rng, 16, 7)
    np.testing.assert_allclose(
        tll.matmul_left(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
        np.asarray(jll.matmul_left(jnp.asarray(a), jnp.asarray(x))),
        rtol=RTOL)
    np.testing.assert_allclose(
        tll.overlap_lanes(torch.from_numpy(psi), torch.from_numpy(x)).numpy(),
        np.asarray(jll.overlap_lanes(jnp.asarray(psi), jnp.asarray(x))),
        rtol=RTOL)
    y = np.moveaxis(x, -1, 0)
    np.testing.assert_array_equal(
        tll.to_lanes(torch.from_numpy(y)).numpy(),
        np.asarray(jll.to_lanes(jnp.asarray(y))))
    np.testing.assert_array_equal(
        tll.from_lanes(torch.from_numpy(x)).numpy(), y)
