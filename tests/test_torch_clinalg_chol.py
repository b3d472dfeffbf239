"""Port parity: the Cholesky-inverse kernel's plain version, CholeskyQR,
inverse and solve, and kernel B on real input, against the JAX package.

* chol_inv_lanes_plain against batchla_pallas.chol_inv_lanes in interpret
  mode: 1e-4 relative (the TPU kernel computes in float32);
* chol_inv_lanes_plain, cholesky_qr and cholesky_qr2 against JAX's
  clinalg on its XLA route, float64: 1e-10 (both sides of the port's
  shape cut, n <= 48 on the kernel and n > 48 on torch.linalg);
* clinalg.inv and solve, real and complex, against JAX, float64: 1e-10;
* kernel B's plain version on real input against
  batchla_pallas.inv_logdet_lanes(real, interpret=True): 1e-4 relative,
  a real inverse and a log-det with imaginary part 0 or pi;
* the route of clinalg's inverse and log-det by shape: n up to kernel B's
  cap for the type and mode to the kernel's wrapper, larger n to
  torch.linalg, both against numpy (1e-10 / 1e-4, times n for the
  log-det).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.ops import batchla_pallas as jbp
from pauxy_tpu.ops import clinalg as jcl
from pauxy_tpu_torch.ops import batchla_cuda, clinalg

torch.set_num_threads(1)


def hpd(rng, w, n, dtype=np.complex128):
    phi = rng.normal(size=(w, 2 * n, n)) + 1j * rng.normal(size=(w, 2 * n, n))
    return (np.conj(np.swapaxes(phi, 1, 2)) @ phi).astype(dtype)


def walkers(rng, w, m, n, complex_=True):
    phi = rng.normal(size=(w, m, n))
    if complex_:
        phi = phi + 1j * rng.normal(size=(w, m, n))
    return phi


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("n,w", [(3, 8), (7, 131), (16, 8)])
def test_chol_inv_plain_matches_pallas_interpret(n, w):
    s = hpd(np.random.default_rng(n), w, n, np.complex64)
    ld_j, l_j = jbp.chol_inv_lanes(jnp.asarray(s), interpret=True)
    ld_t, l_t = batchla_cuda.chol_inv_lanes(torch.from_numpy(s))
    assert ld_t.dtype == torch.float32 and l_t.dtype == torch.complex64
    assert rel(ld_t.numpy(), ld_j) < 1e-4
    assert rel(l_t.numpy(), l_j) < 1e-4


@pytest.mark.parametrize("n", [1, 7, 16])
def test_chol_inv_plain_matches_jax_cholesky_f64(n):
    s = hpd(np.random.default_rng(10 + n), 9, n)
    l_j = np.asarray(jcl.cholesky(jnp.asarray(s)))
    ld_t, linv_t = batchla_cuda.chol_inv_lanes(torch.from_numpy(s))
    np.testing.assert_allclose(
        ld_t.numpy(), np.log(np.diagonal(l_j, axis1=1, axis2=2).real).sum(-1),
        rtol=1e-10, atol=1e-10)
    eye = np.broadcast_to(np.eye(n), s.shape)
    np.testing.assert_allclose(linv_t.numpy() @ l_j, eye, atol=1e-10)
    assert np.abs(np.triu(linv_t.numpy(), 1)).max() == 0.0


@pytest.mark.parametrize("m,n", [(16, 7), (9, 3), (64, 50)])
def test_cholesky_qr_matches_jax(m, n):
    phi = walkers(np.random.default_rng(m + n), 6, m, n)
    q_j, d_j = jcl.cholesky_qr(jnp.asarray(phi))
    q_t, d_t = clinalg.cholesky_qr(torch.from_numpy(phi))
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(d_t.numpy().sum(-1), np.asarray(d_j).sum(-1),
                               rtol=1e-10, atol=1e-10)
    q2_j, r_j = jcl.cholesky_qr2(jnp.asarray(phi))
    q2_t, r_t = clinalg.cholesky_qr2(torch.from_numpy(phi))
    np.testing.assert_allclose(q2_t.numpy(), q2_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=1e-10, atol=1e-10)
    qtq = np.conj(np.swapaxes(q2_t.numpy(), 1, 2)) @ q2_t.numpy()
    np.testing.assert_allclose(qtq, np.broadcast_to(np.eye(n), qtq.shape),
                               atol=1e-12)


def test_cholesky_qr_routes_by_shape():
    """The kernel route up to what the kernel can launch (an n x n
    complex128 matrix per walker in 227 KB of shared memory: n <= 120),
    torch.linalg above it."""
    rng = np.random.default_rng(3)
    cap = batchla_cuda.chol_max_n(torch.complex128)
    assert cap == 120 and batchla_cuda.chol_max_n(torch.complex64) == 170
    for n, kernel in ((cap, True), (cap + 1, False)):
        phi = torch.from_numpy(walkers(rng, 2, n + 4, n))
        calls = []
        orig = batchla_cuda.chol_inv_lanes
        batchla_cuda.chol_inv_lanes = lambda s: calls.append(1) or orig(s)
        try:
            clinalg.cholesky_qr(phi)
        finally:
            batchla_cuda.chol_inv_lanes = orig
        assert bool(calls) == kernel


@pytest.mark.parametrize("complex_", [False, True])
def test_inv_and_solve_match_jax(complex_):
    rng = np.random.default_rng(4)
    s = 2.0 * np.eye(7) + 0.4 * walkers(rng, 10, 7, 7, complex_)
    s[0] = np.eye(7)[::-1]
    y = walkers(rng, 10, 7, 16, True)
    inv_t = clinalg.inv(torch.from_numpy(s))
    assert inv_t.dtype == torch.from_numpy(s).dtype
    np.testing.assert_allclose(inv_t.numpy(), jcl.inv(jnp.asarray(s)),
                               rtol=1e-10, atol=1e-10)
    x_t = clinalg.solve(torch.from_numpy(s), torch.from_numpy(y))
    x_j = jcl.solve(jnp.asarray(s), jnp.asarray(y))
    assert x_t.dtype == torch.complex128 and x_j.dtype == jnp.complex128
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-10, atol=1e-10)
    ld_t = clinalg.slogdet(torch.from_numpy(s.astype(np.complex128)))
    ld_j = jcl.slogdet(jnp.asarray(s.astype(np.complex128)))
    d = ld_t.numpy() - np.asarray(ld_j)
    np.testing.assert_allclose(d.real, 0.0, atol=1e-10)
    np.testing.assert_allclose(np.angle(np.exp(1j * d.imag)), 0.0,
                               atol=1e-10)


@pytest.mark.parametrize("n", [3, 7, 16])
def test_inv_logdet_plain_real_matches_pallas_interpret(n):
    rng = np.random.default_rng(20 + n)
    s = (2.0 * np.eye(n) + 0.4 * rng.normal(size=(37, n, n))
         ).astype(np.float32)
    s[0] = np.eye(n)[::-1]
    s[1] = -np.eye(n)
    ld_j, inv_j = jbp.inv_logdet_lanes(jnp.asarray(s), interpret=True)
    ld_t, inv_t = batchla_cuda.inv_logdet_lanes(torch.from_numpy(s))
    assert inv_t.dtype == torch.float32 and ld_t.dtype == torch.complex64
    assert rel(inv_t.numpy(), inv_j) < 1e-4
    d = ld_t.numpy() - np.asarray(ld_j)
    assert np.abs(d.real).max() < 1e-4 * n
    assert np.abs(np.angle(np.exp(1j * d.imag))).max() < 1e-4 * n
    for ld in (ld_t.numpy(), np.asarray(ld_j)):
        im = np.abs(np.angle(np.exp(1j * ld.imag)))
        assert np.all((im < 1e-4 * n) | (np.abs(im - np.pi) < 1e-4 * n))
    sign = np.sign(np.linalg.det(s.astype(np.float64)))
    np.testing.assert_allclose(np.cos(ld_t.numpy().imag), sign, atol=1e-6)


@pytest.mark.parametrize("dtype,want_inv,cap", [
    (torch.complex128, True, 85), (torch.complex128, False, 120),
    (torch.complex64, True, 120), (torch.complex64, False, 170),
    (torch.float64, True, 120), (torch.float32, True, 170)])
def test_kernel_b_routes_by_shape(dtype, want_inv, cap, monkeypatch):
    """clinalg sends n up to what kernel B launches for the type and mode
    (one matrix, and its inverse beside it, in 227 KB of shared memory) to
    the kernel's wrapper, and a larger n to torch.linalg; the decision is
    made by shape, the same on either device. At the thermal shape n = 93
    complex128 with the inverse goes to torch.linalg."""
    assert batchla_cuda.inv_max_n(dtype, want_inv) == cap
    entry = dtype.itemsize * (2 if want_inv else 1)
    assert cap * cap * entry <= batchla_cuda.SMEM_MAX
    assert (cap + 1) * (cap + 1) * entry > batchla_cuda.SMEM_MAX
    calls = []
    real = batchla_cuda.inv_logdet_lanes

    def record(s, want_inv=True):
        calls.append(s.shape[-1])
        return real(s, want_inv)

    monkeypatch.setattr(batchla_cuda, "inv_logdet_lanes", record)
    rng = np.random.default_rng(cap)
    for n in (cap, cap + 1):
        s = 2.0 * np.eye(n) + rng.normal(size=(2, n, n)) / n ** 0.5
        if dtype.is_complex:
            s = s + 1j * rng.normal(size=(2, n, n)) / n ** 0.5
        st = torch.from_numpy(s).to(dtype)
        assert clinalg.uses_kernel_b(st, want_inv) == (n == cap)
        calls.clear()
        if want_inv:
            ld, inv = clinalg.inv_logdet(st)
            assert rel(inv.numpy(), np.linalg.inv(s)) < TOL_ROUTE[dtype]
        else:
            ld = clinalg.slogdet(st)
        assert calls == ([n] if n == cap else [])
        sign, logabs = np.linalg.slogdet(s)
        assert np.abs(ld.real.numpy() - logabs).max() < TOL_ROUTE[dtype] * n
        assert np.abs(np.exp(1j * ld.imag.numpy()) - sign).max() \
            < TOL_ROUTE[dtype] * n


TOL_ROUTE = {torch.complex128: 1e-10, torch.float64: 1e-10,
             torch.complex64: 1e-4, torch.float32: 1e-4}
