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
  cap for the type to the kernel's wrapper, larger n to
  torch.linalg, both against numpy (1e-10 / 1e-4, times n for the
  log-det);
* ``chol_mirror``, the Cholesky kernel's order of work (one chain of n
  steps, the forward substitution fused into the Cholesky, row i holding
  X[i, :k] beside its trailing row), against chol_inv_lanes_plain in
  float64 at 1e-12 of the scale, on both of the kernel's routes and their
  edges; the strict upper triangle of S is never read;
* exactly singular matrices (``chip_smoke.ZERO_PIVOT_CASES``): every
  log-det route of the port (clinalg.slogdet, kernel B's plain version in
  both modes, the augmented Gauss-Jordan, kernel A's plain version)
  gives log|det| = -inf and JAX's CPU slogdet's phase (mod 2 pi) where
  that is finite, -inf with a finite phase where JAX's is nan (a zero
  pivot before the last); a zero pivot eliminates nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.ops import batchla_pallas as jbp
from pauxy_tpu.ops import clinalg as jcl
from chip_smoke import ZERO_PIVOT_CASES, pivot_cases
from pauxy_tpu_torch.ops import batchla_cuda, clinalg, greens_cuda
from pauxy_tpu_torch.ops import lanelinalg

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
    (torch.complex128, True, 120), (torch.complex128, False, 120),
    (torch.complex64, True, 169), (torch.complex64, False, 169),
    (torch.float64, True, 169), (torch.float32, True, 241)])
def test_kernel_b_routes_by_shape(dtype, want_inv, cap, monkeypatch):
    """clinalg sends n up to what kernel B launches for the type (its one
    n x n matrix, rows padded to the odd stride n | 1, in 227 KB of shared
    memory beside its pivot scalars; the same cap in both modes) to the
    kernel's wrapper, and a larger n to torch.linalg; the
    decision is made by shape, the same on either device. At the thermal
    shape n = 93 every type goes to the kernel in both modes."""
    assert batchla_cuda.inv_max_n(dtype) == cap

    def smem(n):
        return (n * (n | 1) * dtype.itemsize
                + batchla_cuda.BLOCK_STATIC_BYTES)
    assert smem(cap) <= batchla_cuda.SMEM_MAX < smem(cap + 1)
    assert cap >= 93
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
        assert clinalg.uses_kernel_b(st) == (n == cap)
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


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64])
def test_kernel_b_cpu_wrapper_takes_its_plain_version(dtype, monkeypatch):
    """On a CPU tensor kernel B's wrapper runs the kernel's plain version
    (in-place Gauss-Jordan / LU) and nothing else, for every n from 1 up
    to the cap, every type and mode: the function it computes depends on
    the shape and type alone, and no launch is counted."""
    cap = batchla_cuda.inv_max_n(dtype)
    calls = []
    real = batchla_cuda.inv_logdet_plain
    monkeypatch.setattr(
        batchla_cuda, "inv_logdet_plain",
        lambda s, want_inv=True: (calls.append((s.shape, want_inv))
                                  or real(s, want_inv)))
    rng = np.random.default_rng(cap)
    before = batchla_cuda.launches
    ns = (1, 2, 5, 6, 7, 16, 42, cap)
    for n in ns:
        s = torch.from_numpy(pivot_cases(rng, 3, n, dtype.is_complex)
                             ).to(dtype)
        for want_inv in (True, False):
            ld, inv = batchla_cuda.inv_logdet_lanes(s, want_inv)
            assert ld.shape == (3,)
            assert (inv is None) != want_inv
    assert calls == [((3, n, n), want_inv) for n in ns
                     for want_inv in (True, False)]
    assert batchla_cuda.launches == before


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n", [1, 2, 5, 6, 32, 40])
def test_kernel_b_plain_matches_pallas_interpret(n, complex_):
    """Kernel B's plain version (in-place Gauss-Jordan with the inverse, LU
    without) against the TPU kernel in interpret mode, in the
    TPU kernel's float32, on matrices that need pivoting: 1e-4 relative,
    1e-4 n for the log-det."""
    rng = np.random.default_rng(30 + n)
    dt = np.complex64 if complex_ else np.float32
    s = pivot_cases(rng, 37, n, complex_).astype(dt)
    ld_j, inv_j = jbp.inv_logdet_lanes(jnp.asarray(s), interpret=True)
    for want_inv in (True, False):
        ld_t, inv_t = batchla_cuda.inv_logdet_plain(
            torch.from_numpy(s), want_inv)
        assert ld_t.dtype == torch.complex64
        d = ld_t.numpy() - np.asarray(ld_j)
        assert np.abs(d.real).max() < 1e-4 * n
        assert np.abs(np.angle(np.exp(1j * d.imag))).max() < 1e-4 * n
        if want_inv:
            assert inv_t.dtype == torch.from_numpy(s).dtype
            assert rel(inv_t.numpy(), inv_j) < 1e-4
        else:
            assert inv_t is None


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("n", [1, 3, 6, 42, 93])
def test_kernel_b_plain_matches_linalg_f64(n, complex_):
    """Kernel B's plain version against torch.linalg in float64,
    with the pivot-needing matrices: 1e-10 (times n for the log-det); a
    real input's log-det has imaginary part 0 or pi."""
    rng = np.random.default_rng(40 + n)
    s = torch.from_numpy(pivot_cases(rng, 9, n, complex_))
    sign, logabs = torch.linalg.slogdet(s)
    want = torch.linalg.inv(s)
    for want_inv in (True, False):
        ld, inv = batchla_cuda.inv_logdet_plain(s, want_inv)
        assert (ld.real - logabs).abs().max().item() < 1e-10 * n
        assert (torch.exp(1j * ld.imag) - sign).abs().max().item() < 1e-10 * n
        if not complex_:
            im = ld.imag.abs().numpy()
            assert np.all((im == 0) | (im == np.pi))
        if want_inv:
            assert inv.dtype == s.dtype
            assert rel(inv.numpy(), want.numpy()) < 1e-10


def test_kernel_b_plain_undoes_row_swaps_exactly():
    """Permutation matrices: every step swaps rows, and the in-place
    inverse comes back as the exact transpose once the swaps are undone as
    column swaps; the log-det is i pi times the permutation's parity."""
    rng = np.random.default_rng(7)
    n = 13
    perms = [rng.permutation(n) for _ in range(6)] + [np.arange(n)[::-1]]
    s = np.stack([np.eye(n)[p] for p in perms])
    for dtype in (torch.float64, torch.complex64):
        st = torch.from_numpy(s).to(dtype)
        ld, inv = batchla_cuda.inv_logdet_plain(st)
        assert torch.equal(inv, st.transpose(1, 2))
        parity = np.round(np.linalg.det(s))
        assert np.all(ld.real.numpy() == 0)
        np.testing.assert_allclose(np.cos(ld.imag.numpy()), parity, atol=1e-6)


def chol_mirror(s):
    """csrc/chol_inv.cu's order of work, batched over matrices, plain
    torch. Step k: phase A forms L[i, k] = a_ik / d for the rows below k
    and writes conj(L[i, k]) into row k right of the diagonal, and 1 / d
    of step k - 1 onto row k - 1's diagonal; phase B subtracts L[i, k] p
    from each row below k, p = (X[k, :k] / d, 1 / d, conj(L[k + 1:, k])),
    after X[i, k] = 0. The rows are scaled by their 1 / d at the end."""
    w, n, _ = s.shape
    a = s.clone()
    log_l = torch.zeros(w, dtype=s.real.dtype)
    id_prev = None
    for k in range(n):
        d = torch.sqrt(torch.clamp_min(a[:, k, k].real, 1e-30))
        log_l = log_l + torch.log(d)
        idv = 1.0 / d
        lk = a[:, k + 1:, k] * idv[:, None]
        a[:, k, k + 1:] = lk.conj()
        if k > 0:
            a[:, k - 1, k - 1] = id_prev
        id_prev = idv
        p = a[:, k].clone()
        p[:, :k] = p[:, :k] * idv[:, None]
        p[:, k] = idv
        a[:, k + 1:, k] = 0
        a[:, k + 1:] -= lk[:, :, None] * p[:, None, :]
    a[:, n - 1, n - 1] = id_prev
    dg = torch.diagonal(a, dim1=1, dim2=2).real
    return log_l, (torch.tril(a * dg[:, :, None], -1)
                   + torch.diag_embed(dg.to(a.dtype)))


@pytest.mark.parametrize("n", [1, 7, 16, 32, 33, 42])
def test_chol_mirror_matches_plain_f64(n):
    """Both routes of the kernel (lanes up to n = 32, a block above) do the
    same arithmetic; the mirror is held to the plain version at 1e-12 of
    the scale, the log-det at 1e-12 of its size."""
    route = batchla_cuda.chol_plan(n, torch.complex128).route
    assert route == ("lanes" if n <= 32 else "block")
    s = torch.from_numpy(hpd(np.random.default_rng(40 + n), 5, n))
    ld, linv = chol_mirror(s)
    ld_p, linv_p = batchla_cuda.chol_inv_lanes_plain(s)
    assert (ld - ld_p).abs().max().item() <= 1e-12 * (
        ld_p.abs().max().item() + 1.0)
    assert (linv - linv_p).abs().max().item() <= 1e-12 * (
        linv_p.abs().max().item())
    assert torch.equal(linv, torch.tril(linv))


def test_chol_mirror_reads_only_the_lower_triangle():
    """NaN above the diagonal of S changes neither the mirror's result nor
    the plain version's (the kernel loads whole rows; what it loads above
    the diagonal is overwritten before it is read)."""
    n = 9
    s = torch.from_numpy(hpd(np.random.default_rng(3), 4, n))
    poisoned = s.clone()
    iu = torch.triu_indices(n, n, 1)
    poisoned[:, iu[0], iu[1]] = float("nan")
    for fn in (chol_mirror, batchla_cuda.chol_inv_lanes_plain):
        ld, linv = fn(s)
        ld_n, linv_n = fn(poisoned)
        assert torch.equal(ld, ld_n) and torch.equal(linv, linv_n)


@pytest.mark.parametrize("case,dtype", [
    (c[0], dtype) for c in ZERO_PIVOT_CASES
    for dtype in (torch.complex128, torch.complex64, torch.float64)
    if dtype.is_complex or not np.iscomplexobj(np.array(c[1]))])
def test_zero_pivot_log_det_matches_jax(case, dtype):
    _, m, arg, jax_finite = next(c for c in ZERO_PIVOT_CASES
                                 if c[0] == case)
    m = np.array(m, dtype=complex)
    if not dtype.is_complex:
        m = m.real
    s = torch.from_numpy(m[None].copy()).to(dtype)
    n = m.shape[-1]
    routes = {
        "clinalg": clinalg.slogdet(s),
        "inv_logdet": clinalg.inv_logdet(s)[0],
        "plain_lu": batchla_cuda.inv_logdet_plain(s, False)[0],
        "plain_gj": batchla_cuda.inv_logdet_plain(s, True)[0],
        "lanes_gj": batchla_cuda.inv_logdet_lanes_plain(s, True)[0],
        "lanes_lu": lanelinalg.slogdet(lanelinalg.to_lanes(s)),
    }
    if dtype.is_complex:
        # Kernel A's plain version with S = phi^T conj(psi) = s.
        psi = torch.eye(4, n, dtype=dtype)
        phi = torch.zeros(4, n, 1, dtype=dtype)
        phi[:n] = s.permute(2, 1, 0)
        for want_gh in (True, False):
            routes[f"greens_{want_gh}"] = greens_cuda.greens_lanes_plain(
                psi, phi, want_gh)[0]
    want = np.asarray(jcl.slogdet(jnp.asarray(m[None])))[0]
    assert (np.isneginf(want.real) and np.isfinite(want.imag)) == jax_finite
    for name, ld in routes.items():
        ld = complex(ld.numpy()[0])
        assert np.isneginf(ld.real), (name, ld)
        assert np.isfinite(ld.imag), (name, ld)
        target = want.imag if jax_finite else arg
        assert abs(np.angle(np.exp(1j * (ld.imag - target)))) < 1e-6, (
            name, ld, want)
