"""Port tests for the column-pivoted QR (ops/cpqr.py, ops/cpqr_cuda.py).

* the plain version against JAX's ``_cpqr_xla`` in float64: the same
  pivots and Q, R within 1e-10 of max|R|, complex and real, m in {8, 12,
  16, 36, 93}, batch 1 and 5 (the same algorithm: deferred pivots,
  downdated norms with the exact refresh every 16 columns, compact WY);
* the plain version against the Pallas kernel ``cpqr_lanes`` in interpret
  mode in float32 at m <= 64: the factorization identities within 1e-4,
  and Q, R within 1e-4 where the pivots agree (near-tied column norms may
  pivot differently: exact norms in the kernel, downdated ones in the
  plain version);
* rank-deficient input: finite factors, tau = 0 columns, exact zeros below
  R's diagonal;
* ``unpermute_columns`` exactly;
* the routes: a CPU tensor takes the plain version (no launch); the
  kernel's cap by type; a tensor on any other device is refused;
* ``cpqr_mirror``, the CUDA kernel's order of work in plain torch (exact
  norms every step, the lowest index on ties, LAPACK scalars, V packed
  below the diagonal, then Q formed in place backwards in panels of
  ``cpqr_cuda.NB`` as I - V T V^H with T by xLARFT, the panel's rows and
  columns read as the identity), against the plain version in float64:
  1e-12 of max|R| at m in {1, 9, 16, 93, cap} on separated column norms
  (the same pivots), on exact ties (the same pivots, lowest index), and
  the identities on rank-deficient input. It catches index and
  panel-boundary errors of the kernel's algorithm on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.ops import cpqr as jcpqr
from pauxy_tpu.ops.cpqr_pallas import cpqr_lanes as j_cpqr_lanes
from pauxy_tpu_torch.ops import cpqr, cpqr_cuda

torch.set_num_threads(1)


def rand(rng, shape, cplx):
    a = rng.normal(size=shape)
    return a + 1j * rng.normal(size=shape) if cplx else a


def check_identities(a, q, r, perm, tol):
    """a[:, :, perm] = q r, q unitary, r upper triangular with exact zeros
    below the diagonal, |r_kk| non-increasing (with slack tol)."""
    b, m, _ = a.shape
    assert (np.sort(perm, axis=-1) == np.arange(m)).all()
    assert np.abs(np.tril(r, -1)).max(initial=0.0) == 0.0
    eye = np.eye(m)
    assert np.abs(np.conj(np.swapaxes(q, 1, 2)) @ q - eye).max() < tol
    ap = np.take_along_axis(a, perm[:, None, :], axis=-1)
    assert np.linalg.norm(ap - q @ r) / np.linalg.norm(a) < tol
    d = np.abs(np.diagonal(r, axis1=-2, axis2=-1))
    assert (d[:, 1:] <= d[:, :-1] + tol * d[:, :1]).all()


@pytest.mark.parametrize("cplx", [True, False])
@pytest.mark.parametrize("m", [8, 12, 16, 36, 93])
def test_plain_matches_jax_xla(m, cplx):
    rng = np.random.default_rng(m + 100 * cplx)
    a5 = rand(rng, (5, m, m), cplx)
    # JAX factors the batch of 5 once (its batch elements are independent);
    # the port factors batch 1 and batch 5.
    j5 = [np.asarray(x) for x in jax.jit(jcpqr._cpqr_xla)(jnp.asarray(a5))]
    for batch in (1, 5):
        a = a5[:batch]
        qj, rj, pj = (x[:batch] for x in j5)
        q, r, p = (x.numpy() for x in cpqr.cpqr(torch.from_numpy(a)))
        assert q.dtype == a.dtype and r.dtype == a.dtype
        np.testing.assert_array_equal(p, pj)
        scale = np.abs(rj).max()
        assert np.abs(q - qj).max() <= 1e-10 * scale
        assert np.abs(r - rj).max() <= 1e-10 * scale
        check_identities(a, q, r, p, 1e-12)


@pytest.mark.parametrize("m", [9, 16, 24, 64])
def test_plain_matches_pallas_interpret_float32(m):
    rng = np.random.default_rng(m)
    a = rand(rng, (5, m, m), True).astype(np.complex64)
    qk, rk, pk = (np.asarray(x) for x in j_cpqr_lanes(jnp.asarray(a),
                                                       interpret=True))
    q, r, p = (x.numpy() for x in cpqr_cuda.cpqr_lanes_plain(
        torch.from_numpy(a)))
    check_identities(a, q, r, p, 1e-4)
    check_identities(a, qk, rk, pk, 1e-4)
    same = (p == pk).all(axis=-1)
    assert same.any()
    scale = np.abs(rk).max()
    assert np.abs(q[same] - qk[same]).max() <= 1e-4 * max(scale, 1.0)
    assert np.abs(r[same] - rk[same]).max() <= 1e-4 * scale


def test_separated_norms_pivot_alike_with_pallas_interpret():
    """Well-separated column norms: the same pivots as the TPU kernel and
    the factors within float32 rounding."""
    rng = np.random.default_rng(3)
    m = 12
    a = (rand(rng, (3, m, m), True)
         * (10.0 ** np.arange(m))[None, None, :]).astype(np.complex64)
    qk, rk, pk = (np.asarray(x) for x in j_cpqr_lanes(jnp.asarray(a),
                                                       interpret=True))
    q, r, p = (x.numpy() for x in cpqr.cpqr(torch.from_numpy(a)))
    np.testing.assert_array_equal(p, pk)
    assert np.abs(q - qk).max() < 2e-2
    assert np.abs(r - rk).max() / np.abs(a).max() < 2e-3


@pytest.mark.parametrize("cplx", [True, False])
def test_rank_deficient(cplx):
    """Rank 5 of 12, and a zero column: finite factors, the identities,
    tau = 0 for the exhausted columns (a zero diagonal), no NaN."""
    rng = np.random.default_rng(11)
    m, k = 12, 5
    a = rand(rng, (4, m, k), cplx) @ rand(rng, (4, k, m), cplx)
    a[:, :, 3] = 0.0
    q, r, p = (x.numpy() for x in cpqr.cpqr(torch.from_numpy(a)))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    check_identities(a, q, r, p, 1e-12)
    d = np.abs(np.diagonal(r, axis1=-2, axis2=-1))
    assert (d[:, k:] < 1e-12 * d[:, :1]).all()
    z = np.zeros((2, m, m), dtype=a.dtype)
    q, r, p = (x.numpy() for x in cpqr.cpqr(torch.from_numpy(z)))
    np.testing.assert_array_equal(r, 0.0)
    np.testing.assert_array_equal(q, np.broadcast_to(np.eye(m), q.shape))


def test_unpermute_columns_exact():
    rng = np.random.default_rng(5)
    t = rand(rng, (3, 2, 7, 7), True)
    perm = np.stack([np.stack([rng.permutation(7) for _ in range(2)])
                     for _ in range(3)])
    out = cpqr.unpermute_columns(torch.from_numpy(t),
                                 torch.from_numpy(perm)).numpy()
    want = np.take_along_axis(t, np.argsort(perm, axis=-1)[..., None, :],
                              axis=-1)
    np.testing.assert_array_equal(out, want)
    jout = np.asarray(jcpqr.unpermute_columns(jnp.asarray(t),
                                              jnp.asarray(perm)))
    np.testing.assert_array_equal(out, jout)


def test_cpu_route_takes_plain_version():
    a = torch.from_numpy(rand(np.random.default_rng(1), (2, 3, 9, 9), True))
    before = cpqr_cuda.launches
    q, r, p = cpqr.cpqr(a)
    assert cpqr_cuda.launches == before
    assert not cpqr.uses_kernel(a)
    assert q.shape == a.shape and p.shape == (2, 3, 9)
    assert not cpqr.uses_kernel(a, pivot=False)
    # pivot=False keeps the column order.
    _, _, p0 = cpqr.cpqr(a, pivot=False)
    np.testing.assert_array_equal(p0.numpy(), np.broadcast_to(np.arange(9),
                                                              (2, 3, 9)))


def test_kernel_cap_by_type():
    """The cap is what one block's shared memory holds (227 KB): at least
    m = 128 in complex64 and m = 93 in complex128."""
    for dtype, want in ((torch.complex64, 165), (torch.float32, 165),
                        (torch.complex128, 115), (torch.float64, 115)):
        cap = cpqr_cuda.max_m(dtype)
        assert cap == want
        assert cpqr_cuda.smem_bytes(cap, dtype) <= cpqr_cuda.SMEM_MAX
        assert cpqr_cuda.smem_bytes(cap + 1, dtype) > cpqr_cuda.SMEM_MAX


def test_kernel_wrapper_refuses_other_devices():
    a = torch.empty((2, 9, 9), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        cpqr_cuda.cpqr_lanes(a)
    assert not cpqr.uses_kernel(a)


def cpqr_mirror(a, nb=cpqr_cuda.NB):
    """csrc/cpqr.cu's order of work, batched, in plain torch (complex)."""
    b, m, _ = a.shape
    bi = torch.arange(b)
    A = a.clone()
    perm = torch.arange(m).repeat(b, 1)
    tau = torch.zeros(b, m, dtype=a.real.dtype)
    nrm = (A.abs() ** 2).sum(-2)
    tiny = 1e-150 if a.dtype == torch.complex128 else 1e-30
    for k in range(m):
        best, idx = torch.max(nrm[:, k:], dim=-1)   # first maximum
        p = k + idx
        alpha = A[bi, k, p]
        anorm = torch.sqrt(best)
        aabs = alpha.abs()
        sg = torch.where(aabs > tiny, alpha / torch.where(aabs > tiny, aabs,
                                                          1.0), 1.0 + 0j)
        degen = anorm <= tiny
        beta = torch.where(degen, 0j, -sg * anorm)
        tk = torch.where(degen, 0.0, 1.0 + aabs / torch.where(degen, 1.0,
                                                               anorm))
        colk, colp = A[bi, :, k].clone(), A[bi, :, p].clone()
        A[bi, :, k], A[bi, :, p] = colp, colk
        pk, pp = perm[bi, k].clone(), perm[bi, p].clone()
        perm[bi, k], perm[bi, p] = pp, pk
        scale = torch.where(degen, 0j, 1.0 / (alpha - beta))
        v = torch.cat([torch.ones(b, 1, dtype=a.dtype),
                       A[:, k + 1:, k] * scale[:, None]], 1)
        A[:, k + 1:, k] = v[:, 1:]
        A[:, k, k] = beta
        tau[:, k] = tk
        w = tk[:, None] * torch.einsum("bi,bij->bj", v.conj(),
                                       A[:, k:, k + 1:])
        A[:, k:, k + 1:] -= v[:, :, None] * w[:, None, :]
        nrm[:, k + 1:] = (A[:, k + 1:, k + 1:].abs() ** 2).sum(-2)
    r = torch.triu(A)
    for pn in reversed(range(-(-m // nb))):
        k0 = pn * nb
        nbp, n = min(nb, m - k0), m - k0
        v = torch.zeros(b, n, nbp, dtype=a.dtype)
        for c in range(nbp):
            v[:, c, c] = 1
            v[:, c + 1:, c] = A[:, k0 + c + 1:, k0 + c]
        q = A[:, k0:, k0:].clone()
        q[:, :nbp, :] = 0
        q[:, :, :nbp] = 0
        q[:, range(nbp), range(nbp)] = 1
        g = v.conj().transpose(1, 2) @ v
        t = torch.zeros(b, nbp, nbp, dtype=a.dtype)
        for c in range(nbp):
            tc = tau[:, k0 + c].to(a.dtype)
            t[:, c, c] = tc
            t[:, :c, c] = -tc[:, None] * (
                t[:, :c, :c] @ g[:, :c, c:c + 1])[..., 0]
        A[:, k0:, k0:] = q - v @ (t @ (v.conj().transpose(1, 2) @ q))
    return A, r, perm


def test_mirror_form_q_panels_span_every_boundary():
    """The panel loop of csrc/cpqr.cu touches every column once: nb, its
    multiples and a ragged last panel."""
    nb = cpqr_cuda.NB
    for m in (1, nb - 1, nb, nb + 1, 2 * nb + 3, 93, cpqr_cuda.max_m(
            torch.complex64)):
        cols = [c for pn in reversed(range(-(-m // nb)))
                for c in range(pn * nb, min(pn * nb + nb, m))]
        assert sorted(cols) == list(range(m))


def _separated(rng, b, m):
    w = np.eye(m) + 0.05 / np.sqrt(m) * (rng.normal(size=(b, m, m))
                                         + 1j * rng.normal(size=(b, m, m)))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return np.ascontiguousarray((w * scale)[:, :, rng.permutation(m)])


@pytest.mark.parametrize("m", [1, 9, 16, 93, "cap"])
def test_mirror_matches_plain_f64(m):
    if m == "cap":
        m = cpqr_cuda.max_m(torch.complex128)
    a = torch.from_numpy(_separated(np.random.default_rng(m), 2, m))
    q, r, p = cpqr_mirror(a)
    qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(a)
    assert torch.equal(p, pp)
    scale = rp.abs().max().item()
    assert (q - qp).abs().max().item() <= 1e-12 * scale
    assert (r - rp).abs().max().item() <= 1e-12 * scale
    check_identities(a.numpy(), q.numpy(), r.numpy(), p.numpy(), 1e-12)


@pytest.mark.parametrize("m", [9, 16, 40])
def test_mirror_on_exact_ties(m):
    """Column norms that stay exactly equal at every step: 2 diag(u) with
    u in {1, -1, i, -i}, where every reflector and phase is exact in
    binary in both versions; every pivot is a tie, so the lowest index
    wins and perm is the identity."""
    u = np.array([1, -1, 1j, -1j])[np.random.default_rng(m).integers(
        0, 4, m)]
    cases = [2.0 * np.eye(m), 2.0 * np.diag(u)]
    a = torch.from_numpy(np.stack(cases).astype(np.complex128))
    q, r, p = cpqr_mirror(a)
    qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(a)
    assert torch.equal(p, torch.arange(m).expand(2, m))
    assert torch.equal(p, pp)
    scale = rp.abs().max().item()
    assert (q - qp).abs().max().item() <= 1e-12 * scale
    assert (r - rp).abs().max().item() <= 1e-12 * scale


@pytest.mark.parametrize("m", [9, 40, 93])
def test_mirror_rank_deficient(m):
    rng = np.random.default_rng(m + 7)
    k = 7
    a = (rand(rng, (3, m, k), True) @ rand(rng, (3, k, m), True))
    a[0, :, 2] = 0.0
    q, r, p = (x.numpy() for x in cpqr_mirror(torch.from_numpy(a)))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    check_identities(a, q, r, p, 1e-12)
    d = np.abs(np.diagonal(r, axis1=-2, axis2=-1))
    assert (d[:, k:] < 1e-12 * d[:, :1]).all()
