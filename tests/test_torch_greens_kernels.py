"""Port parity for the two kernels' plain versions, and kernel vs plain.

Kernel A (ops/greens_cuda.greens_lanes) and kernel B
(ops/batchla_cuda.inv_logdet_lanes) run their plain PyTorch versions on
CPU tensors; those are checked here against the JAX package:
  * A against greens_lanes_pallas in interpret mode, float32: 1e-3
    absolute (the bound of tests/test_hubbard_fast.py's kernel test);
  * A against hubbard_fast._greens_lanes(impl='xla'), float64: 1e-10;
  * B against batchla_pallas.inv_logdet_lanes in interpret mode (float32
    inside the kernel): 1e-4 relative, plus numpy at 1e-10 in float64.
Log-determinant imaginary parts are compared modulo 2 pi.

``greens_mirror`` follows csrc/greens.cu's order of work in plain torch: the
lanes of ``greens_cuda.plan`` per walker, lane g owning rows g, g + lanes,
...; each lane's best pivot candidate (the first of its rows with the
largest |S_ik|^2), then a butterfly over the lanes that keeps the lower
index on ties; the elimination with the pivot row as it stands, the pivot
row normalised after it (LU below the pivot without the Green's function).
It is held to greens_lanes_plain in float64 at 1e-12 of the scale, at
n in {1, 7, cap} and on exact ties in |S_ik|.

The kernels themselves are compared with these plain versions on the card
in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.ops.batchla_pallas import inv_logdet_lanes as jax_inv_logdet
from pauxy_tpu.ops.greens_pallas import greens_lanes_pallas
from pauxy_tpu.qmc import hubbard_fast as jhf
from pauxy_tpu_torch.ops import batchla_cuda, greens_cuda

torch.set_num_threads(1)

SHAPES = [(9, 3), (16, 7), (36, 18), (64, 24)]

# Jitted once: eager op-by-op dispatch of the unrolled JAX code is slow.
j_greens_lanes = jax.jit(jhf._greens_lanes, static_argnums=2)
j_log_overlap_lanes = jax.jit(jhf._log_overlap_lanes, static_argnums=2)


def walkers(rng, m, n, w, dtype):
    """Well-conditioned inputs: phi = psi + 0.3 noise."""
    psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    noise = rng.normal(size=(m, n, w)) + 1j * rng.normal(size=(m, n, w))
    return psi.astype(dtype), (psi[:, :, None] + 0.3 * noise).astype(dtype)


def phase_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a) - np.asarray(b)))))


@pytest.mark.parametrize("m,n,w", [(m, n, 8) for m, n in SHAPES]
                         + [(9, 3, 131), (16, 7, 131)])
def test_greens_plain_matches_pallas_interpret_f32(m, n, w):
    rng = np.random.default_rng(m * 10 + n + w)
    psi, phi = walkers(rng, m, n, w, np.complex64)
    ld_j, gh_j = greens_lanes_pallas(jnp.asarray(psi), jnp.asarray(phi),
                                     interpret=True)
    ld_t, gh_t = greens_cuda.greens_lanes(torch.from_numpy(psi),
                                          torch.from_numpy(phi))
    assert gh_t.shape == (m, n, w) and gh_t.dtype == torch.complex64
    assert np.abs(ld_t.numpy().real - np.asarray(ld_j).real).max() < 1e-3
    assert phase_diff(ld_t.numpy().imag, np.asarray(ld_j).imag).max() < 1e-3
    assert np.abs(gh_t.numpy() - np.asarray(gh_j)).max() < 1e-3
    ld_only, none = greens_cuda.greens_lanes(torch.from_numpy(psi),
                                             torch.from_numpy(phi),
                                             want_gh=False)
    assert none is None
    assert np.abs(ld_only.numpy().real - np.asarray(ld_j).real).max() < 1e-3


@pytest.mark.parametrize("m,n", SHAPES[:3])
def test_greens_plain_matches_xla_lanes_f64(m, n):
    rng = np.random.default_rng(m + n)
    psi, phi = walkers(rng, m, n, 12, np.complex128)
    ld_j, gh_j, diag_j = j_greens_lanes(jnp.asarray(psi),
                                           jnp.asarray(phi), "xla")
    ld_t, gh_t = greens_cuda.greens_lanes(torch.from_numpy(psi),
                                          torch.from_numpy(phi))
    np.testing.assert_allclose(ld_t.numpy().real, np.asarray(ld_j).real,
                               rtol=0, atol=1e-10)
    assert phase_diff(ld_t.numpy().imag, np.asarray(ld_j).imag).max() < 1e-10
    gh_j = np.asarray(gh_j)
    assert np.abs(gh_t.numpy() - gh_j).max() <= 1e-10 * np.abs(gh_j).max()
    ld2_j = j_log_overlap_lanes(jnp.asarray(psi), jnp.asarray(phi), "xla")
    ld2_t, _ = greens_cuda.greens_lanes(torch.from_numpy(psi),
                                        torch.from_numpy(phi), want_gh=False)
    np.testing.assert_allclose(ld2_t.numpy().real, np.asarray(ld2_j).real,
                               rtol=0, atol=1e-10)
    assert phase_diff(ld2_t.numpy().imag,
                      np.asarray(ld2_j).imag).max() < 1e-10


@pytest.mark.parametrize("n,w", [(3, 5), (7, 24), (18, 9), (24, 7)])
def test_inv_logdet_plain_matches_pallas_interpret(n, w):
    rng = np.random.default_rng(n + w)
    s = rng.normal(size=(w, n, n)) + 1j * rng.normal(size=(w, n, n))
    s = (s + 2 * np.eye(n)).astype(np.complex64)
    ld_j, inv_j = jax_inv_logdet(jnp.asarray(s), interpret=True)
    ld_t, inv_t = batchla_cuda.inv_logdet_lanes(torch.from_numpy(s))
    assert inv_t.shape == (w, n, n)
    scale = np.abs(np.asarray(ld_j).real).max() + 1.0
    assert np.abs(ld_t.numpy().real - np.asarray(ld_j).real).max() < 1e-4 * n * scale
    assert phase_diff(ld_t.numpy().imag, np.asarray(ld_j).imag).max() < 1e-4 * n
    inv_j = np.asarray(inv_j)
    assert np.abs(inv_t.numpy() - inv_j).max() < 1e-4 * np.abs(inv_j).max()
    # float64 plain version against numpy.
    s64 = s.astype(np.complex128)
    ld64, inv64 = batchla_cuda.inv_logdet_lanes(torch.from_numpy(s64))
    sign, la = np.linalg.slogdet(s64)
    np.testing.assert_allclose(ld64.numpy().real, la, rtol=1e-10)
    np.testing.assert_allclose(np.exp(1j * ld64.numpy().imag), sign,
                               atol=1e-10)
    np.testing.assert_allclose(inv64.numpy(), np.linalg.inv(s64), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(
        batchla_cuda.slogdet_lanes(torch.from_numpy(s64.reshape(1, w, n, n))
                                   ).numpy()[0].real, la, rtol=1e-10)


def test_inv_logdet_plain_needs_pivoting():
    """Zero leading principal minor: right only with row pivoting."""
    s = np.zeros((1, 2, 2), np.complex64)
    s[0] = [[0.0, 1.0], [1.0, 0.0]]
    ld_j, inv_j = jax_inv_logdet(jnp.asarray(s), interpret=True)
    ld_t, inv_t = batchla_cuda.inv_logdet_lanes(torch.from_numpy(s))
    np.testing.assert_allclose(np.exp(complex(ld_t[0])), -1.0, atol=1e-6)
    np.testing.assert_allclose(np.exp(complex(ld_t[0])),
                               np.exp(complex(ld_j[0])), atol=1e-6)
    np.testing.assert_allclose(inv_t.numpy()[0], s[0], atol=1e-6)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), atol=1e-6)


def test_wrappers_reject_other_devices_and_count_no_cpu_launch():
    psi = torch.zeros(4, 2, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        greens_cuda.greens_lanes(psi, psi[:, :, None])
    with pytest.raises(ValueError):
        batchla_cuda.inv_logdet_lanes(torch.zeros(3, 2, 2, device="meta",
                                                  dtype=torch.complex64))
    before = (greens_cuda.launches, batchla_cuda.launches)
    rng = np.random.default_rng(0)
    psi, phi = walkers(rng, 9, 3, 4, np.complex128)
    greens_cuda.greens_lanes(torch.from_numpy(psi), torch.from_numpy(phi))
    batchla_cuda.inv_logdet_lanes(torch.from_numpy(phi[:3].T.copy()))
    assert (greens_cuda.launches, batchla_cuda.launches) == before


def greens_mirror(psi, phi, want_gh=True):
    """csrc/greens.cu's order of work, batched over walkers, plain torch."""
    m, n, w = phi.shape
    lanes = greens_cuda.plan(m, n, phi.dtype, want_gh).lanes
    s = torch.einsum("miw,mj->wij", phi, psi.conj())
    aug = torch.cat([s, torch.eye(n, dtype=s.dtype).expand(w, n, n)], 2) \
        if want_gh else s.clone()
    wi = torch.arange(w)
    ldr = torch.zeros(w, dtype=phi.real.dtype)
    ph = torch.ones(w, dtype=phi.dtype)
    for k in range(n):
        mag = aug[:, :, k].abs() ** 2
        best = torch.full((w, lanes), -1.0, dtype=mag.dtype)
        idx = torch.full((w, lanes), n)
        for g in range(lanes):
            for i in range(g, n, lanes):
                if i < k:
                    continue
                better = mag[:, i] > best[:, g]
                best[:, g] = torch.where(better, mag[:, i], best[:, g])
                idx[:, g] = torch.where(better, i, idx[:, g])
        off = lanes // 2
        while off:
            partner = torch.arange(lanes) ^ off
            ob, oi = best[:, partner], idx[:, partner]
            take = (ob > best) | ((ob == best) & (oi < idx))
            best, idx = torch.where(take, ob, best), torch.where(take, oi, idx)
            off //= 2
        assert bool((idx == idx[:, :1]).all())
        piv = idx[:, 0]
        rk, rp = aug[wi, k].clone(), aug[wi, piv].clone()
        aug[wi, piv], aug[wi, k] = rk, rp
        ph = torch.where(piv != k, -ph, ph)
        p = aug[:, k, k]
        ldr = ldr + 0.5 * torch.log(p.abs() ** 2)
        ph = ph * (p / p.abs())
        f = aug[:, :, k] / p[:, None]
        rows = torch.arange(n) > k if not want_gh else torch.arange(n) != k
        f = torch.where(rows[None, :], f, torch.zeros_like(f))
        aug = aug - f[:, :, None] * aug[:, k:k + 1, :]
        if want_gh:
            aug[:, k] = aug[:, k] / p[:, None]
    logdet = ldr + 1j * torch.angle(ph)
    if not want_gh:
        return logdet, None
    return logdet, torch.einsum("wij,mjw->miw", aug[:, :, n:], phi)


@pytest.mark.parametrize("want_gh", [True, False])
@pytest.mark.parametrize("n", [1, 7, "cap"])
def test_greens_mirror_matches_plain_f64(n, want_gh):
    dt = torch.complex128
    if n == "cap":
        n = greens_cuda.max_n(dt, want_gh)
    m, w = max(2 * n, 4), 3
    psi, phi = walkers(np.random.default_rng(n), m, n, w, np.complex128)
    psi, phi = torch.from_numpy(psi), torch.from_numpy(phi)
    ld, gh = greens_mirror(psi, phi, want_gh)
    ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)
    scale = ld_p.real.abs().max().item() + 1.0
    assert (ld.real - ld_p.real).abs().max().item() <= 1e-12 * scale
    assert phase_diff(ld.imag.numpy(), ld_p.imag.numpy()).max() <= 1e-12 * n
    if want_gh:
        scale = gh_p.abs().max().item()
        assert (gh - gh_p).abs().max().item() <= 1e-12 * scale


@pytest.mark.parametrize("want_gh", [True, False])
def test_greens_mirror_on_exact_ties(want_gh):
    """|S_ik| tied exactly down every column (S = phi^T conj(psi) with psi
    the identity and phi a +-1 Hadamard block, times a unit phase per
    walker): both pick the lowest row, and agree to 1e-12."""
    n, w = 8, 4
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    psi = np.eye(n, dtype=np.complex128)
    phase = np.exp(1j * np.arange(w))
    phi = np.ascontiguousarray(h[:, :, None] * phase[None, None, :])
    psi, phi = torch.from_numpy(psi), torch.from_numpy(phi)
    ld, gh = greens_mirror(psi, phi, want_gh)
    ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)
    assert (ld.real - ld_p.real).abs().max().item() <= 1e-12 * n
    assert phase_diff(ld.imag.numpy(), ld_p.imag.numpy()).max() <= 1e-12 * n
    if want_gh:
        scale = gh_p.abs().max().item()
        assert (gh - gh_p).abs().max().item() <= 1e-12 * scale
