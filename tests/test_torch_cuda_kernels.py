"""The CUDA kernels on the card: kernel against plain version.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: complex64/float32 |dRe logdet| <= 1e-4 n, dIm logdet <= 1e-4 n
modulo 2 pi, |d out| <= 1e-4 max|out| (float32 elimination; the pivot order
may differ only on exact ties); complex128/float64 the same with 1e-10. The
sweep's fields are identical. The blocks on the card (kernels) and on the
CPU (plain versions) with the same injected draws agree at rtol 1e-8,
atol 1e-10 in complex128. On ill-conditioned real input kernel B's inverse
is held, matrix by matrix, to max(tol, 2 n eps kappa) max|S^-1|, against
its plain version and against the float64 inverse. The Taylor kernel is
held to max|d| <= tol max|out|, the exchange kernel per walker against its
plain version in float64 to |d_w| <= tol S_w, S_w = sum_x sum_ij
|T_ij||T_ji| (exx sums X n^2 products that may cancel), with tol 5e-6 in
complex64 and 1e-13 in complex128 (the float32 plain version's long sums
err by up to ~1e-5 S_w on coherent inputs, the kernel's short ones by
~2e-7 S_w; a kernel that drops one of X Cholesky vectors misses by about
S_w / X on the coherent inputs, which the check must catch); a Generic
block on the card (both kernels)
and on the CPU with the same injected draws agree at rtol 1e-8 in
complex128. The pivoted QR kernel is held to the factorization identities
(||A[:, perm] - QR||_F / ||A||_F and max|Q^H Q - I| within 10 m eps of the
type, exact zeros below R's diagonal, |r_kk| non-increasing) on any input,
and on inputs with well-separated column norms (each pivot column's
dominant entry on the diagonal, where the LAPACK phase choice leaves Q well
determined) to its plain version elementwise (the same pivots; Q within
1e-4 / 1e-10, R within 1e-4 / 1e-10 of max|R|); in float32 on Gaussian
inputs with separated column norms (where that phase is ill-determined on
a few columns) against the plain version in double precision with the
kernel's pivots (R within 1e-4 of max|R|, Q within 1e-4 once each
column's phase is aligned; a phase error of 2^-8 reads ~4e-3 in R); kernel
B from n = 1 up to its cap, against its plain version, the augmented
Gauss-Jordan's and torch.linalg in float64 (TOL, times n for the
log-det); kernel B's route by shape at its cap; kernel A at its cap
(launches, TOL, W in {1, 100, 1024, 1031}, phi read from device memory)
and past it (no launch, the plain result); the cpqr kernel's two routes
on ragged batches (a matrix's factors do not depend on its neighbours);
the Taylor
kernel at M = 257 and at its cap, and the Generic propagator's route past
that cap (no launch, TOL against the plain series); the bf16 Taylor
kernel against its plain version (the same bf16 roundings, float32 sums
in another order) within 1e-3 max|out| at (M, C) in {(33, 14), (128, 32),
(257, 14), (cap, 14)}, and the plane-wave propagator's bf16 route past
its cap (no launch, the plain bf16 series); and a
thermal path on
the card and on the CPU with the same injected draws agree at rtol 1e-8
in complex128. The Cholesky kernel is checked on both of its routes and
their edges (n = 31, 32, 33) up to its cap with 1, 37, 1024 and 1031
matrices (TOL, times n for the log-det), and is blind to the strict upper
triangle of S; the Cholesky and sweep wrappers make no layout copy
(lanelinalg's to_lanes / from_lanes refused), and the sweep reads the
real parts of complex tensors in place. The zero-temperature run modes
(discrete back propagation and ITCF on the sweep kernel, unstable ITCF,
continuous back propagation with phase restoration and two splits,
continuous and discrete free projection, the direct update, the
momentum-space kinetic step, the local-energy update, Generic back
propagation with EKT and the full 2-RDM through the Taylor kernel) run two
blocks on the card and on the CPU with the same injected draws and agree
at rtol 1e-8, atol 1e-10 in complex128, with their kernels launched;
so do two paths of each finite-temperature path added with the low-rank
stack (the low-rank walkers, the discrete propagator's constrained path
and free projection, the Generic inner, the mean-field trial,
average_gf). The cpqr kernel on the low-rank stack's masked input (dead
rows and columns zeroed exactly) keeps the identities, gives exact zeros
on the dead columns' diagonal, and the low-rank G and log det(1 + A) on
the card agree with the plain versions on the CPU within TOL. The 3-pass
split GEMM of the 'bfloat16_3x' tier agrees with its plain version within
chip_smoke.gemm3_tolerance (12 k eps S) on chip_smoke.gemm3_cases, each
case launched on the route ops/gemm3_cuda.plan picks for it; under
that tier every float32 / complex64 product on the card launches it (the
route's result equal to the wrapper's bit for bit), a full_precision()
body and float64 products do not, and "float32" gives cuBLAS's products
back.
"""

import numpy as np
import pytest
import torch

from chip_smoke import gemm3_cases, gemm3_tolerance, pivot_cases
from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import (batchla_cuda, clinalg, cpqr_cuda,
                                 cuda_build, exx_cuda, gemm3_cuda,
                                 greens_cuda, sweep_cuda, taylor_cuda)

torch.set_num_threads(1)

SHAPES = [(9, 3), (16, 7), (36, 18), (64, 24)]
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10, torch.float32: 1e-4,
       torch.float64: 1e-10}
DTYPES = [torch.complex64, torch.complex128]
SWEEP_SHAPES = [(9, 3, 3), (16, 7, 7), (9, 4, 2), (36, 18, 18), (36, 17, 5),
                (36, 32, 32)]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def phase_diff(a):
    return np.abs(np.angle(np.exp(1j * np.asarray(a))))


def card_walkers(rng, m, n, w, dtype):
    psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    phi = psi[:, :, None] + 0.3 * (rng.normal(size=(m, n, w))
                                   + 1j * rng.normal(size=(m, n, w)))
    return (torch.from_numpy(psi).to("cuda", dtype),
            torch.from_numpy(phi).to("cuda", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(4, 1)] + SHAPES)
def test_greens_kernel_matches_plain(dtype, m, n):
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(m + n)
    for w in (1, 100, 1024, 1031):
        psi, phi = card_walkers(rng, m, n, w, dtype)
        for want_gh in (True, False):
            before = greens_cuda.launches
            ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
            assert greens_cuda.launches == before + 1
            ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)
            torch.cuda.synchronize()
            d = (ld_k - ld_p).cpu().numpy()
            assert np.abs(d.real).max() <= tol * n
            assert phase_diff(d.imag).max() <= tol * n
            if want_gh:
                assert gh_k.shape == (m, n, w)
                err = (gh_k - gh_p).abs().max().item()
                assert err <= tol * gh_p.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3, 7, 16, 18, 24, 42])
def test_inv_logdet_kernel_matches_plain(dtype, n):
    """Up to the Generic paths' n = 16 (1024 walkers) and n = 42 (256)."""
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(n)
    w = 256 if n == 42 else 1024
    s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * (
        rng.normal(size=(w, n, n)) + 1j * rng.normal(size=(w, n, n)))
    s[0] = np.eye(n)[::-1]                 # zero leading minors: pivoting
    s = torch.from_numpy(s).to("cuda", dtype)
    for want_inv in (True, False):
        ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
        ld_p, inv_p = batchla_cuda.inv_logdet_lanes_plain(s, want_inv)
        torch.cuda.synchronize()
        d = (ld_k - ld_p).cpu().numpy()
        assert np.abs(d.real).max() <= tol * n
        assert phase_diff(d.imag).max() <= tol * n
        if want_inv:
            err = (inv_k - inv_p).abs().max().item()
            assert err <= tol * inv_p.abs().max().item()
    sign = np.linalg.det(np.eye(n)[::-1])
    assert abs(np.exp(complex(ld_k[0].cpu())) - sign) < 1e-3


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back():
    need_cuda()
    psi = torch.ones(4, 2, dtype=torch.complex64, device="cuda")
    phi = torch.ones(4, 2, 3, dtype=torch.complex128, device="cuda")
    with pytest.raises(TypeError):
        greens_cuda.greens_lanes(psi, phi)
    with pytest.raises(ValueError):
        greens_cuda.greens_lanes(psi, phi.to(torch.complex64)
                                 .transpose(0, 1))
    with pytest.raises(TypeError):
        batchla_cuda.inv_logdet_lanes(torch.ones(3, 2, 2, device="cuda",
                                                 dtype=torch.float16))


def _small_block(device, noise=None, generator=None):
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.propagation.continuous import Continuous
    from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
    from pauxy_tpu_torch.qmc import hubbard_fast
    from pauxy_tpu_torch.walkers import init_walkers

    kw = dict(device=device, dtype="double")
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, **kw)
    trial = free_electron_trial(ham, **kw)
    prop = Continuous(inner=make_hubbard_continuous(ham, trial, 0.01, **kw),
                      dt=0.01)
    state = init_walkers(trial, 64)
    return hubbard_fast.run_block_lanes(
        ham, trial, prop, state, generator, 0.0, 0, nsteps=10, nstblz=5,
        npop_control=2, pop_method="comb", target_weight=64.0,
        energy_eval_freq=1, noise=noise)


@pytest.mark.cuda
def test_block_on_card_matches_plain_block_on_cpu():
    need_cuda()
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    rng = np.random.default_rng(1)
    xi = rng.normal(size=(10, 16, 64))
    pop = rng.uniform(size=(10, 1))

    def noise(device):
        return BlockNoise(torch.from_numpy(xi).to(device),
                          torch.from_numpy(pop).to(device))

    before = (greens_cuda.launches, batchla_cuda.launches)
    s_gpu, a_gpu = _small_block("cuda", noise("cuda"))
    assert (greens_cuda.launches - before[0],
            batchla_cuda.launches - before[1]) == (60, 2)
    s_cpu, a_cpu = _small_block("cpu", noise("cpu"))
    np.testing.assert_allclose(a_gpu.cpu().numpy()[0], a_cpu.numpy()[0],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s_gpu.weight.cpu().numpy(),
                               s_cpu.weight.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.cuda
def test_driver_on_card_goes_through_the_kernels():
    need_cuda()
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, device="cuda",
                       dtype="single")
    trial = free_electron_trial(ham, device="cuda", dtype="single")
    before = (greens_cuda.launches, batchla_cuda.launches)
    rows = AFQMC(ham, trial,
                 QMCOpts(nwalkers=128, dt=0.01, nsteps=10, nblocks=2,
                         rng_seed=3),
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cuda").run()
    assert np.isfinite(rows.real).all()
    assert (greens_cuda.launches - before[0],
            batchla_cuda.launches - before[1]) == (6 * 20, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 7, 18])
def test_inv_logdet_kernel_real_matches_plain(dtype, n):
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(n + 1)
    s = 2.0 * np.eye(n) + 0.3 / np.sqrt(n) * rng.normal(size=(1031, n, n))
    s[0] = np.eye(n)[::-1]
    s[1] = -np.eye(n)
    s = torch.from_numpy(s).to("cuda", dtype)
    for want_inv in (True, False):
        ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
        ld_p, inv_p = batchla_cuda.inv_logdet_lanes_plain(s, want_inv)
        torch.cuda.synchronize()
        d = (ld_k - ld_p).cpu().numpy()
        assert np.abs(d.real).max() <= tol * n
        assert phase_diff(d.imag).max() <= tol * n
        im = np.abs(ld_k.imag.cpu().numpy())
        assert np.all((im == 0) | (np.abs(im - np.pi) < 1e-6))
        if want_inv:
            assert inv_k.dtype == dtype
            err = (inv_k - inv_p).abs().max().item()
            assert err <= tol * inv_p.abs().max().item()


def per_matrix_scaled_err(a, b, s, tol):
    """Largest ratio, over the batch, of max|a_w - b_w| to its allowance
    max(tol, 2 n eps kappa(S_w)) max|b_w|: two stable inverses of S_w differ
    by about eps kappa(S_w) |S_w^-1| (kappa the 2-norm condition number)."""
    n = s.shape[-1]
    eps = torch.finfo(s.dtype).eps
    kappa = np.linalg.cond(s.cpu().double().numpy())
    err = (a - b).abs().amax((1, 2)).cpu().double().numpy()
    scale = b.abs().amax((1, 2)).cpu().double().numpy()
    return float((err / (np.maximum(tol, 2 * n * eps * kappa) * scale)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 18])
def test_inv_logdet_kernel_real_ill_conditioned(dtype, n):
    """2 I + 0.5 N puts eigenvalues near zero (condition numbers up to ~2e4
    at n = 18), as the sweep's real S = psi^T phi may have: the kernel
    matches the plain version and the float64 inverse within the error
    that conditioning allows, matrix by matrix."""
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(n + 1)
    s = 2.0 * np.eye(n) + 0.5 * rng.normal(size=(1031, n, n))
    s = torch.from_numpy(s).to("cuda", dtype)
    _, inv_k = batchla_cuda.inv_logdet_lanes(s)
    _, inv_p = batchla_cuda.inv_logdet_lanes_plain(s)
    truth = torch.linalg.inv(s.double()).to(dtype)
    torch.cuda.synchronize()
    assert per_matrix_scaled_err(inv_k, inv_p, s, tol) <= 1.0
    assert per_matrix_scaled_err(inv_k, truth, s, tol) <= 1.0


def hpd_card(seed, w, n, dtype):
    """w Hermitian positive-definite n x n matrices phi^H phi, phi [2n, n]
    Gaussian, made on the card in complex128."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    phi = torch.randn((w, 2 * n, n), dtype=torch.complex128, device="cuda",
                      generator=gen)
    return (phi.mH @ phi).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 7, 16, 24, 31, 32, 33, 42, 48, "cap"])
def test_chol_inv_kernel_matches_plain(dtype, n):
    """Both routes (a group of lanes a matrix up to n = 32, a block a
    matrix above) and their edges, up to the largest n the kernel launches,
    with 1, 37, 1024 and 1031 matrices (the Generic paths' shapes: n = 16
    with 1024, n = 42 with 256)."""
    need_cuda()
    tol = TOL[dtype]
    if n == "cap":
        n = batchla_cuda.chol_max_n(dtype)
    ws = (1, 37, 256, 1024, 1031) if n == 42 else (1, 37, 1024, 1031)
    for w in ws:
        s = hpd_card(n + w, w, n, dtype)
        before = batchla_cuda.chol_launches
        ld_k, l_k = batchla_cuda.chol_inv_lanes(s)
        assert batchla_cuda.chol_launches == before + 1
        ld_p, l_p = batchla_cuda.chol_inv_lanes_plain(s)
        torch.cuda.synchronize()
        assert (ld_k - ld_p).abs().max().item() <= tol * n
        assert (l_k - l_p).abs().max().item() <= tol * l_p.abs().max().item()
        assert torch.equal(l_k, torch.tril(l_k))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 42])
def test_chol_inv_kernel_reads_only_the_lower_triangle(n):
    """NaN above the diagonal of S leaves the kernel's result as it is."""
    need_cuda()
    s = hpd_card(n, 37, n, torch.complex64)
    poisoned = s.clone()
    iu = torch.triu_indices(n, n, 1, device="cuda")
    poisoned[:, iu[0], iu[1]] = float("nan")
    ld, linv = batchla_cuda.chol_inv_lanes(s)
    ld_n, linv_n = batchla_cuda.chol_inv_lanes(poisoned)
    assert torch.equal(ld, ld_n) and torch.equal(linv, linv_n)


def sweep_inputs(rng, m, na, nb, w, dtype):
    psia = np.linalg.qr(rng.normal(size=(m, na)))[0]
    psib = np.linalg.qr(rng.normal(size=(m, nb)))[0]
    phia = psia[None] + 0.1 * rng.normal(size=(w, m, na))
    phib = psib[None] + 0.1 * rng.normal(size=(w, m, nb))
    inva = np.linalg.inv(np.einsum("mi,wmj->wij", psia, phia))
    invb = np.linalg.inv(np.einsum("mi,wmj->wij", psib, phib))
    g = np.arccosh(np.exp(0.5 * 0.01 * 4.0))
    delta = np.exp(-0.02) * np.array([[np.exp(g), np.exp(-g)],
                                      [np.exp(-g), np.exp(g)]]) - 1.0
    weight = np.ones(w)
    weight[:: 7] = 0.0                       # dead walkers keep their rows
    args = (psia, psib, delta, np.ones(2), phia, phib, inva, invb,
            rng.uniform(size=(m, w)), weight)
    return [torch.from_numpy(a).to("cuda", dtype) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,na,nb", SWEEP_SHAPES)
def test_sweep_kernel_matches_plain(dtype, m, na, nb):
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(m + na + nb)
    for w in (1, 37, 1024, 1031):
        args = sweep_inputs(rng, m, na, nb, w, dtype)
        before = sweep_cuda.launches
        out_k = sweep_cuda.hirsch_sweep_real(*args)
        assert sweep_cuda.launches == before + 1
        out_p = sweep_cuda.hirsch_sweep_real_plain(*args)
        torch.cuda.synchronize()
        for k, p in zip(out_k[:4], out_p[:4]):
            assert k.shape == p.shape and k.dtype == p.dtype
            scale = max(p.abs().max().item(), 1.0)
            assert (k - p).abs().max().item() <= tol * scale
        assert torch.equal(out_k[4], out_p[4])


@pytest.mark.cuda
def test_chol_and_sweep_wrappers_make_no_layout_copies(monkeypatch):
    """On CUDA tensors the Cholesky and sweep wrappers launch on the
    walker-major tensors as they come: lanelinalg's to_lanes / from_lanes
    raise here, and the results still match the plain versions (computed
    before). The sweep also takes the real parts of complex tensors (the
    discrete path's views) in place."""
    need_cuda()
    from pauxy_tpu_torch.ops import lanelinalg

    rng = np.random.default_rng(11)
    chol_in = [hpd_card(3, 37, n, torch.complex64) for n in (7, 42)]
    chol_ref = [batchla_cuda.chol_inv_lanes_plain(s) for s in chol_in]
    args = sweep_inputs(rng, 16, 7, 5, 37, torch.float32)
    views = [torch.complex(a, torch.full_like(a, 3.0)).real for a in args]
    assert not views[4].is_contiguous()
    sweep_ref = sweep_cuda.hirsch_sweep_real_plain(*args)

    def refuse(*_):
        raise AssertionError("a layout copy on the CUDA branch")

    monkeypatch.setattr(lanelinalg, "to_lanes", refuse)
    monkeypatch.setattr(lanelinalg, "from_lanes", refuse)
    for s, (ld_p, l_p) in zip(chol_in, chol_ref):
        ld_k, l_k = batchla_cuda.chol_inv_lanes(s)
        assert (l_k - l_p).abs().max().item() <= 1e-4 * l_p.abs().max().item()
        assert (ld_k - ld_p).abs().max().item() <= 1e-4 * s.shape[-1]
    for inputs in (args, views):
        out = sweep_cuda.hirsch_sweep_real(*inputs)
        for k, p in zip(out[:4], sweep_ref[:4]):
            assert k.is_contiguous()
            assert (k - p).abs().max().item() <= 1e-4 * max(
                p.abs().max().item(), 1.0)
        assert torch.equal(out[4], sweep_ref[4])


@pytest.mark.cuda
def test_failed_launch_raises_instead_of_falling_back(monkeypatch):
    """A launch that returns a CUDA error raises in the wrapper, and neither
    the Hirsch "kernel" sweep nor CholeskyQR retries another route."""
    need_cuda()
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.ops import clinalg
    from pauxy_tpu_torch.propagation.hirsch import make_hirsch
    from pauxy_tpu_torch.walkers import init_walkers

    kw = dict(device="cuda", dtype="single")
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **kw)
    trial = free_electron_trial(ham, **kw)
    prop = make_hirsch(ham, trial, 0.01, **kw)
    assert prop.sweep_kernel == "kernel"
    state = init_walkers(trial, 8)

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700      # cudaErrorIllegalAddress

    monkeypatch.setattr(cuda_build, "library", lambda: FailingLibrary())
    before = (sweep_cuda.launches, batchla_cuda.launches,
              batchla_cuda.chol_launches)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        prop._site_sweep(trial, state, None, torch.rand(9, 8, device="cuda"))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        clinalg.cholesky_qr(state.phia)
    assert (sweep_cuda.launches, batchla_cuda.launches,
            batchla_cuda.chol_launches) == before


def _discrete_block(device, noise):
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.propagation.hirsch import make_hirsch
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.walkers import init_walkers

    kw = dict(device=device, dtype="double")
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, **kw)
    trial = free_electron_trial(ham, **kw)
    prop = make_hirsch(ham, trial, 0.01, **kw)
    assert prop.sweep_kernel == "kernel"
    return run_block(ham, trial, prop, init_walkers(trial, 64), None, 0.0, 0,
                     nsteps=10, nstblz=5, npop_control=1, pop_method="comb",
                     target_weight=64.0, energy_eval_freq=1, noise=noise)[:2]


@pytest.mark.cuda
def test_discrete_block_on_card_matches_plain_block_on_cpu():
    need_cuda()
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    rng = np.random.default_rng(5)
    rs = rng.uniform(size=(10, 16, 64))
    pop = rng.uniform(size=(10, 1))

    def noise(device):
        return BlockNoise(torch.from_numpy(rs).to(device),
                          torch.from_numpy(pop).to(device))

    before = (sweep_cuda.launches, batchla_cuda.launches,
              batchla_cuda.chol_launches, greens_cuda.launches)
    s_gpu, a_gpu = _discrete_block("cuda", noise("cuda"))
    after = (sweep_cuda.launches, batchla_cuda.launches,
             batchla_cuda.chol_launches, greens_cuda.launches)
    # 2 re-orthogonalisations x 2 spins x 2 passes; kernel B 2 at set-up
    # and 8 a step.
    assert tuple(a - b for a, b in zip(after, before)) == (10, 82, 8, 0)
    s_cpu, a_cpu = _discrete_block("cpu", noise("cpu"))
    np.testing.assert_allclose(a_gpu.cpu().numpy()[0], a_cpu.numpy()[0],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s_gpu.weight.cpu().numpy(),
                               s_cpu.weight.numpy(), rtol=1e-8, atol=1e-10)


# The Generic paths' shapes, the UEG bench class (M = 257, 7 + 7 columns)
# and each type's cap (taylor_cuda.max_m) with the same columns.
TAYLOR_SHAPES = [(16, 14), (128, 32), (228, 84), (257, 14), ("cap", 14)]
EXX_SHAPES = [(30, 3, 12), (512, 16, 128), (1024, 42, 228)]


def card_gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,ncol", TAYLOR_SHAPES)
def test_taylor_kernel_matches_plain(dtype, m, ncol):
    need_cuda()
    if m == "cap":
        m = taylor_cuda.max_m(dtype)
    gen = card_gen(m + ncol)
    for w in (1, 37, 1024):
        vhs = (0.3 / m ** 0.5) * torch.randn((w, m, m), generator=gen,
                                             dtype=dtype, device="cuda")
        phi = torch.randn((w, m, ncol), generator=gen, dtype=dtype,
                          device="cuda")
        before = taylor_cuda.launches
        out_k = taylor_cuda.apply_taylor(vhs, phi)
        assert taylor_cuda.launches == before + 1
        out_p = taylor_cuda.apply_taylor_plain(vhs, phi)
        torch.cuda.synchronize()
        assert out_k.shape == out_p.shape and out_k.dtype == dtype
        err = (out_k - out_p).abs().max().item()
        assert err <= TOL[dtype] * out_p.abs().max().item()


# The UEG golden and bench classes, the Generic bench class, the upper edge
# of each cluster size of the resident route at C = 14 (208: 1 CTA, 288: 2,
# 384: 4, 512: 8), just past its cap (513, streaming), a wider column part
# at the bench M, and the streaming route's cap.
BF16_SHAPES = [(33, 14), (128, 32), (257, 14), (208, 14), (288, 14),
               (384, 14), (512, 14), (513, 14), (257, 32), ("cap", 14)]


def bf16_launches():
    return (taylor_cuda.launches, taylor_cuda.launches_bf16,
            taylor_cuda.launches_bf16_resident,
            taylor_cuda.launches_bf16_streaming)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,ncol", BF16_SHAPES)
def test_taylor_bf16_kernel_matches_plain(dtype, m, ncol):
    need_cuda()
    if m == "cap":
        m = taylor_cuda.max_m_bf16()
    resident = taylor_cuda.route_bf16(m, ncol).route == "resident"
    gen = card_gen(3 * m + ncol)
    for w in (1, 37, 512 if m < 1000 else 16):
        vhs = (0.3 / m ** 0.5) * torch.randn((w, m, m), generator=gen,
                                             dtype=dtype, device="cuda")
        phi = torch.randn((w, m, ncol), generator=gen, dtype=dtype,
                          device="cuda")
        before = bf16_launches()
        out_k = taylor_cuda.apply_taylor(vhs, phi, lowp=True)
        assert bf16_launches() == (before[0], before[1] + 1,
                                   before[2] + resident,
                                   before[3] + (not resident))
        out_p = taylor_cuda.apply_taylor_plain(vhs, phi, lowp=True)
        torch.cuda.synchronize()
        assert out_k.shape == out_p.shape and out_k.dtype == dtype
        err = (out_k - out_p).abs().max().item()
        assert err <= 1e-3 * out_p.abs().max().item()
        del vhs, phi, out_k, out_p


@pytest.mark.cuda
@pytest.mark.parametrize("m,ncol", [(33, 14), (257, 14), (128, 32)])
def test_taylor_bf16_streaming_route_matches_plain(m, ncol):
    """The streaming kernel, forced at shapes the resident route takes,
    agrees with the plain version too (it remains the route past the
    resident cap)."""
    need_cuda()
    gen = card_gen(5 * m + ncol)
    for w in (1, 37, 512):
        vhs = (0.3 / m ** 0.5) * torch.randn(
            (w, m, m), generator=gen, dtype=torch.complex64, device="cuda")
        phi = torch.randn((w, m, ncol), generator=gen, dtype=torch.complex64,
                          device="cuda")
        before = bf16_launches()
        out_k = taylor_cuda._apply_taylor_bf16(vhs, phi, 6, route="streaming")
        assert bf16_launches() == (before[0], before[1] + 1, before[2],
                                   before[3] + 1)
        out_p = taylor_cuda.apply_taylor_plain(vhs, phi, lowp=True)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        assert err <= 1e-3 * out_p.abs().max().item()


@pytest.mark.cuda
def test_planewave_bf16_route_past_the_cap():
    """Past the bf16 kernel's cap the bf16 tier takes its plain series on
    the card, by shape, without a launch."""
    need_cuda()
    from pauxy_tpu_torch.propagation.generic import taylor_series
    m = taylor_cuda.max_m_bf16() + 1
    gen = card_gen(m)
    vhs = (0.3 / m ** 0.5) * torch.randn((2, m, m), generator=gen,
                                         dtype=torch.complex64, device="cuda")
    phi = torch.randn((2, m, 14), generator=gen, dtype=torch.complex64,
                      device="cuda")
    before = taylor_cuda.launches_bf16
    got = taylor_series(vhs, phi, 6, "pallas_bf16")
    assert taylor_cuda.launches_bf16 == before
    assert torch.equal(got, taylor_cuda.apply_taylor_plain(vhs, phi,
                                                           lowp=True))


EXX_TOL = {torch.complex64: 5e-6, torch.complex128: 1e-13}
# The phase-3 shapes, and two whose walker exceeds a block's shared memory
# (the kernel stages column chunks; n = 130 also takes the pair tiles in
# several rounds).
EXX_CARD_SHAPES = EXX_SHAPES + [(8, 60, 500), (4, 130, 200)]


def exx_card_inputs(gen, x, n, m, w, dtype, coherent):
    """Random phases (exx cancels: |exx_w| << S_w) or coherent ones (real
    positive rchol, Ghalf near real positive: |exx_w| ~ S_w)."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    rc = torch.randn((x, n, m), generator=gen, dtype=rdtype,
                     device="cuda") / m ** 0.5
    gh = torch.randn((w, n, m), generator=gen, dtype=dtype, device="cuda")
    if coherent:
        rc = rc.abs()
        gh = (gh.real.abs() + 0.1j * gh.imag).to(dtype)
    return rc, gh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x,n,m", EXX_CARD_SHAPES)
def test_exx_kernel_matches_plain(dtype, x, n, m):
    need_cuda()
    gen = card_gen(x + n + m)
    for coherent in (False, True):
        for w in (1, 37, 256):
            rc, gh = exx_card_inputs(gen, x, n, m, w, dtype, coherent)
            before = exx_cuda.launches
            out_k = exx_cuda.exx(rc, gh)
            assert exx_cuda.launches == before + 1
            out_p = exx_cuda.exx_plain(rc.double(), gh.to(torch.complex128))
            scale = exx_cuda.exx_magnitude(rc, gh)
            torch.cuda.synchronize()
            assert out_k.shape == (w,) and out_k.dtype == dtype
            err = (out_k - out_p).abs()
            assert bool((err <= EXX_TOL[dtype] * scale).all())
            # No atomics: the same bits on every launch.
            assert torch.equal(exx_cuda.exx(rc, gh), out_k)
            if coherent:
                # The criterion catches a kernel that drops one vector.
                drop = (exx_cuda.exx(rc[1:].contiguous(), gh) - out_p).abs()
                assert bool((drop.double() > EXX_TOL[dtype] * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_taylor_route_past_the_cap(dtype):
    """The Generic propagator's "pallas" route at M = cap + 1 launches
    nothing and gives the plain series."""
    need_cuda()
    from pauxy_tpu_torch.propagation.generic import GenericContinuous
    m = taylor_cuda.max_m(dtype) + 1
    gen = card_gen(m)
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    chol = 0.01 * torch.randn((m, m, 1), generator=gen, dtype=rdt,
                              device="cuda")
    prop = GenericContinuous(torch.zeros(2, m, m, dtype=dtype, device="cuda"),
                             torch.zeros(1, dtype=dtype, device="cuda"), chol,
                             dt=0.01, taylor_impl="pallas")
    phia = torch.randn((3, m, 7), generator=gen, dtype=dtype, device="cuda")
    phib = torch.randn((3, m, 7), generator=gen, dtype=dtype, device="cuda")
    x = torch.ones(3, 1, dtype=dtype, device="cuda")
    before = taylor_cuda.launches
    a, b = prop.apply_vhs(phia, phib, x)
    assert taylor_cuda.launches == before
    vhs = ((1j * 0.1) * chol[..., 0].to(dtype))[None].expand(3, m, m)
    want = taylor_cuda.apply_taylor_plain(vhs, torch.cat([phia, phib], -1))
    got = torch.cat([a, b], -1)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max(
    ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("want_gh", [True, False])
def test_greens_kernel_at_its_cap_and_route_past_it(dtype, want_gh):
    """Kernel A at n = max_n launches and matches its plain version; at
    max_n + 1 it launches nothing and gives the plain result."""
    need_cuda()
    cap = greens_cuda.max_n(dtype, want_gh)
    tol = TOL[dtype]
    rng = np.random.default_rng(cap)
    for n in (cap, cap + 1):
        psi, phi = card_walkers(rng, 4 * n, n, 37, dtype)
        before = greens_cuda.launches
        ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
        assert greens_cuda.launches == before + (1 if n == cap else 0)
        ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)
        torch.cuda.synchronize()
        d = (ld_k - ld_p).cpu().numpy()
        if n > cap:
            assert torch.equal(ld_k, ld_p)
            assert (gh_k is None) == (gh_p is None)
            if want_gh:
                assert torch.equal(gh_k, gh_p)
            continue
        assert np.abs(d.real).max() <= tol * n
        assert phase_diff(d.imag).max() <= tol * n
        if want_gh:
            err = (gh_k - gh_p).abs().max().item()
            assert err <= tol * gh_p.abs().max().item()


@pytest.mark.cuda
def test_generic_kernels_refuse_instead_of_falling_back(monkeypatch):
    need_cuda()
    c64 = torch.complex64
    vhs = torch.ones(2, 4, 4, dtype=c64, device="cuda")
    phi = torch.ones(2, 4, 3, dtype=c64, device="cuda")
    with pytest.raises(TypeError):
        taylor_cuda.apply_taylor(vhs, phi.to(torch.complex128))
    with pytest.raises(ValueError):
        taylor_cuda.apply_taylor(vhs.transpose(1, 2), phi)
    m = taylor_cuda.max_m(c64) + 1
    with pytest.raises(ValueError):
        taylor_cuda.apply_taylor(torch.ones(1, m, m, dtype=c64, device="cuda"),
                                 torch.ones(1, m, 2, dtype=c64, device="cuda"))
    rc = torch.ones(5, 3, 4, device="cuda")
    gh = torch.ones(2, 3, 4, dtype=c64, device="cuda")
    with pytest.raises(TypeError):
        exx_cuda.exx(rc.to(c64), gh)
    with pytest.raises(ValueError):
        exx_cuda.exx(rc, torch.ones(2, 3, 5, dtype=c64, device="cuda"))
    with pytest.raises(ValueError):
        exx_cuda.exx(rc, gh.transpose(1, 2).contiguous().transpose(1, 2))

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700      # cudaErrorIllegalAddress

    monkeypatch.setattr(cuda_build, "library", lambda: FailingLibrary())
    before = (taylor_cuda.launches, exx_cuda.launches)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        taylor_cuda.apply_taylor(vhs, phi)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        exx_cuda.exx(rc, gh)
    assert (taylor_cuda.launches, exx_cuda.launches) == before


def _generic_block(device, noise, cap):
    """10 steps of a small Generic system with the fused Taylor kernel and,
    past a lowered supermatrix cap, the exchange kernel."""
    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.models import trial as ttrial
    from pauxy_tpu_torch.propagation.continuous import Continuous
    from pauxy_tpu_torch.propagation.generic import make_generic_continuous
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.walkers import init_walkers

    rng = np.random.default_rng(7)
    chol = rng.normal(scale=0.05, size=(12, 12, 30))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.3, size=(12, 12))
    kw = dict(device=device, dtype="double")
    ham = make_generic((4, 3), 0.5 * (h1 + h1.T), chol, **kw)
    old = ttrial.EXX_SUPER_MAX_ELEMS
    ttrial.EXX_SUPER_MAX_ELEMS = cap
    try:
        trial = rhf_identity_trial(ham, **kw)
    finally:
        ttrial.EXX_SUPER_MAX_ELEMS = old
    prop = Continuous(inner=make_generic_continuous(
        ham, trial, 0.01, taylor_impl="pallas", **kw), dt=0.01)
    return run_block(ham, trial, prop, init_walkers(trial, 64), None, 0.0, 0,
                     nsteps=10, nstblz=5, npop_control=1, pop_method="comb",
                     target_weight=64.0, energy_eval_freq=1, noise=noise)[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [2 ** 26, 1])
def test_generic_block_on_card_matches_plain_block_on_cpu(cap):
    need_cuda()
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    rng = np.random.default_rng(9)
    xi = rng.normal(size=(10, 64, 30))
    pop = rng.uniform(size=(10, 1))

    def noise(device):
        return BlockNoise(torch.from_numpy(xi).to(device),
                          torch.from_numpy(pop).to(device))

    before = (taylor_cuda.launches, exx_cuda.launches, batchla_cuda.launches,
              batchla_cuda.chol_launches)
    s_gpu, a_gpu = _generic_block("cuda", noise("cuda"), cap)
    after = (taylor_cuda.launches, exx_cuda.launches, batchla_cuda.launches,
             batchla_cuda.chol_launches)
    # Taylor once a step; exx 2 per energy (every step) past the cap;
    # kernel B 2 at set-up and 6 a step; Cholesky 2 x 2 spins x 2 passes.
    want = (10, 0 if cap > 1 else 20, 62, 8)
    assert tuple(a - b for a, b in zip(after, before)) == want
    s_cpu, a_cpu = _generic_block("cpu", noise("cpu"), cap)
    np.testing.assert_allclose(a_gpu.cpu().numpy()[0], a_cpu.numpy()[0],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s_gpu.weight.cpu().numpy(),
                               s_cpu.weight.numpy(), rtol=1e-8, atol=1e-10)


CPQR_EPS = {torch.complex64: 2.0 ** -24, torch.float32: 2.0 ** -24,
            torch.complex128: 2.0 ** -53, torch.float64: 2.0 ** -53}


def cpqr_identities(a, q, r, perm):
    """(reconstruction ||A[:, perm] - QR||_F / ||A||_F per matrix, max
    |Q^H Q - I|, max |below the diagonal of R|, worst increase of |r_kk|
    over max |r_00|)."""
    b, m, _ = a.shape
    ap = torch.gather(a, 2, perm[:, None, :].expand(b, m, m))
    rec = (torch.linalg.matrix_norm(ap - q @ r)
           / torch.linalg.matrix_norm(a)).max().item()
    eye = torch.eye(m, dtype=q.dtype, device=q.device)
    orth = (q.conj().transpose(1, 2) @ q - eye).abs().max().item()
    low = torch.tril(r, -1).abs().max().item() if m > 1 else 0.0
    d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
    rise = ((d[:, 1:] - d[:, :-1]).clamp_min(0).amax(-1)
            / d[:, 0].clamp_min(1e-300)).max().item() if m > 1 else 0.0
    return rec, orth, low, rise


def separated(rng, b, m, cplx):
    """(W D)[:, shuffle]: W = I + 0.05 N / sqrt(m) (cond(W) ~ 1.1), D a
    geometric column scaling from 1 down to 1e-4, the columns then
    shuffled. Consecutive scales differ by 1e4^(1/(m-1)) (10% at m = 93),
    far more than W moves a column's residual norm (~0.3%), so the pivots
    are unambiguous; and the k-th pivot column's dominant entry sits in
    row k, so its x_k is not small against ||x||: the LAPACK phase choice
    beta = -(x_k/|x_k|) ||x|| makes Q as sensitive as x_k's phase, and
    only then are Q and R well determined in float32 (~1e-6 from float64
    at every m up to 162)."""
    w = np.eye(m) + 0.05 / np.sqrt(m) * rng.normal(size=(b, m, m))
    if cplx:
        w = w + 0.05j / np.sqrt(m) * rng.normal(size=(b, m, m))
    scale = 1e-4 ** (np.arange(m) / max(m - 1, 1))
    return (w * scale[None, None, :])[:, :, rng.permutation(m)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("m", [9, 16, 36, 48, 93, "cap"])
def test_cpqr_kernel_matches_plain(dtype, m):
    need_cuda()
    if m == "cap":
        m = cpqr_cuda.max_m(dtype)
    tol = TOL[dtype]
    allow = 10 * m * CPQR_EPS[dtype]
    rng = np.random.default_rng(m)
    cplx = dtype.is_complex
    for b in (1, 37, 512):
        a = rng.normal(size=(b, m, m))
        if cplx:
            a = a + 1j * rng.normal(size=(b, m, m))
        a[0, :, m // 2] = 0.0                      # a zero column
        a = torch.from_numpy(a).to("cuda", dtype)
        before = cpqr_cuda.launches
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        assert cpqr_cuda.launches == before + 1
        q2, r2, p2 = cpqr_cuda.cpqr_lanes(a)
        torch.cuda.synchronize()
        assert q.dtype == dtype and r.dtype == dtype
        assert torch.equal(q, q2) and torch.equal(r, r2) and torch.equal(p, p2)
        assert torch.isfinite(q).all() and torch.isfinite(r).all()
        rec, orth, low, rise = cpqr_identities(a, q, r, p)
        assert rec <= allow and orth <= allow and low == 0.0
        assert rise <= allow
        s = torch.from_numpy(separated(rng, b, m, cplx)).to("cuda", dtype)
        qk, rk, pk = cpqr_cuda.cpqr_lanes(s)
        qp, rp, pp = cpqr_cuda.cpqr_lanes_plain(s)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp)
        assert (qk - qp).abs().max().item() <= tol
        assert (rk - rp).abs().max().item() <= tol * rp.abs().max().item()
        if dtype in (torch.complex64, torch.float32):
            g = rng.normal(size=(b, m, m))
            if cplx:
                g = g + 1j * rng.normal(size=(b, m, m))
            scale = 1e-4 ** (np.arange(m) / (m - 1))
            g = torch.from_numpy((g * scale)[:, :, rng.permutation(m)]).to(
                "cuda", dtype)
            qk, rk, pk = cpqr_cuda.cpqr_lanes(g)
            gp = torch.gather(g, 2, pk[:, None, :].expand(b, m, m))
            wide = torch.complex128 if cplx else torch.float64
            q64, r64, _ = cpqr_cuda.cpqr_lanes_plain(gp.to(wide), pivot=False)
            qk, rk = qk.to(wide), rk.to(wide)
            rmax = r64.abs().amax((-2, -1), keepdim=True)
            assert ((rk - r64).abs() / rmax).max().item() <= tol
            d = (q64.conj() * qk).sum(-2)
            d = d / d.abs()
            assert (qk * d.conj()[:, None, :] - q64).abs().max().item() <= tol


@pytest.mark.cuda
def test_cpqr_rank_deficient_on_card():
    need_cuda()
    rng = np.random.default_rng(3)
    for dtype in (torch.complex64, torch.complex128):
        m, k = 40, 7
        a = (rng.normal(size=(5, m, k)) + 1j * rng.normal(size=(5, m, k))) @ (
            rng.normal(size=(5, k, m)))
        a = torch.from_numpy(a).to("cuda", dtype)
        q, r, p = cpqr_cuda.cpqr_lanes(a)
        z = torch.zeros(2, m, m, dtype=dtype, device="cuda")
        qz, rz, _ = cpqr_cuda.cpqr_lanes(z)
        torch.cuda.synchronize()
        assert torch.isfinite(q).all() and torch.isfinite(r).all()
        rec, orth, low, _ = cpqr_identities(a, q, r, p)
        allow = 10 * m * CPQR_EPS[dtype]
        assert rec <= allow and orth <= allow and low == 0.0
        d = torch.diagonal(r, dim1=-2, dim2=-1).abs()
        assert (d[:, k:] <= 100 * m * CPQR_EPS[dtype] * d[:, :1]).all()
        assert not rz.any()
        assert torch.equal(qz, torch.eye(m, dtype=dtype,
                                         device="cuda").expand(2, m, m))


@pytest.mark.cuda
def test_cpqr_refuses_instead_of_falling_back(monkeypatch):
    need_cuda()
    c64 = torch.complex64
    with pytest.raises(TypeError):
        cpqr_cuda.cpqr_lanes(torch.ones(2, 4, 4, dtype=torch.int32,
                                        device="cuda"))
    with pytest.raises(ValueError):
        cpqr_cuda.cpqr_lanes(torch.ones(4, 4, dtype=c64, device="cuda"))
    with pytest.raises(ValueError):
        cpqr_cuda.cpqr_lanes(torch.ones(2, 4, 5, dtype=c64, device="cuda"))
    m = cpqr_cuda.max_m(c64) + 1
    with pytest.raises(ValueError):
        cpqr_cuda.cpqr_lanes(torch.ones(1, m, m, dtype=c64, device="cuda"))

    class FailingLibrary:
        def __getattr__(self, name):
            return lambda *args: 700      # cudaErrorIllegalAddress

    monkeypatch.setattr(cuda_build, "library", lambda: FailingLibrary())
    before = cpqr_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cpqr_cuda.cpqr_lanes(torch.ones(2, 4, 4, dtype=c64, device="cuda"))
    assert cpqr_cuda.launches == before


@pytest.mark.cuda
def test_kernel_b_route_at_its_cap():
    """complex128 with the inverse: the thermal n = 93 and n = 120 (the
    cap) launch kernel B, n = 121 goes to torch.linalg by shape; all agree
    with torch.linalg."""
    need_cuda()
    c128 = torch.complex128
    cap = batchla_cuda.inv_max_n(c128)
    assert cap == 120
    rng = np.random.default_rng(4)
    for n, launched in ((93, 1), (cap, 1), (cap + 1, 0)):
        s = 2.0 * np.eye(n) + (rng.normal(size=(16, n, n))
                               + 1j * rng.normal(size=(16, n, n))) / n ** 0.5
        s = torch.from_numpy(s).to("cuda", c128)
        before = batchla_cuda.launches
        ld, inv = clinalg.inv_logdet(s)
        assert batchla_cuda.launches == before + launched
        sign, logabs = torch.linalg.slogdet(s)
        torch.cuda.synchronize()
        assert (ld.real - logabs).abs().max().item() <= 1e-10 * n
        assert (torch.exp(1j * ld.imag) - sign).abs().max().item() <= 1e-10
        want = torch.linalg.inv(s)
        assert ((inv - want).abs().max() / want.abs().max()).item() <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 5, 7, 32, 42, 64, 93, "cap"])
def test_kernel_b_matches_plain_and_linalg(dtype, n):
    """Kernel B from n = 1 up to its cap, w in {1, 37, 512}, both modes,
    with the pivot-needing matrices: the wrapper launches the kernel once,
    and it agrees with its plain version, with the augmented Gauss-Jordan
    of inv_logdet_lanes_plain (another elimination order) and with
    torch.linalg in float64 (TOL relative to max|S^-1|, TOL n for the
    log-det)."""
    need_cuda()
    if n == "cap":
        n = batchla_cuda.inv_max_n(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(n)
    for w in (1, 37, 512):
        s64 = torch.from_numpy(pivot_cases(rng, w, n, dtype.is_complex))
        s = s64.to("cuda", dtype)
        s64 = s.to(torch.complex128 if dtype.is_complex else torch.float64)
        sign, logabs = torch.linalg.slogdet(s64)
        want = torch.linalg.inv(s64)
        for want_inv in (True, False):
            before = batchla_cuda.launches
            ld_k, inv_k = batchla_cuda.inv_logdet_lanes(s, want_inv)
            assert batchla_cuda.launches == before + 1
            plains = [batchla_cuda.inv_logdet_plain(s, want_inv),
                      batchla_cuda.inv_logdet_lanes_plain(s, want_inv)]
            torch.cuda.synchronize()
            for ld_p, _ in plains:
                d = (ld_k - ld_p).cpu().numpy()
                assert np.abs(d.real).max() <= tol * n
                assert phase_diff(d.imag).max() <= tol * n
            ld64 = ld_k.to(torch.complex128)
            assert (ld64.real - logabs).abs().max().item() <= tol * n
            assert (torch.exp(1j * ld64.imag) - sign).abs().max().item() \
                <= tol * n
            if not dtype.is_complex:
                im = np.abs(ld_k.imag.cpu().numpy())
                assert np.all((im == 0) | (np.abs(im - np.pi) < 1e-6))
            if want_inv:
                assert inv_k.dtype == dtype and inv_k.shape == (w, n, n)
                for _, inv_p in plains:
                    scale = inv_p.abs().max().item()
                    assert (inv_k - inv_p).abs().max().item() <= tol * scale
                assert (inv_k.to(want.dtype) - want).abs().max().item() \
                    <= tol * want.abs().max().item()
            else:
                assert inv_k is None


def _thermal_path(system, device, noise):
    from pauxy_tpu_torch.models import make_hubbard
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    kw = dict(device=device, dtype="double")
    if system == "hubbard":
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **kw)
        beta, dt, mu = 0.5, 0.05, 0.9
    else:
        ham = make_ueg(1, 1, rs=1.0, ecut=1.0, **kw)
        beta, dt, mu = 0.25, 0.025, 0.245
    trial = make_one_body_trial(ham, beta, dt, mu=mu, stack_size=2, **kw)
    af = ThermalAFQMC(ham, trial, QMCOpts(nwalkers=8, dt=dt, nsteps=1,
                                          nblocks=1, beta=beta,
                                          npop_control=2), device=device)
    return af, af.run_block(noise(af, device))


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["hubbard", "ueg"])
def test_thermal_path_on_card_matches_cpu(system):
    """One path with injected draws, stack of 5 bins: the card (the cpqr
    kernel and kernel B) against the CPU (plain versions) in complex128,
    and the launches of the schedule."""
    need_cuda()
    from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise

    rng = np.random.default_rng(6)
    draws = {}

    def noise(af, device):
        if not draws:
            draws["xi"] = rng.normal(size=(af.ntime_slices, 8,
                                           af.prop.nfields))
            draws["pop"] = rng.uniform(size=(af.ntime_slices, 1))
        return PathNoise(torch.from_numpy(draws["xi"]).to(device),
                         torch.from_numpy(draws["pop"]).to(device))

    before = (cpqr_cuda.launches, batchla_cuda.launches)
    af, row_gpu = _thermal_path(system, "cuda", noise)
    after = (cpqr_cuda.launches, batchla_cuda.launches)
    nbins, ss = af.trial.nbins, af.trial.stack_size
    folds = sum(nbins - ts // ss + (ts % ss == 0 and ts >= ss)
                for ts in range(af.ntime_slices))
    # Two walker initialisations (the driver's and the reset after the
    # path), each nbins folds and 5 kernel B launches; 5 a slice.
    want = (2 * nbins + folds, 10 + 5 * af.ntime_slices)
    assert tuple(a - b for a, b in zip(after, before)) == want
    _, row_cpu = _thermal_path(system, "cpu", noise)
    np.testing.assert_allclose(row_gpu[:11], row_cpu[:11], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("want_gh", [True, False])
def test_greens_kernel_at_its_cap_over_walker_counts(dtype, want_gh):
    """Kernel A at n = max_n, where phi is read from device memory rather
    than staged, with W in {1, 100, 1024, 1031}: one launch each, TOL."""
    need_cuda()
    cap = greens_cuda.max_n(dtype, want_gh)
    assert not greens_cuda.plan(4 * cap, cap, dtype, want_gh).staged
    tol = TOL[dtype]
    rng = np.random.default_rng(cap + 1)
    for w in (1, 100, 1024, 1031):
        psi, phi = card_walkers(rng, 4 * cap, cap, w, dtype)
        before = greens_cuda.launches
        ld_k, gh_k = greens_cuda.greens_lanes(psi, phi, want_gh)
        assert greens_cuda.launches == before + 1
        ld_p, gh_p = greens_cuda.greens_lanes_plain(psi, phi, want_gh)
        torch.cuda.synchronize()
        d = (ld_k - ld_p).cpu().numpy()
        assert np.abs(d.real).max() <= tol * cap
        assert phase_diff(d.imag).max() <= tol * cap
        if want_gh:
            err = (gh_k - gh_p).abs().max().item()
            assert err <= tol * gh_p.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [9, 32, 33, 93])
def test_cpqr_routes_agree_across_ragged_batches(dtype, m):
    """Both launcher routes (a warp per matrix, four a block, up to m = 32;
    a block per matrix above) on B in {1, 3, 5, 37}, ragged for the warp
    route: each matrix's factors do not depend on its batch neighbours."""
    need_cuda()
    rng = np.random.default_rng(m + 3)
    a = rng.normal(size=(37, m, m)) + 1j * rng.normal(size=(37, m, m))
    a = torch.from_numpy(a).to("cuda", dtype)
    q, r, p = cpqr_cuda.cpqr_lanes(a)
    for b in (1, 3, 5):
        qb, rb, pb = cpqr_cuda.cpqr_lanes(a[-b:].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(qb, q[-b:]) and torch.equal(rb, r[-b:])
        assert torch.equal(pb, p[-b:])


# The zero-temperature run modes and estimators on the card: two blocks of
# 16 walkers with injected draws, complex128 on the card (kernels) and on
# the CPU (plain versions); (propagator options, estimator options, model,
# the kernels that must launch).
RUN_MODES = {
    "discrete_bp_itcf": (
        {"hubbard_stratonovich": "discrete"},
        {"back_propagation": {"tau_bp": 0.1, "evaluate_energy": True,
                              "restore_weights": "full"},
         "itcf": {"tau_max": 0.1, "stable": True}},
        "hubbard", ("hirsch_sweep", "chol_inv_lanes", "inv_logdet_lanes")),
    "discrete_itcf_unstable": (
        {"hubbard_stratonovich": "discrete"},
        {"itcf": {"tau_max": 0.1, "stable": False, "stack_size": 2}},
        "hubbard", ("hirsch_sweep", "chol_inv_lanes", "inv_logdet_lanes")),
    "continuous_bp_partial": (
        None, {"back_propagation": {"tau_bp": 0.1, "nsplit": 2,
                                    "restore_weights": "partial"}},
        "hubbard", ("chol_inv_lanes", "inv_logdet_lanes")),
    "continuous_free_projection": (
        {"free_projection": True}, None, "hubbard",
        ("chol_inv_lanes", "inv_logdet_lanes")),
    "discrete_free_projection": (
        {"hubbard_stratonovich": "discrete", "free_projection": True}, None,
        "hubbard", ("chol_inv_lanes", "inv_logdet_lanes")),
    "direct_update": (
        {"hubbard_stratonovich": "discrete", "single_site_update": False},
        None, "hubbard", ("chol_inv_lanes", "inv_logdet_lanes")),
    "kinetic_kspace": (
        {"hubbard_stratonovich": "discrete", "kinetic_kspace": True}, None,
        "hubbard", ("hirsch_sweep", "chol_inv_lanes", "inv_logdet_lanes")),
    "local_energy": ({"hybrid": False}, None, "hubbard",
                     ("chol_inv_lanes", "inv_logdet_lanes")),
    "generic_bp_ekt": (
        {"taylor_impl": "pallas"},
        {"back_propagation": {"tau_bp": 0.05, "evaluate_ekt": True,
                              "two_rdm": "full"}},
        "generic", ("taylor_exp", "chol_inv_lanes", "inv_logdet_lanes")),
}


def _run_mode_blocks(device, case, draws):
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_hubbard, rhf_identity_trial)
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    popts, eopts, model, _ = RUN_MODES[case]
    kw = dict(device=device, dtype="double")
    if model == "hubbard":
        ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, **kw)
        trial = free_electron_trial(ham, **kw)
    else:
        rng = np.random.default_rng(7)
        chol = rng.normal(scale=0.05, size=(10, 10, 24))
        chol = 0.5 * (chol + chol.transpose(1, 0, 2))
        h1 = rng.normal(scale=0.1, size=(10, 10))
        ham = make_generic((3, 3), 0.5 * (h1 + h1.T), chol, **kw)
        trial = rhf_identity_trial(ham, **kw)
    af = AFQMC(ham, trial, QMCOpts(nwalkers=16, dt=0.01, nsteps=10,
                                   nblocks=2, nstblz=5, npop_control=1),
               propagator_options=popts,
               estimator_options={"mixed": {"energy_eval_freq": 1},
                                  **(eopts or {})}, device=device)
    xi, pop = draws(af)
    state, out = af.state, []
    for b in range(2):
        steps = slice(10 * b, 10 * b + 10)
        noise = BlockNoise(torch.from_numpy(xi[steps]).to(device),
                           torch.from_numpy(pop[steps]).to(device))
        state, *accs = run_block(
            af.ham, af.trial, af.prop, state, None, float(trial.etrial),
            10 * b, nsteps=10, nstblz=5, npop_control=1, pop_method="comb",
            target_weight=16.0, energy_eval_freq=1,
            free_projection=af.free_projection, extras=af.extras,
            noise=noise)
        out.append([a.cpu().numpy() for a in accs] + [
            state.weight.cpu().numpy()])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_MODES))
def test_run_mode_blocks_on_card_match_cpu(case):
    need_cuda()
    rng = np.random.default_rng(11)
    _, _, model, kernels = RUN_MODES[case]

    def draws(af):
        m, nf = af.ham.nbasis, af.ham.nfields
        if af.free_projection and "discrete" in case:
            xi = (rng.uniform(size=(20, 16, m)) < 0.5).astype(float)
        elif "direct" in case:
            xi = rng.uniform(size=(20, 16, m))
        elif "discrete" in case or "kspace" in case:
            xi = rng.uniform(size=(20, m, 16))
        else:
            xi = rng.normal(size=(20, 16, nf))
        return xi, rng.uniform(size=(20, 1))

    state = rng.bit_generator.state
    counters = {"hirsch_sweep": (sweep_cuda, "launches"),
                "chol_inv_lanes": (batchla_cuda, "chol_launches"),
                "inv_logdet_lanes": (batchla_cuda, "launches"),
                "taylor_exp": (taylor_cuda, "launches")}
    before = {k: getattr(*counters[k]) for k in kernels}
    card = _run_mode_blocks("cuda", case, draws)
    torch.cuda.synchronize()
    assert all(getattr(*counters[k]) > before[k] for k in kernels)
    rng.bit_generator.state = state
    host = _run_mode_blocks("cpu", case, draws)
    for c, h in zip(card, host):
        for a, b in zip(c, h):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def _thermal_extra_paths(case, device, draws):
    """Two paths of the case's thermal configuration (8 walkers, complex128)
    with the draws of ``draws(af, path)``; their rows."""
    from pauxy_tpu_torch.models import (make_generic, make_hubbard,
                                        make_mean_field_trial)
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise, ThermalAFQMC

    kw = dict(device=device, dtype="double")
    beta, dt, options = 0.5, 0.05, {}
    if case == "low_rank":
        ham = make_ueg(1, 1, rs=1.0, ecut=1.0, **kw)
        trial = make_one_body_trial(ham, beta, dt, mu=0.245, stack_size=2,
                                    **kw)
        options["walker_options"] = {"low_rank": True}
    elif case == "generic":
        rng = np.random.default_rng(0)
        chol = 0.1 * rng.normal(size=(6, 6, 10))
        ham = make_generic((2, 2), np.diag(np.linspace(-1.0, 1.0, 6)),
                           chol + chol.transpose(1, 0, 2), **kw)
        trial = make_one_body_trial(ham, beta, dt, stack_size=2, **kw)
    else:
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **kw)
        if case == "mean_field":
            trial = make_mean_field_trial(ham, beta, dt, nav=6.0,
                                          stack_size=2, **kw)
            options["propagator_options"] = {"mu": 0.9}
        else:
            trial = make_one_body_trial(ham, beta, dt, mu=0.9, stack_size=2,
                                        **kw)
        if case.startswith("discrete"):
            options["propagator_options"] = {
                "hubbard_stratonovich": "discrete",
                "free_projection": case == "discrete_fp"}
        if case == "average_gf":
            options["estimator_options"] = {"mixed": {"average_gf": True}}
    af = ThermalAFQMC(ham, trial, QMCOpts(nwalkers=8, dt=dt, nsteps=1,
                                          nblocks=2, beta=beta,
                                          npop_control=2), device=device,
                      **options)
    rows = []
    for path in range(2):
        xi, pop = draws(af, path)
        rows.append(af.run_block(PathNoise(torch.from_numpy(xi).to(device),
                                           torch.from_numpy(pop).to(device))))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["low_rank", "discrete", "discrete_fp",
                                  "generic", "mean_field", "average_gf"])
def test_thermal_extra_paths_on_card_match_cpu(case):
    """The low-rank, discrete (constrained path and free projection),
    Generic, mean-field-trial and average_gf thermal paths: two paths with
    injected draws on the card (the cpqr kernel and kernel B launched) and
    on the CPU in complex128, rows at rtol 1e-8."""
    need_cuda()
    rng = np.random.default_rng(12)
    made = {}

    def draws(af, path):
        if path not in made:
            m, w, ns = af.ham.nbasis, 8, af.ntime_slices
            if case == "discrete_fp":
                xi = (rng.uniform(size=(ns, w, m)) < 0.5).astype(float)
            elif case == "discrete":
                xi = rng.uniform(size=(ns, m, w))
            else:
                xi = rng.normal(size=(ns, w, af.prop.nfields))
            made[path] = (xi, rng.uniform(size=(ns, 1)))
        return made[path]

    before = (cpqr_cuda.launches, batchla_cuda.launches)
    card = _thermal_extra_paths(case, "cuda", draws)
    torch.cuda.synchronize()
    assert cpqr_cuda.launches > before[0]
    assert batchla_cuda.launches > before[1]
    host = _thermal_extra_paths(case, "cpu", draws)
    for c, h in zip(card, host):
        np.testing.assert_allclose(c[:11], h[:11], rtol=1e-8, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dead_rows", [0, 10])
def test_cpqr_on_masked_input_matches_plain(dtype, dead_rows):
    """The low-rank stack's masked input (20 dead columns, dead_rows dead
    rows, zeroed exactly; ``chip_smoke.masked_core``) at (64, 93): the
    identities, R's diagonal exactly 0 on the dead columns and nonzero on
    the live ones, finite factors; and the low-rank combine's G and
    log det(1 + A) on the card against the plain versions on the CPU
    (TOL of max|G|, TOL m for the log-det)."""
    need_cuda()
    from chip_smoke import masked_core
    from pauxy_tpu_torch.walkers import low_rank

    tol, m, live = TOL[dtype], 93, 73
    allow = 10 * m * CPQR_EPS[dtype]
    a_np, mask_np = masked_core(np.random.default_rng(dead_rows), 64, m,
                                dead_rows, m - live)
    a = torch.from_numpy(a_np).to("cuda", dtype)
    before = cpqr_cuda.launches
    q, r, p = cpqr_cuda.cpqr_lanes(a)
    assert cpqr_cuda.launches == before + 1
    torch.cuda.synchronize()
    rec, orth, low, _ = cpqr_identities(a, q, r, p)
    assert rec <= allow and orth <= allow and low == 0.0
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    assert (d[:, live:] == 0).all() and (d[:, :live] != 0).all()
    eye = torch.eye(m, dtype=dtype).expand(64, m, m)
    mask = torch.from_numpy(mask_np)
    g_k, ld_k = low_rank._green_from_clcr(a, eye.cuda(), mask.cuda(), 1e-6)
    g_h, ld_h = low_rank._green_from_clcr(a.cpu(), eye, mask, 1e-6)
    g_k, ld_k = g_k.cpu(), ld_k.cpu()
    assert (g_k - g_h).abs().max().item() <= tol * g_h.abs().max().item()
    dld = (ld_k - ld_h).numpy()
    assert np.abs(dld.real).max() <= tol * m
    assert phase_diff(dld.imag).max() <= tol * m


@pytest.mark.cuda
def test_zero_pivot_log_dets_on_card():
    """Kernels A and B on exactly singular matrices: log|det| -inf with
    JAX's phase where JAX's is finite (``chip_smoke.check_zero_pivot``,
    phase 3's check), and a zero pivot eliminating nothing."""
    need_cuda()
    from chip_smoke import check_zero_pivot

    assert "singular" in check_zero_pivot(batchla_cuda, greens_cuda)


def _multi_det_af(case, device):
    """A 16-walker complex128 run of the case: NOMSD / PHMSD Generic, MSD
    Hubbard (continuous), GHF Hubbard (discrete), the mixed 1-RDM on
    Hubbard and the UEG's structure factor."""
    from chip_smoke import rotated_msd_psi, spin_flip_psi
    from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                        make_ghf_trial, make_hubbard,
                                        multi_slater_trial, phmsd_trial,
                                        rhf_identity_trial)
    from pauxy_tpu_torch.models.multi_slater import recompute_ci_coeffs
    from pauxy_tpu_torch.models.ueg import make_ueg
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    kw = dict(device=device, dtype="double")
    popts, mixed_opts = None, {"energy_eval_freq": 1}
    if case in ("nomsd_generic", "phmsd_generic"):
        h1e, chol, enuc, _ = generate_hamiltonian(8, (2, 2), seed=3)
        ham = make_generic((2, 2), h1e, chol, enuc, **kw)
        popts = {"taylor_impl": "pallas"}
        if case == "nomsd_generic":
            psi, coeffs = rotated_msd_psi(8, 2, 2, 4, seed=5)
            trial = multi_slater_trial(ham, psi, coeffs, **kw)
        else:
            occ = [(0, 1), (0, 2), (1, 2), (0, 3)]
            occa = [o for o in occ for _ in occ]
            occb = [o for _ in occ for o in occ]
            coeffs, _ = recompute_ci_coeffs(
                make_generic((2, 2), h1e, chol, enuc, device="cpu",
                             dtype="double"), occa=occa, occb=occb)
            trial = phmsd_trial(ham, coeffs, occa, occb, **kw)
    elif case == "sk_ueg":
        ham = make_ueg(2, 2, rs=1.0, ecut=1.0, **kw)
        trial = rhf_identity_trial(ham, **kw)
        mixed_opts.update(one_rdm=True, two_rdm="structure_factor")
    else:
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **kw)
        fe = free_electron_trial(ham, **kw)
        base = torch.cat([fe.psia, fe.psib], dim=1).cpu().numpy()
        if case == "msd_hubbard":
            flip = np.concatenate([base[:, 3:], base[:, :3]], axis=1)
            trial = multi_slater_trial(
                ham, np.stack([base, flip + 0.05]), np.array([0.9, 0.1]),
                **kw)
        elif case == "ghf":
            trial = make_ghf_trial(ham, spin_flip_psi(base[:, :3],
                                                      base[:, 3:]),
                                   np.array([0.8, 0.2]),
                                   init=(base[:, :3], base[:, 3:]), **kw)
            popts = {"hubbard_stratonovich": "discrete"}
        else:
            trial = fe
            mixed_opts["one_rdm"] = True
    return AFQMC(ham, trial, QMCOpts(nwalkers=16, dt=0.01, nsteps=10,
                                     nblocks=2, nstblz=5, npop_control=1),
                 propagator_options=popts,
                 estimator_options={"mixed": mixed_opts}, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nomsd_generic", "phmsd_generic",
                                  "msd_hubbard", "ghf", "rdm_hubbard",
                                  "sk_ueg"])
def test_multi_det_and_rdm_blocks_on_card_match_cpu(case):
    """Two blocks of each of this slice's paths on the card (kernels) and
    on the CPU (plain versions) with the same injected draws, complex128:
    the mixed sums (with their density-matrix tails) at rtol 1e-8, atol
    1e-10; kernel B launched (and the Taylor kernel on the
    Generic paths)."""
    need_cuda()
    from chip_smoke import extras_blocks
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

    rng = np.random.default_rng(13)
    out = {}
    for device in ("cuda", "cpu"):
        af = _multi_det_af(case, device)
        if case == "ghf":
            xi = rng.uniform(size=(20, af.ham.nbasis, 16))
        else:
            xi = rng.normal(size=(20, 16, af.ham.nfields))
        pop = rng.uniform(size=(20, 1))
        rng = np.random.default_rng(13)
        before = (batchla_cuda.launches, taylor_cuda.launches)
        blocks = extras_blocks(af, xi, pop, 2, run_block, BlockNoise)
        if device == "cuda":
            torch.cuda.synchronize()
            assert batchla_cuda.launches > before[0]
            assert (taylor_cuda.launches > before[1]) == ("generic" in case)
        out[device] = [b[0] for b in blocks]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


NEW_PATHS = ("hh_coherent", "hh_symmetric", "hh_multi_coherent",
             "generic_exact_eri", "generic_pno", "generic_sri",
             "generic_sri_cv", "generic_ri_step", "generic_xla_3m")


def _new_path_af(case, device):
    """A 16-walker complex128 run of the case: Hubbard-Holstein on the 3x2
    lattice (the coherent-state trial, with symmetric_trotter, or the
    multi-coherent one) or a Generic energy variant / the stochastic-RI
    step / taylor_impl="xla_3m" (taylor_impl="pallas" elsewhere)."""
    from pauxy_tpu_torch.models import make_generic, rhf_identity_trial
    from pauxy_tpu_torch.models.hubbard_holstein import (
        coherent_state_trial, make_hubbard_holstein)
    from pauxy_tpu_torch.models.multi_coherent import multi_coherent_trial
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    kw = dict(device=device, dtype="double")
    popts = {}
    if case.startswith("hh"):
        ham = make_hubbard_holstein(2, 2, U=4.0, nx=3, ny=2, lmbda=0.3, **kw)
        trial = (multi_coherent_trial if case == "hh_multi_coherent"
                 else coherent_state_trial)(ham, **kw)
        popts = {"symmetric_trotter": case == "hh_symmetric"}
    else:
        flags = {"generic_exact_eri": {"exact_eri": True},
                 "generic_pno": {"pno": True, "thresh_pno": 1e-8},
                 "generic_sri": {"stochastic_ri": True, "nsamples": 5},
                 "generic_sri_cv": {"stochastic_ri": True, "nsamples": 5,
                                    "control_variate": True}}.get(case, {})
        h1e, chol, enuc, _ = generate_hamiltonian(8, (2, 2), seed=3)
        ham = make_generic((2, 2), h1e, chol, enuc, **flags, **kw)
        trial = rhf_identity_trial(ham, **kw)
        popts = {"taylor_impl": "xla_3m" if case == "generic_xla_3m"
                 else "pallas",
                 "stochastic_ri": case == "generic_ri_step", "nsamples": 8}
    return AFQMC(ham, trial, QMCOpts(nwalkers=16, dt=0.01, nsteps=10,
                                     nblocks=2, nstblz=5, npop_control=1),
                 propagator_options=popts,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NEW_PATHS)
def test_hh_and_generic_variant_blocks_on_card_match_cpu(case):
    """Two blocks of each Hubbard-Holstein path and Generic variant on the
    card (kernels) and on the CPU (plain versions) with the same injected
    draws (the phonon start X0 too), complex128: the mixed sums at rtol
    1e-8, atol 1e-10; kernel B launched, the sweep kernel on the
    coherent-state paths, the Taylor kernel on the Generic ones but
    xla_3m."""
    need_cuda()
    from chip_smoke import hh_draws, extras_blocks
    from pauxy_tpu_torch.propagation.continuous import RIDraws
    from pauxy_tpu_torch.propagation.hirsch_dmc import DMCDraws
    from pauxy_tpu_torch.qmc.afqmc import run_block
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
    from pauxy_tpu_torch.walkers import init_walkers

    out = {}
    for device in ("cuda", "cpu"):
        rng = np.random.default_rng(29)
        af = _new_path_af(case, device)
        m, est = af.ham.nbasis, None
        if case.startswith("hh"):
            xi = hh_draws(rng, 20, 16, m, case == "hh_symmetric", DMCDraws)
            x0 = torch.from_numpy(rng.normal(size=(16, m))).to(device)
            af.state = init_walkers(af.trial, 16, total_weight=16.0,
                                    X0=af.trial.shift + x0 * (
                                        2.0 * af.ham.m * af.ham.w0) ** -0.5)
        else:
            fields = rng.normal(size=(20, 16, af.ham.nfields))
            xi = ([RIDraws(f, *(rng.choice([-1.0, 1.0], size=(m, 8))
                                for _ in range(2))) for f in fields]
                  if case == "generic_ri_step" else list(fields))
            if af.ham.stochastic_ri:
                est = rng.choice([-1.0, 1.0], size=(20, af.ham.nchol, 5))
        pop = rng.uniform(size=(20, 1))
        before = (batchla_cuda.launches, sweep_cuda.launches,
                  taylor_cuda.launches)
        blocks = extras_blocks(af, xi, pop, 2, run_block, BlockNoise, est)
        if device == "cuda":
            torch.cuda.synchronize()
            assert batchla_cuda.launches > before[0]
            assert (sweep_cuda.launches > before[1]) == (
                case in ("hh_coherent", "hh_symmetric"))
            assert (taylor_cuda.launches > before[2]) == (
                case.startswith("generic") and case != "generic_xla_3m")
        out[device] = [b[0] for b in blocks]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.cuda
def test_file_driven_generic_on_card_matches_cpu(tmp_path):
    """The Generic path from files (the port's QMCPACK and wavefunction
    writers, a JSON input, qmc/calc.setup_calculation) on the card and on
    the CPU in complex128, two blocks with the same injected draws through
    AFQMC.run_block: the rows at rtol 1e-8, atol 1e-10; the Taylor kernel
    and kernel B launched on the card."""
    need_cuda()
    from pauxy_tpu_torch.qmc.calc import setup_calculation
    from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
    from pauxy_tpu_torch.utils import qmcpack, wavefunction
    from pauxy_tpu_torch.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 2), seed=17)
    qmcpack.write_hamiltonian(h1e, chol, (3, 2), ecore=enuc,
                              filename=str(tmp_path / "afqmc.h5"))
    psi = np.linalg.qr(np.random.default_rng(4).normal(size=(8, 8)))[0]
    wavefunction.write_wavefunction(
        np.concatenate([psi[:, :3], psi[:, :2]], axis=1),
        str(tmp_path / "wfn.h5"))
    opts = {"system": {"name": "Generic",
                       "integrals": str(tmp_path / "afqmc.h5")},
            "qmc": {"nwalkers": 16, "dt": 0.01, "nsteps": 10, "blocks": 2,
                    "stabilise_freq": 5, "rng_seed": 3},
            "trial": {"name": "hartree_fock",
                      "filename": str(tmp_path / "wfn.h5")},
            "propagator": {"taylor_impl": "pallas"}, "verbosity": 0,
            "estimates": {"mixed": {"energy_eval_freq": 1}}}
    rng = np.random.default_rng(5)
    xi = rng.normal(size=(2, 10, 16, chol.shape[-1]))
    pop = rng.uniform(size=(2, 10, 1))
    rows = {}
    for device in ("cuda", "cpu"):
        opts["estimates"]["filename"] = str(tmp_path / f"{device}.h5")
        af = setup_calculation(opts, device=device, dtype="double")
        before = (batchla_cuda.launches, taylor_cuda.launches)
        rows[device] = [af.run_block(BlockNoise(
            torch.from_numpy(xi[b]).to(device),
            torch.from_numpy(pop[b]).to(device))) for b in range(2)]
        if device == "cuda":
            torch.cuda.synchronize()
            assert batchla_cuda.launches > before[0]
            assert taylor_cuda.launches == before[1] + 20
    for a, b in zip(rows["cuda"], rows["cpu"]):
        np.testing.assert_allclose(a[:10], b[:10], rtol=1e-8, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_split_gemm_matches_plain(dtype):
    need_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    for name, kern, plain, k, alpha, beta, c, a, b in gemm3_cases(gen,
                                                                   dtype):
        route = gemm3_cuda.plan(a, b).route
        before = gemm3_cuda.launches_by_route[route]
        got, want = kern(a, b), plain(a, b)
        tol = gemm3_tolerance(a, b, k, alpha, beta, c)
        assert bool(((got - want).abs().double() <= tol).all()), name
        assert got.numel() == 0 or \
            gemm3_cuda.launches_by_route[route] > before, (name, route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_split_route_on_card(dtype):
    need_cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    a = torch.randn(3, 64, 48, dtype=dtype, device="cuda", generator=gen)
    b = torch.randn(48, 32, dtype=dtype, device="cuda", generator=gen)
    d = a.to(torch.complex128 if dtype.is_complex else torch.float64)
    ieee = a[0] @ b
    try:
        config.set_matmul_precision("bfloat16_3x", "cuda")
        before = gemm3_cuda.launches
        got = a[0] @ b
        torch.einsum("wik,kj->wij", a, b)
        torch.addmm(b[0], a[0], b)
        torch.baddbmm(a[:, :, :32], a, b.expand(3, 48, 32))
        torch.cuda.synchronize()
        assert gemm3_cuda.launches == before + 4
        assert torch.equal(got, gemm3_cuda.mm(a[0], b))
        before = gemm3_cuda.launches
        with config.full_precision():
            assert torch.equal(a[0] @ b, ieee)
        d[0] @ d[0].T
        assert gemm3_cuda.launches == before
    finally:
        config.set_matmul_precision("float32", "cuda")
    assert not gemm3_cuda.route_installed()
    assert torch.equal(a[0] @ b, ieee)
