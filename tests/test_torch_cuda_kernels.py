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
B's route by shape at its cap; and a thermal path on
the card and on the CPU with the same injected draws agree at rtol 1e-8
in complex128.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu_torch.ops import (batchla_cuda, clinalg, cpqr_cuda,
                                 cuda_build, exx_cuda, greens_cuda,
                                 sweep_cuda, taylor_cuda)

torch.set_num_threads(1)

SHAPES = [(9, 3), (16, 7), (36, 18), (64, 24)]
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10, torch.float32: 1e-4,
       torch.float64: 1e-10}
DTYPES = [torch.complex64, torch.complex128]
SWEEP_SHAPES = [(9, 3, 3), (16, 7, 7), (9, 4, 2), (36, 18, 18)]


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
@pytest.mark.parametrize("m,n", SHAPES)
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


def hpd(rng, w, n):
    phi = rng.normal(size=(w, 2 * n, n)) + 1j * rng.normal(size=(w, 2 * n, n))
    return np.conj(np.swapaxes(phi, 1, 2)) @ phi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 7, 16, 24, 42, 48, "cap"])
def test_chol_inv_kernel_matches_plain(dtype, n):
    """Up to the largest n the kernel launches (one walker per block), and
    at the Generic paths' shapes (n = 16, 1024 walkers; n = 42, 256)."""
    need_cuda()
    tol = TOL[dtype]
    if n == "cap":
        n = batchla_cuda.chol_max_n(dtype)
    rng = np.random.default_rng(n + 2)
    ws = {16: (1, 1024), 42: (1, 256)}.get(n, (1, 37 if n > 48 else 1031))
    for w in ws:
        s = torch.from_numpy(hpd(rng, w, n)).to("cuda", dtype)
        before = batchla_cuda.chol_launches
        ld_k, l_k = batchla_cuda.chol_inv_lanes(s)
        assert batchla_cuda.chol_launches == before + 1
        ld_p, l_p = batchla_cuda.chol_inv_lanes_plain(s)
        torch.cuda.synchronize()
        assert (ld_k - ld_p).abs().max().item() <= tol * n
        assert (l_k - l_p).abs().max().item() <= tol * l_p.abs().max().item()


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
                     target_weight=64.0, energy_eval_freq=1, noise=noise)


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


TAYLOR_SHAPES = [(16, 14), (128, 32), (228, 84)]
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
def test_generic_kernels_refuse_instead_of_falling_back(monkeypatch):
    need_cuda()
    c64 = torch.complex64
    vhs = torch.ones(2, 4, 4, dtype=c64, device="cuda")
    phi = torch.ones(2, 4, 3, dtype=c64, device="cuda")
    with pytest.raises(TypeError):
        taylor_cuda.apply_taylor(vhs, phi.to(torch.complex128))
    with pytest.raises(ValueError):
        taylor_cuda.apply_taylor(vhs.transpose(1, 2), phi)
    m = taylor_cuda.MAX_M + 1
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
                     target_weight=64.0, energy_eval_freq=1, noise=noise)


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
    for b in ((1, 37) if m > 93 else (1, 37, 512)):
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
    """complex128 with the inverse: n = 85 (the cap) launches kernel B, n =
    86 and the thermal n = 93 go to torch.linalg by shape; both agree with
    torch.linalg."""
    need_cuda()
    c128 = torch.complex128
    cap = batchla_cuda.inv_max_n(c128, True)
    assert cap == 85
    rng = np.random.default_rng(4)
    for n, launched in ((cap, 1), (cap + 1, 0), (93, 0)):
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
