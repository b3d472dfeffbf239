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
its plain version and against the float64 inverse.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu_torch.ops import (batchla_cuda, cuda_build, greens_cuda,
                                 sweep_cuda)

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
@pytest.mark.parametrize("n", [2, 3, 7, 18, 24])
def test_inv_logdet_kernel_matches_plain(dtype, n):
    need_cuda()
    tol = TOL[dtype]
    rng = np.random.default_rng(n)
    w = 1024
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
@pytest.mark.parametrize("n", [1, 3, 7, 16, 24, 48, "cap"])
def test_chol_inv_kernel_matches_plain(dtype, n):
    """Up to the largest n the kernel launches (one walker per block)."""
    need_cuda()
    tol = TOL[dtype]
    if n == "cap":
        n = batchla_cuda.chol_max_n(dtype)
    rng = np.random.default_rng(n + 2)
    for w in (1, 37 if n > 48 else 1031):
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
