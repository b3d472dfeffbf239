"""The CUDA kernels on the card: kernel against plain version.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: complex64 |dRe logdet| <= 1e-4 n, dIm logdet <= 1e-4 n modulo
2 pi, |d out| <= 1e-4 max|out| (float32 elimination; the pivot order may
differ only on exact ties); complex128 the same with 1e-10. The block on
the card (kernels) and on the CPU (plain versions) with the same injected
draws agree at rtol 1e-8, atol 1e-10 in complex128.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu_torch.ops import batchla_cuda, greens_cuda

torch.set_num_threads(1)

SHAPES = [(9, 3), (16, 7), (36, 18), (64, 24)]
TOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}
DTYPES = list(TOL)


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
        batchla_cuda.inv_logdet_lanes(torch.ones(3, 2, 2, device="cuda"))


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
