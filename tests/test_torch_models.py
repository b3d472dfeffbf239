"""Port parity: Hubbard model, trials and the continuous propagator.

The port's constructors run on the CPU in double precision against the JAX
package's (x64), and the JAX objects are also carried across with
pauxy_tpu_torch.utils.convert. Tolerance 1e-10 (the host-side numpy/scipy
setup is the same code on both sides).
"""

import os

import numpy as np
import pytest
import torch

from pauxy_tpu.models import hubbard as jhub
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import hubbard as thub
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.propagation.hubbard import make_hubbard_continuous
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "hubbard4x4_uhf_continuous.npz")
CPU = dict(device="cpu", dtype="double")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kw", [
    dict(nup=7, ndown=7, U=4.0, nx=4, ny=4),
    dict(nup=3, ndown=3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02]),
    dict(nup=2, ndown=1, U=2.0, nx=6, ny=1, symmetric=True),
    dict(nup=2, ndown=2, U=8.0, nx=2, ny=4, xpbc=False),
])
def test_make_hubbard_matches_jax(kw):
    jh = jhub.make_hubbard(**kw)
    th = thub.make_hubbard(**kw, **CPU)
    close(th.T.numpy(), jh.T)
    close(th.h1e_mod.numpy(), jh.h1e_mod)
    close(th.eks.numpy(), jh.eks)
    assert th.T.dtype == (torch.complex128 if "ktwist" in kw
                          else torch.float64)
    assert (th.nbasis, th.nup, th.ndown, th.U, th.symmetric) == (
        jh.nbasis, jh.nup, jh.ndown, jh.U, jh.symmetric)


@pytest.mark.parametrize("kw", [
    dict(nup=7, ndown=7, U=4.0, nx=4, ny=4),
    dict(nup=7, ndown=6, U=4.0, nx=4, ny=4, ktwist=[0.02, -0.01]),
])
def test_free_electron_trial_matches_jax(kw):
    jh = jhub.make_hubbard(**kw)
    th = thub.make_hubbard(**kw, **CPU)
    jt = jtrial.free_electron_trial(jh)
    tt = ttrial.free_electron_trial(th, **CPU)
    close(tt.psia.numpy(), jt.psia)
    close(tt.psib.numpy(), jt.psib)
    close(tt.inita.numpy(), jt.inita)
    close(tt.G_host, np.asarray(jt.G_host.arr))
    assert tt.etrial == pytest.approx(jt.etrial, abs=1e-10)


def test_trial_from_orbitals_matches_jax_and_golden():
    g = np.load(GOLDEN)
    jh = jhub.make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    th = thub.make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4, **CPU)
    jt = jtrial.trial_from_orbitals(jh, np.asarray(g["psi"]))
    tt = ttrial.trial_from_orbitals(th, np.asarray(g["psi"]), **CPU)
    close(tt.psia.numpy(), jt.psia)
    close(tt.psib.numpy(), jt.psib)
    assert tt.etrial == pytest.approx(jt.etrial, abs=1e-10)
    assert tt.etrial == pytest.approx(float(np.real(g["etrial"])), abs=1e-6)


def test_single_precision_bundle():
    th = thub.make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                           ktwist=[0.1, 0.0], device="cpu", dtype="single")
    tt = ttrial.free_electron_trial(th, device="cpu", dtype=torch.complex64)
    assert th.T.dtype == torch.complex64 and th.eks.dtype == torch.float32
    assert tt.psia.dtype == torch.complex64
    assert config.get_precision("double") is config.DOUBLE
    assert config.real_dtype(torch.complex64) == torch.float32
    with pytest.raises(ValueError):
        config.get_precision("half")


def test_resolve_device_never_picks_cpu_silently():
    if torch.cuda.is_available():
        assert config.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            config.resolve_device(None)
    assert config.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("charge,kw", [
    (True, dict(nup=7, ndown=7, U=4.0, nx=4, ny=4)),
    (False, dict(nup=7, ndown=7, U=4.0, nx=4, ny=4)),
    (False, dict(nup=7, ndown=6, U=4.0, nx=4, ny=4, ktwist=[0.02, -0.01])),
    (True, dict(nup=3, ndown=3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02])),
])
def test_make_hubbard_continuous_matches_jax(charge, kw):
    jh = jhub.make_hubbard(**kw)
    jt = jtrial.free_electron_trial(jh)
    ji = j_mhc(jh, jt, 0.01, charge_decomposition=charge)
    # Port constructors on port objects.
    th = thub.make_hubbard(**kw, **CPU)
    tt = ttrial.free_electron_trial(th, **CPU)
    ti = make_hubbard_continuous(th, tt, 0.01, charge_decomposition=charge,
                                 **CPU)
    close(ti.BH1.numpy(), ji.BH1)
    close(ti.mf_shift.numpy(), ji.mf_shift)
    assert (ti.dt, ti.U, ti.charge) == (ji.dt, ji.U, ji.charge)
    # The same from JAX objects carried across.
    ch = convert.hubbard(np.asarray(jh.T), jh.U, jh.symmetric, nx=jh.nx,
                         ny=jh.ny, nup=jh.nup, ndown=jh.ndown, device="cpu")
    ct = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       device="cpu")
    close(ch.h1e_mod.numpy(), jh.h1e_mod)
    close(ch.eks.numpy(), jh.eks)
    close(ct.G_host, np.asarray(jt.G_host.arr))
    ci = make_hubbard_continuous(ch, ct, 0.01, charge_decomposition=charge,
                                 **CPU)
    close(ci.BH1.numpy(), ji.BH1)
    close(ci.mf_shift.numpy(), ji.mf_shift)
    cc = convert.hubbard_continuous(np.asarray(ji.BH1),
                                    np.asarray(ji.mf_shift), dt=ji.dt,
                                    U=ji.U, charge=ji.charge, device="cpu")
    close(cc.BH1.numpy(), ji.BH1)
    assert cc.sqrt_dt == pytest.approx(ji.sqrt_dt)


def test_modules_move_with_to():
    th = thub.make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3, **CPU)
    names = {n for n, _ in th.named_buffers()}
    assert names == {"T", "h1e_mod", "eks"}
    tt = ttrial.free_electron_trial(th, **CPU)
    assert {n for n, _ in tt.named_buffers()} == {"psia", "psib", "inita",
                                                   "initb"}
    ti = make_hubbard_continuous(th, tt, 0.01, **CPU)
    assert {n for n, _ in ti.named_buffers()} == {"BH1", "mf_shift"}
