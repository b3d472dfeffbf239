"""Three faults of the port, each held to the JAX package on the CPU.

* ``config.full_precision()`` restores every float32 setting that
  ``torch.set_float32_matmul_precision`` moves (the rung and, where this
  torch has them, ``torch.backends.cuda.matmul.fp32_precision`` and
  ``torch.backends.mkldnn.matmul.fp32_precision``), also when its body
  raises; a CPU ``ThermalAFQMC`` build in a fresh interpreter leaves all
  three as they were.
* ``PAUXY_TPU_TAYLOR`` picks the Generic propagator's series when no
  ``taylor_impl`` is given, and ``PAUXY_TPU_FAST=0`` sends the 4x4 lattice
  driver to the generic block, whose rows then equal the lanes block's on
  the same draws (JAX's ``tests/test_hubbard_fast.py`` bound).
* An unknown population-control method raises JAX's ``ValueError`` when
  the driver is built.
"""

import os
import subprocess
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers.pop_control import pop_control as j_pop_control
from pauxy_tpu_torch import config
from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                    make_hubbard, rhf_identity_trial)
from pauxy_tpu_torch.propagation.generic import make_generic_continuous
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")

SETTINGS = """
import torch
def settings():
    return [torch.get_float32_matmul_precision()] + [
        getattr(b, "fp32_precision", None)
        for b in (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)]
"""


def test_fresh_thermal_cpu_build_leaves_fp32_settings():
    """A CPU ThermalAFQMC build (its plain pivoted QR runs under
    full_precision) in a fresh interpreter: the rung and both backends'
    fp32_precision are what they were before it."""
    code = SETTINGS + """
before = settings()
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
from pauxy_tpu_torch.qmc import QMCOpts
from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC
CPU = dict(device="cpu", dtype="double")
ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1, nblocks=1,
                                 beta=0.5), device="cpu")
print(repr((before, settings())))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    before, after = eval(res.stdout.strip().splitlines()[-1])
    assert after == before
    assert before[0] == "highest"


def _backends():
    return [b for b in (torch.backends.cuda.matmul,
                        torch.backends.mkldnn.matmul)
            if hasattr(b, "fp32_precision")]


@pytest.mark.parametrize("raises", [False, True])
def test_full_precision_restores_each_backend(raises):
    """Each backend's own value comes back, whatever the rung would give
    it, also when the body raises; the body runs at "highest"."""
    backends = _backends()
    saved = [b.fp32_precision for b in backends]
    try:
        for b in backends:
            b.fp32_precision = "none"
        rung = torch.get_float32_matmul_precision()
        with pytest.raises(RuntimeError) if raises else nullcontext():
            with config.full_precision():
                assert torch.get_float32_matmul_precision() == "highest"
                assert config.pinned()
                if raises:
                    raise RuntimeError("body")
        assert not config.pinned()
        assert torch.get_float32_matmul_precision() == rung
        assert [b.fp32_precision for b in backends] == ["none"] * len(
            backends)
    finally:
        for b, v in zip(backends, saved):
            b.fp32_precision = v


def _generic_pair():
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=3)
    jham = j_make_generic((2, 2), h1e, chol, enuc)
    tham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    return jham, jtrial.rhf_identity_trial(jham), tham, rhf_identity_trial(
        tham, **CPU)


@pytest.mark.parametrize("env", [None, "pallas_bf16", "pallas", "xla_3m"])
def test_taylor_env_picks_generic_series(monkeypatch, env):
    """taylor_impl=None reads PAUXY_TPU_TAYLOR (default "xla") in the
    Generic set-up, as JAX's make_generic_continuous does; an explicit
    taylor_impl wins over it."""
    if env is None:
        monkeypatch.delenv("PAUXY_TPU_TAYLOR", raising=False)
    else:
        monkeypatch.setenv("PAUXY_TPU_TAYLOR", env)
    jham, jt, tham, tt = _generic_pair()
    want = j_mgc(jham, jt, 0.01).taylor_impl
    assert want == (env or "xla")
    assert make_generic_continuous(tham, tt, 0.01,
                                   **CPU).taylor_impl == want
    assert make_generic_continuous(tham, tt, 0.01, taylor_impl="xla",
                                   **CPU).taylor_impl == "xla"
    af = AFQMC(tham, tt, QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),
               device="cpu")
    assert af.prop.inner.taylor_impl == want


def _lattice_driver(monkeypatch, fast, pop_method, **kw):
    monkeypatch.setenv("PAUXY_TPU_FAST", "1" if fast else "0")
    ham = make_hubbard(kw.get("nup", 7), kw.get("ndown", 7), U=4.0, nx=4,
                       ny=4, ktwist=kw.get("ktwist"), **CPU)
    qmc = QMCOpts(nwalkers=24, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=2, rng_seed=8, pop_control_method=pop_method)
    af = AFQMC(ham, free_electron_trial(ham, **CPU), qmc,
               propagator_options=kw.get("popts"),
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    monkeypatch.delenv("PAUXY_TPU_FAST")
    return af


FAST_CASES = {
    "comb": dict(pop_method="comb"),
    "pair_branch": dict(pop_method="pair_branch"),
    "twist_spin": dict(pop_method="comb", ktwist=[0.02, -0.01], nup=7,
                       ndown=6, popts={"charge_decomposition": False}),
}


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_env_off_takes_generic_block(monkeypatch, case):
    """PAUXY_TPU_FAST=0: the 4x4 lattice driver takes the generic block;
    fed the lanes block's draws (HS fields [M, W] there, [W, M] here), its
    rows equal the lanes block's to JAX's test_fast_block_matches_generic
    bound."""
    kw = dict(FAST_CASES[case])
    pop_method = kw.pop("pop_method")
    generic = _lattice_driver(monkeypatch, False, pop_method, **kw)
    fast = _lattice_driver(monkeypatch, True, pop_method, **kw)
    assert not generic.use_fast_block and fast.use_fast_block
    rng = np.random.default_rng(3)
    npop = 1 if pop_method == "comb" else 12
    for _ in range(4):
        xi = torch.from_numpy(rng.normal(size=(10, 16, 24)))
        pop = torch.from_numpy(rng.uniform(size=(10, npop)))
        want = fast.run_block(BlockNoise(xi, pop))
        got = generic.run_block(BlockNoise(xi.transpose(1, 2).contiguous(),
                                           pop))
        np.testing.assert_allclose(got[1:10].real, want[1:10].real,
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fast", ["1", None])
def test_fast_env_default_keeps_lanes_block(monkeypatch, fast):
    if fast is None:
        monkeypatch.delenv("PAUXY_TPU_FAST", raising=False)
    else:
        monkeypatch.setenv("PAUXY_TPU_FAST", fast)
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **CPU)
    af = AFQMC(ham, free_electron_trial(ham, **CPU),
               QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),
               device="cpu")
    assert af.use_fast_block


@pytest.mark.parametrize("hs", ["continuous", "discrete"])
def test_unknown_pop_control_raises_jax_error(hs):
    """JAX's ValueError and message, when the driver is built, whichever
    block the configuration would take."""
    with pytest.raises(ValueError) as jerr:
        j_pop_control(None, None, 1.0, method="stochastic_reconfiguration")
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **CPU)
    with pytest.raises(ValueError) as terr:
        AFQMC(ham, free_electron_trial(ham, **CPU),
              QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1,
                      pop_control_method="stochastic_reconfiguration"),
              propagator_options={"hubbard_stratonovich": hs},
              device="cpu")
    assert str(terr.value) == str(jerr.value)
