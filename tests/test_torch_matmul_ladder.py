"""The matmul-precision ladder of the port (config.matmul_tier,
config.set_matmul_precision, config.full_precision), on the CPU.

* ``matmul_tier`` maps the JAX package's ladder names onto torch's rungs
  ("float32" -> "highest", "bfloat16_3x" -> "highest", its products taking
  the 3-pass split GEMM's route on a card instead of cuBLAS's TF32,
  "bfloat16" -> "medium"), reads ``PAUXY_TPU_MATMUL`` for ``None`` and
  refuses any other name with ``ValueError``.
* On a CPU device the tier changes nothing and reports "float32" (as
  tests/test_config.py's ``test_cpu_is_noop`` holds JAX's); on a CUDA
  device it sets the process's rung (and installs the split route for
  "bfloat16_3x" only), and a later "float32" sets IEEE again. Building either driver on the CPU leaves torch's setting as it
  was.
* ``full_precision`` forces "highest" in its body and restores the rung
  before it, also when the body raises; the plain pivoted QR runs under it
  whatever the tier.
* A JSON input's ``propagator.matmul_precision`` reaches both drivers
  through ``setup_calculation``.
"""

import numpy as np
import pytest
import torch

from pauxy_tpu_torch import config
from pauxy_tpu_torch.ops import cpqr_cuda, gemm3_cuda

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
TIERS = [("float32", "highest"), ("bfloat16_3x", "highest"),
         ("bfloat16", "medium")]


def torch_setting():
    """Torch's float32-product settings: the rung and, where this torch
    has them, the per-backend precisions."""
    out = [torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32]
    for backend in (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul):
        out.append(getattr(backend, "fp32_precision", None))
    return tuple(out)


@pytest.fixture
def restore_rung():
    """Put the process back at "highest", without the split route, after
    a test that moves it."""
    yield
    torch.set_float32_matmul_precision("highest")
    gemm3_cuda.remove_route()


@pytest.mark.parametrize("name,rung", TIERS)
def test_matmul_tier_maps_the_ladder(name, rung):
    assert config.matmul_tier(name) == rung


@pytest.mark.parametrize("name", ["float64", "highest", "tf32", "", "FLOAT32"])
def test_matmul_tier_refuses_other_names(name):
    with pytest.raises(ValueError, match="matmul_precision"):
        config.matmul_tier(name)


def test_matmul_tier_default_is_float32(monkeypatch):
    monkeypatch.delenv("PAUXY_TPU_MATMUL", raising=False)
    assert config.matmul_tier(None) == "highest"


@pytest.mark.parametrize("name,rung", TIERS)
def test_environment_names_the_tier(monkeypatch, name, rung):
    monkeypatch.setenv("PAUXY_TPU_MATMUL", name)
    assert config.matmul_tier(None) == rung
    # An explicit name wins over the environment.
    assert config.matmul_tier("float32") == "highest"


def test_environment_off_the_ladder_raises(monkeypatch):
    monkeypatch.setenv("PAUXY_TPU_MATMUL", "bf16")
    with pytest.raises(ValueError, match="bf16"):
        config.set_matmul_precision(None, "cpu")


@pytest.mark.parametrize("name", [None, "float32", "bfloat16_3x", "bfloat16"])
def test_cpu_is_noop(name):
    before = torch_setting()
    assert config.set_matmul_precision(name, "cpu") == "float32"
    assert config.set_matmul_precision(name, torch.device("cpu")) == "float32"
    assert torch_setting() == before


def test_cuda_sets_the_rung_and_float32_restores_ieee(restore_rung):
    # Torch's rung is a process setting: it can be set without a card.
    for name, rung in TIERS[::-1] + TIERS:
        assert config.set_matmul_precision(name, "cuda") == name
        assert torch.get_float32_matmul_precision() == rung
        assert gemm3_cuda.route_installed() is (name == "bfloat16_3x")
    assert config.set_matmul_precision("bfloat16", "cuda:0") == "bfloat16"
    assert config.set_matmul_precision(None, "cuda") == "float32"
    assert torch.get_float32_matmul_precision() == "highest"
    assert not gemm3_cuda.route_installed()


@pytest.mark.parametrize("rung", ["highest", "high", "medium"])
def test_full_precision_restores_the_rung(restore_rung, rung):
    torch.set_float32_matmul_precision(rung)
    with config.full_precision():
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.get_float32_matmul_precision() == rung
    with pytest.raises(RuntimeError, match="inside"):
        with config.full_precision():
            assert torch.get_float32_matmul_precision() == "highest"
            raise RuntimeError("inside")
    assert torch.get_float32_matmul_precision() == rung


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_plain_cpqr_is_pinned(restore_rung, dtype):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 24, 24))
    if dtype.is_complex:
        a = a + 1j * rng.normal(size=a.shape)
    a = torch.from_numpy(a).to(dtype)
    want = cpqr_cuda.cpqr_lanes_plain(a)
    torch.set_float32_matmul_precision("medium")
    got = cpqr_cuda.cpqr_lanes_plain(a)
    assert torch.get_float32_matmul_precision() == "medium"
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _hubbard_driver(policy):
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    return AFQMC(ham, free_electron_trial(ham, **CPU),
                 QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),
                 propagator_options={"matmul_precision": policy},
                 device="cpu")


def _thermal_driver(policy):
    from pauxy_tpu_torch.models import make_hubbard
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    return ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1,
                                            nblocks=1, beta=0.5),
                        propagator_options={"matmul_precision": policy},
                        device="cpu")


@pytest.mark.parametrize("build", [_hubbard_driver, _thermal_driver])
@pytest.mark.parametrize("name", [None, "float32", "bfloat16_3x", "bfloat16"])
def test_cpu_driver_leaves_torch_setting(build, name):
    before = torch_setting()
    assert build(name).matmul_precision == "float32"
    assert torch_setting() == before


@pytest.mark.parametrize("build", [_hubbard_driver, _thermal_driver])
def test_driver_refuses_a_name_off_the_ladder(build):
    with pytest.raises(ValueError, match="bfloat8"):
        build("bfloat8")


@pytest.mark.parametrize("build", [_hubbard_driver, _thermal_driver])
def test_driver_reads_the_environment(monkeypatch, build):
    monkeypatch.setenv("PAUXY_TPU_MATMUL", "bfloat16")
    assert build(None).matmul_precision == "float32"
    monkeypatch.setenv("PAUXY_TPU_MATMUL", "bfloat8")
    with pytest.raises(ValueError, match="bfloat8"):
        build(None)


def _json_input(beta, filename):
    qmc = {"dt": 0.05, "nwalkers": 2, "nsteps": 1, "nblocks": 1,
           "rng_seed": 7}
    if beta is not None:
        qmc["beta"] = beta
    return {"system": {"name": "Hubbard", "nx": 2, "ny": 2, "U": 4.0,
                       "nup": 2, "ndown": 2, "mu": 0.9},
            "qmc": qmc,
            "trial": {"name": "free_electron" if beta is None
                      else "one_body"},
            "propagator": {"matmul_precision": "bfloat16"},
            "estimates": {"filename": filename}}


@pytest.mark.parametrize("beta", [None, 0.5])
def test_json_tier_reaches_both_drivers(monkeypatch, tmp_path, beta):
    from pauxy_tpu_torch.qmc.calc import setup_calculation
    monkeypatch.chdir(tmp_path)
    seen = []
    real = config.set_matmul_precision

    def spy(policy, device):
        seen.append((policy, torch.device(device).type))
        return real(policy, device)

    monkeypatch.setattr(config, "set_matmul_precision", spy)
    af = setup_calculation(_json_input(beta, str(tmp_path / "a.h5")), **CPU)
    want = "ThermalAFQMC" if beta is not None else "AFQMC"
    assert type(af).__name__ == want
    assert seen == [("bfloat16", "cpu")]
    assert af.matmul_precision == "float32"
    monkeypatch.setattr(config, "set_matmul_precision", real)
    bad = _json_input(beta, str(tmp_path / "b.h5"))
    bad["propagator"]["matmul_precision"] = "half"
    with pytest.raises(ValueError, match="half"):
        setup_calculation(bad, **CPU)
