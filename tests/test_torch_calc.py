"""The port's JSON front door against the JAX package's.

* ``qmc/calc.setup_calculation`` on the same JSON in both packages, for a
  Hubbard continuous, a Hubbard discrete, a Generic-from-file (QMCPACK
  integrals and a wavefunction file), a UEG and a thermal Hubbard input:
  the system's, the trial's and the propagator's arrays at 1e-12 (float64,
  CPU), then two blocks of each driver with JAX's draws injected into the
  port's (``AFQMC.run_block(noise)``, ``ThermalAFQMC.run_block(noise)``),
  the rows at rtol 1e-8;
* the names either factory refuses raise the same errors;
* the CLI's ``main(["--cpu", input])`` runs an input and prints the
  reblocked table, and the ``bin/`` scripts import no JAX.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.qmc import calc as jcalc
from pauxy_tpu.utils import qmcpack as jqmcpack
from pauxy_tpu.utils import wavefunction as jwfn
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu_torch import __main__ as tmain
from pauxy_tpu_torch.qmc import calc as tcalc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.qmc.thermal_afqmc import PathNoise

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype="double")
QMC = {"nwalkers": 8, "dt": 0.05, "nsteps": 5, "blocks": 2,
       "stabilise_freq": 5, "pop_control_freq": 1, "rng_seed": 8}
HUBBARD = {"name": "Hubbard", "nup": 3, "ndown": 3, "U": 4.0, "nx": 3,
           "ny": 3, "ktwist": [0.01, -0.02]}


def generic_files(tmp_path):
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=5)
    ham = str(tmp_path / "afqmc.h5")
    wfn = str(tmp_path / "wfn.h5")
    jqmcpack.write_hamiltonian(h1e, chol, (2, 2), ecore=enuc, filename=ham)
    rng = np.random.default_rng(3)
    psi, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    jwfn.write_wavefunction(np.concatenate([psi[:, :2], psi[:, :2]], 1), wfn)
    return ham, wfn


def inputs(case, tmp_path):
    est = {"mixed": {"energy_eval_freq": 1}}
    if case == "hubbard_continuous":
        return {"system": HUBBARD, "qmc": QMC,
                "trial": {"name": "free_electron"}, "estimates": est}
    if case == "hubbard_discrete":
        return {"system": HUBBARD, "qmc": QMC, "trial": {"name": "uhf"},
                "propagator": {"hubbard_stratonovich": "discrete"},
                "estimates": est}
    if case == "generic_file":
        ham, wfn = generic_files(tmp_path)
        return {"system": {"name": "Generic", "integrals": ham},
                "qmc": dict(QMC, dt=0.01),
                "trial": {"name": "hartree_fock", "filename": wfn},
                "propagator": {"taylor_impl": "pallas"}, "estimates": est}
    if case == "ueg":
        return {"system": {"name": "UEG", "nup": 1, "ndown": 1, "rs": 1.0,
                           "ecut": 1.0},
                "qmc": dict(QMC, dt=0.01),
                "trial": {"name": "hartree_fock"}, "estimates": est}
    return {"system": dict(HUBBARD, ktwist=None, mu=0.9),
            "qmc": dict(QMC, nsteps=1, beta=0.5, pop_control_freq=2),
            "trial": {"name": "one_body"}}


def arrays(obj, names):
    return {n: getattr(obj, n) for n in names
            if getattr(obj, n, None) is not None}


def assert_same(jobj, tobj, names):
    jarr, tarr = arrays(jobj, names), arrays(tobj, names)
    assert set(jarr) == set(tarr) and jarr, (set(jarr), set(tarr))
    for n, t in tarr.items():
        np.testing.assert_allclose(t.cpu().numpy(), np.asarray(jarr[n]),
                                   rtol=1e-12, atol=1e-12, err_msg=n)


def block_noise(key, jd, td, case):
    """The draws of one JAX block in the port's layout (keys =
    split(block_key, nsteps); kprop, kpop, kest = split(key, 3))."""
    nw, m = td.qmc.nwalkers, td.ham.nbasis
    xi, pop = [], []
    for k in jax.random.split(key, td.qmc.nsteps):
        kprop, kpop, _ = jax.random.split(k, 3)
        if case == "hubbard_continuous":
            x = jax.random.normal(kprop, (nw, m), dtype=jnp.float64).T
        elif case == "hubbard_discrete":
            x = jax.random.uniform(kprop, (m, nw), dtype=jnp.float64)
        else:
            x = jax.random.normal(kprop, (nw, jd.ham.nfields),
                                  dtype=jnp.float64)
        xi.append(np.asarray(x))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(torch.from_numpy(np.array(xi)),
                      torch.from_numpy(np.array(pop)))


def path_noise(key, td):
    xi, pop = [], []
    for k in jax.random.split(key, td.ntime_slices):
        kprop, kpop = jax.random.split(k)
        xi.append(np.asarray(jax.random.normal(
            kprop, (td.qmc.nwalkers, td.prop.nfields), dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return PathNoise(torch.from_numpy(np.array(xi)),
                     torch.from_numpy(np.array(pop)))


CASES = ("hubbard_continuous", "hubbard_discrete", "generic_file", "ueg",
         "thermal")


@pytest.mark.parametrize("case", CASES)
def test_setup_calculation_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opts = inputs(case, tmp_path)
    opts["estimates"] = dict(opts.get("estimates", {}),
                             filename=str(tmp_path / "jax.h5"))
    # JAX's Pallas Taylor kernel runs in float32 (interpreted on the CPU):
    # its XLA route is the float64 reference of the port's "pallas" route.
    jopts = dict(opts, verbosity=0)
    if "propagator" in opts and case == "generic_file":
        jopts["propagator"] = {"taylor_impl": "xla"}
    jd = jcalc.setup_calculation(jopts)
    opts["estimates"]["filename"] = str(tmp_path / "port.h5")
    td = tcalc.setup_calculation(dict(opts, verbosity=0), **CPU)
    assert type(td).__name__ == type(jd).__name__
    assert (td.ham.name, td.ham.nup, td.ham.ndown, td.ham.nbasis) == (
        jd.ham.name, jd.ham.nup, jd.ham.ndown, jd.ham.nbasis)
    assert_same(jd.ham, td.ham, ("T", "H1", "h1e_mod", "chol", "vqvec"))
    if case == "thermal":
        assert_same(jd.trial, td.trial, ("dmat", "dmat_inv"))
        assert_same(jd.prop.inner, td.prop.inner, ("BH1", "mf_shift"))
    else:
        assert td.trial.etrial == pytest.approx(jd.trial.etrial, abs=1e-10)
        assert_same(jd.trial, td.trial, ("psia", "psib", "rchola",
                                         "rcholb"))
        if case == "hubbard_discrete":
            assert_same(jd.prop, td.prop, ("BT2", "auxf", "aux_wfac"))
        else:
            assert_same(jd.prop.inner, td.prop.inner, ("BH1", "mf_shift"))
    assert td.filename == str(tmp_path / "port.h5")
    for _ in range(2):
        _, sub = jax.random.split(jd.key)
        noise = (path_noise(sub, td) if case == "thermal"
                 else block_noise(sub, jd, td, case))
        jrow, row = jd.run_block(), td.run_block(noise)
        np.testing.assert_allclose(row[:10].real, jrow[:10].real,
                                   rtol=1e-8, atol=1e-10)
        # The imaginary parts up to the branch of the log-det phase (JAX's
        # CPU route sums the pivots' logs unwrapped; the port wraps them
        # into (-pi, pi] as the kernels do).
        np.testing.assert_allclose(np.exp(1j * row[:10].imag),
                                   np.exp(1j * jrow[:10].imag), rtol=1e-8,
                                   atol=1e-10)
        assert np.isfinite(row.real).all()
        if case != "thermal":
            assert td.eshift == pytest.approx(jd.eshift, rel=1e-8, abs=1e-10)


@pytest.mark.parametrize("section,opts,error", [
    ("system", {"name": "Anderson"}, NotImplementedError),
    ("trial", {"name": "jastrow"}, NotImplementedError),
    ("trial", {"name": "hartree_fock", "filename": "wfn.h5",
               "excitation": [0, 4]}, NotImplementedError),
    ("trial", {"name": "hartree_fock", "excitation": [0, 2]}, ValueError),
    ("system", {"name": "Generic"}, ValueError),
    ("thermal", {"name": "bogus"}, ValueError),
])
def test_refused_names_raise_as_in_jax(section, opts, error, tmp_path,
                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = {"system": HUBBARD, "qmc": dict(QMC, blocks=1), "verbosity": 0,
            "estimates": {"filename": str(tmp_path / "e.h5")}}
    if section == "thermal":
        base["qmc"] = dict(QMC, beta=0.5)
        base["trial"] = opts
    else:
        base[section] = opts
    with pytest.raises(error):
        jcalc.setup_calculation(base)
    with pytest.raises(error):
        tcalc.setup_calculation(base, **CPU)


def test_cli_main_cpu_runs_an_input(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ham, wfn = generic_files(tmp_path)
    inp = tmp_path / "input.json"
    inp.write_text(json.dumps({
        "system": {"name": "Generic", "integrals": ham},
        "qmc": dict(QMC, dt=0.01, blocks=8),
        "trial": {"name": "hartree_fock", "filename": wfn},
        "estimates": {"mixed": {"energy_eval_freq": 1}}}))
    driver = tmain.main(["--cpu", str(inp)])
    out = capsys.readouterr().out
    assert "# Reblocked estimates:" in out
    assert driver.filename == "estimates.0.h5"
    assert (tmp_path / "estimates.0.h5").exists()
    assert driver.trial.psia.dtype == torch.complex128
    assert driver.get_energy() is not None


def test_bin_scripts_and_new_modules_pull_in_no_jax(tmp_path):
    """With jax made unimportable: fcidump-to-afqmc-torch converts an
    FCIDUMP, pauxy-tpu-torch --help runs, and every module this slice
    added imports and pulls in no JAX module."""
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "pauxy_tpu"):
        (block / f"{name}.py").write_text(
            f"raise ImportError('{name} imported')\n")
    fcidump = tmp_path / "FCIDUMP"
    fcidump.write_text(" &FCI NORB=2,NELEC=2,MS2=0,\n &END\n"
                       " 0.5 1 1 1 1\n 0.2 2 2 1 1\n 0.6 2 2 2 2\n"
                       " -1.0 1 1 0 0\n -0.5 2 2 0 0\n 0.1 2 1 0 0\n"
                       " 0.7 0 0 0 0\n")
    env = dict(os.environ, PYTHONPATH=str(block))
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bin", "fcidump-to-afqmc-torch"),
         str(fcidump), "-o", str(tmp_path / "out.h5")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "M=2" in res.stdout
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bin", "pauxy-tpu-torch"),
         "--help"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=120)
    assert res.returncode == 0, res.stderr
    modules = ["pauxy_tpu_torch." + m for m in (
        "__main__", "qmc.calc", "native", "analysis.autocorr",
        "analysis.blocking", "analysis.correlation", "analysis.extraction",
        "analysis.rdm", "analysis.thermal", "utils.checkpoint",
        "utils.from_pyscf", "utils.h5lite", "utils.hamiltonian_converter",
        "utils.qmcpack", "utils.sgto", "utils.wavefunction")]
    res = subprocess.run(
        [sys.executable, "-c", "import importlib, sys; "
         f"[importlib.import_module(m) for m in {modules!r}]; "
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'flax', 'pauxy_tpu')]; assert not bad, bad"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, PYTHONPATH=f"{block}:{ROOT}"))
    assert res.returncode == 0, res.stderr
