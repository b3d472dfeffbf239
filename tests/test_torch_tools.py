"""The port's copies of the ``tools/`` scripts (``tools/*_torch.py``,
``tools/pyscf/pyscf_to_afqmc_torch.py``) against the originals: on the
same estimates files each copy prints (or writes) what the original does;
``run_examples_torch.py`` runs an example end to end and its energies
agree statistically with the JAX package's run of the same input.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(device="cpu", dtype="double")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Estimates files written by the port: mixed + back propagation,
    mixed + ITCF, and a thermal run."""
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    d = tmp_path_factory.mktemp("tools")
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **KW)
    trial = free_electron_trial(ham, **KW)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=10, nblocks=6, nstblz=5,
                  npop_control=5, rng_seed=8)
    out = {"bp": str(d / "bp.h5"), "itcf": str(d / "itcf.h5"),
           "thermal": str(d / "ft.h5")}
    AFQMC(ham, trial, qmc, estimator_options={
        "mixed": {"energy_eval_freq": 1},
        "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True}},
        filename=out["bp"], device="cpu").run()
    AFQMC(ham, trial, QMCOpts(nwalkers=4, dt=0.05, nsteps=5, nblocks=6,
                              nstblz=100, npop_control=100, rng_seed=3),
          estimator_options={"mixed": {"energy_eval_freq": 5},
                             "itcf": {"tau_max": 0.5, "stable": True}},
          filename=out["itcf"], device="cpu").run()
    h2 = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **KW)
    ThermalAFQMC(h2, make_one_body_trial(h2, 0.5, 0.05, **KW),
                 QMCOpts(nwalkers=8, dt=0.05, nsteps=1, nblocks=4, beta=0.5,
                         npop_control=2, rng_seed=7),
                 filename=out["thermal"], device="cpu").run()
    out["dir"] = str(d)
    return out


# (arguments with {bp}/{itcf}/{thermal} filled in, whether the script
# writes out.npy to compare too)
RUNS = {
    "extract_raw": (["{bp}"], False),
    "simple": (["0.01", "{bp}"], False),
    "reblock": (["-s", "1", "-f", "{bp}"], False),
    "mom_dist": (["-f", "{bp}"], False),
    "finite_temp_analysis": (["-f", "{thermal}"], False),
    "extract_observable_rdm": (["-f", "{bp}", "-o",
                                "back_propagated:one_rdm", "--out", "out.npy"],
                               True),
    "extract_observable_itcf": (["-f", "{itcf}", "-o",
                                 "itcf:real_space_greens_function", "--out",
                                 "out.npy"], True),
}


def _script(key):
    return key.split("_rdm")[0].split("_itcf")[0]


@pytest.fixture(scope="module")
def outputs(files):
    """Every original and copy, all started at once, each in a directory
    of its own (simple.py writes analysed_*.h5 there)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {}
    for key, (args, _) in RUNS.items():
        for suffix in ("", "_torch"):
            cwd = os.path.join(files["dir"], f"{key}{suffix}")
            os.makedirs(cwd, exist_ok=True)
            argv = [a.format(**files)
                    for a in args]
            script = os.path.join(ROOT, "tools", f"{_script(key)}{suffix}.py")
            procs[key, suffix] = (subprocess.Popen(
                [sys.executable, script, *argv], cwd=cwd, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                cwd)
    out = {}
    for k, (p, cwd) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[k] = (p.returncode, stdout, stderr, cwd)
    return out


@pytest.mark.parametrize("key", list(RUNS))
def test_copy_equals_original(key, outputs):
    rc, orig, err, cwd = outputs[key, ""]
    rct, copy_, errt, cwdt = outputs[key, "_torch"]
    assert rc == 0, err
    assert rct == 0, errt
    assert copy_ == orig
    if RUNS[key][1]:
        np.testing.assert_array_equal(np.load(os.path.join(cwdt, "out.npy")),
                                      np.load(os.path.join(cwd, "out.npy")))
    else:
        assert orig.strip()


def test_copies_import_no_jax():
    for name in os.listdir(os.path.join(ROOT, "tools")) + [
            "pyscf/pyscf_to_afqmc_torch.py"]:
        if not name.endswith("_torch.py"):
            continue
        src = open(os.path.join(ROOT, "tools", name)).read()
        assert "import jax" not in src and "pauxy_tpu." not in src, name


def test_pyscf_to_afqmc_copy_equals_original(tmp_path, monkeypatch):
    """Without pyscf here, the integrals' writer (from_pyscf.dump_pauxy)
    is stubbed in both packages: each script passes it the same options
    and writes the same input.json."""
    import pauxy_tpu.utils.from_pyscf as jfp
    import pauxy_tpu_torch.utils.from_pyscf as tfp

    calls = {}
    for tag, mod in (("jax", jfp), ("torch", tfp)):
        monkeypatch.setattr(mod, "dump_pauxy",
                            lambda tag=tag, **kw: calls.setdefault(tag, kw))
    argv = ["-i", "scf.chk", "-t", "1e-6", "-oao", "-b"]
    for tag, suffix in (("jax", ""), ("torch", "_torch")):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        mod = _load(os.path.join(ROOT, "tools", "pyscf",
                                 f"pyscf_to_afqmc{suffix}.py"),
                    f"pyscf_to_afqmc{suffix}")
        mod.main(argv)
    assert calls["jax"] == calls["torch"]
    assert calls["torch"]["chol_cut"] == 1e-6 and calls["torch"]["ortho_ao"]
    with open(tmp_path / "jax" / "input.json") as a, \
            open(tmp_path / "torch" / "input.json") as b:
        assert json.load(a) == json.load(b)


def test_run_examples_copy_runs_an_example():
    """run_examples_torch.py --cpu on one example, in a process of its
    own."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "run_examples_torch.py"),
         "--cpu", "--only", "hubbard"], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert "OK hubbard" in out.stdout and "ALL EXAMPLES OK" in out.stdout


def test_run_examples_copy_agrees_with_jax(tmp_path, monkeypatch):
    """The hubbard example with run_examples' overrides, run longer (40
    blocks) by the JAX package and by the port from the same input, on the
    CPU in float64: the mean energies over the last 30 blocks agree within
    4 combined standard errors (different random streams)."""
    from pauxy_tpu.qmc.calc import get_driver as jget_driver
    from pauxy_tpu_torch.analysis.blocking import reblock_summary
    from pauxy_tpu_torch.qmc.calc import get_driver

    tools = _load(os.path.join(ROOT, "tools", "run_examples_torch.py"),
                  "run_examples_torch")
    with open(os.path.join(ROOT, "examples", "hubbard", "input.json")) as fh:
        base = json.load(fh)
    monkeypatch.chdir(tmp_path)
    opts = tools.shrink(base, "hubbard")
    opts["qmc"]["nblocks" if "nblocks" in opts["qmc"] else "blocks"] = 40
    opts["qmc"]["nwalkers"] = 8
    stats = []
    for get, kw in ((jget_driver, {}), (get_driver, KW)):
        o = copy.deepcopy(opts)
        o["estimates"]["filename"] = str(tmp_path / f"{len(stats)}.h5")
        rows = np.asarray(get(o, **kw).run())
        s = reblock_summary(rows[10:, 5].real)
        stats.append((float(s["mean"]), float(s["standard error"])))
    (ma, sa), (mb, sb) = stats
    assert np.isfinite([ma, mb]).all()
    assert abs(ma - mb) < 4 * np.hypot(sa, sb) + 1e-12, stats
