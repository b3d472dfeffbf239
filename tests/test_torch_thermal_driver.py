"""Port driver tests for the finite-temperature path (qmc/thermal_afqmc.py).

* two paths of ThermalAFQMC.run_block against JAX's with JAX's draws
  injected, taken in JAX's order (key = key(seed); per path key, sub =
  split(key); per slice kprop, kpop = split(split(sub, nslices)[ts]);
  xi = normal(kprop, (w, nfields)); comb's uniform(kpop, ()) or
  pair_branch's uniform(kpop, (w // 2,))), float64, every row entry but
  the time at rtol 1e-8: the 3x3 Hubbard model (comb, and pair_branch) and
  a small UEG (M = 19, 5 bins, so that the prefix fold runs);
* U = 0: every row equals the exact grand-canonical energy and particle
  number (tests/test_thermal_afqmc.py's oracle);
* the golden anchor tests/data/thermal_hubbard3x3.npz: 60 paths, CPU
  float64, |dE| < max(4 se, 0.05) and |dNav| < max(4 se, 0.02), the
  criterion of tests/test_thermal_afqmc.py;
* the HDF5 layout equal to the JAX driver's THERMAL_HEADER file, and the
  thermal options (beta, reduced units) read as in JAX;
* the device rule, the options that are not ported, and no jax imported by
  the port's thermal path.
"""

import json
import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import make_ueg as j_make_ueg
from pauxy_tpu.models.thermal_trial import make_one_body_trial as j_mobt
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu.qmc import thermal_afqmc as jta
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
from pauxy_tpu_torch.models.ueg import make_ueg
from pauxy_tpu_torch.qmc import QMCOpts
from pauxy_tpu_torch.qmc import thermal_afqmc as tta

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "thermal_hubbard3x3.npz")
CPU = dict(device="cpu", dtype="double")


def systems(system, U=4.0):
    if system == "hubbard":
        return (j_make_hubbard(nup=3, ndown=3, U=U, nx=3, ny=3),
                make_hubbard(3, 3, U=U, nx=3, ny=3, **CPU),
                dict(beta=0.5, dt=0.05, mu=0.9))
    return (j_make_ueg(nup=1, ndown=1, rs=1.0, ecut=1.0),
            make_ueg(1, 1, rs=1.0, ecut=1.0, **CPU),
            dict(beta=0.25, dt=0.025, mu=0.245, stack_size=2))


def jax_path_noise(sub, nslices, nw, nfields, method):
    xi, pop = [], []
    for key in jax.random.split(sub, nslices):
        kprop, kpop = jax.random.split(key)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nfields),
                                               dtype=jnp.float64)))
        shape = () if method == "comb" else (nw // 2,)
        pop.append(np.asarray(jax.random.uniform(kpop, shape,
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return tta.PathNoise(torch.from_numpy(np.array(xi)),
                         torch.from_numpy(np.array(pop)))


@pytest.mark.parametrize("system,method", [("hubbard", "comb"),
                                           ("hubbard", "pair_branch"),
                                           ("ueg", "comb")])
def test_two_paths_match_jax_with_injected_draws(system, method, tmp_path):
    jham, ham, kw = systems(system)
    nw = 8
    opts = dict(nwalkers=nw, dt=kw["dt"], nsteps=1, nblocks=2,
                beta=kw["beta"], npop_control=2, rng_seed=8,
                pop_control_method=method)
    jt = j_mobt(jham, **kw)
    jaf = jta.ThermalAFQMC(jham, jt, JQMCOpts(**opts),
                           filename=str(tmp_path / "j.h5"))
    af = tta.ThermalAFQMC(ham, make_one_body_trial(ham, **kw, **CPU),
                          QMCOpts(**opts), device="cpu")
    assert af.trial.nbins == jt.nbins
    key = jax.random.key(8)
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise = jax_path_noise(sub, af.ntime_slices, nw, af.prop.nfields,
                               method)
        jrow, row = jaf.run_block(), af.run_block(noise)
        np.testing.assert_allclose(row[:11], jrow[:11], rtol=1e-8,
                                   atol=1e-10)
        assert np.isfinite(row).all()


def test_free_fermions_exact():
    """U = 0: no auxiliary-field noise in the weights' structure; every
    row is the exact grand-canonical E and N."""
    _, ham, _ = systems("hubbard", U=0.0)
    beta, dt = 1.0, 0.05
    trial = make_one_body_trial(ham, beta, dt, **CPU)
    af = tta.ThermalAFQMC(ham, trial, QMCOpts(
        nwalkers=4, dt=dt, nsteps=1, nblocks=2, beta=beta, npop_control=5,
        rng_seed=3), device="cpu")
    rows = af.run()
    evals = np.linalg.eigvalsh(ham.T[0].numpy())
    occ = 1.0 / (np.exp(beta * (evals - trial.mu)) + 1.0)
    e_exact, n_exact = 2 * np.sum(evals * occ), 2 * occ.sum()
    assert len(rows) == 3
    for row in rows:
        assert row[5].real == pytest.approx(e_exact, abs=1e-5)
        assert row[10].real == pytest.approx(n_exact, abs=1e-6)


def test_thermal_golden_anchor_cpu_f64():
    g = np.load(GOLDEN)
    _, ham, _ = systems("hubbard")
    trial = make_one_body_trial(ham, float(g["beta"]), float(g["dt"]),
                                mu=float(g["mu"]), **CPU)
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]), nsteps=1,
                  nblocks=60, beta=float(g["beta"]), npop_control=2,
                  rng_seed=8)
    rows = tta.ThermalAFQMC(ham, trial, qmc, device="cpu").run()
    et, nav = rows[1:, 5].real, rows[1:, 10].real
    ref_e, ref_n = np.asarray(g["etotal"])[1:], np.asarray(g["nav"])[1:]
    se_e = np.hypot(et.std(ddof=1) / np.sqrt(len(et)),
                    ref_e.std(ddof=1) / np.sqrt(len(ref_e)))
    se_n = np.hypot(nav.std(ddof=1) / np.sqrt(len(nav)),
                    ref_n.std(ddof=1) / np.sqrt(len(ref_n)))
    assert abs(et.mean() - ref_e.mean()) < max(4 * se_e, 0.05), (
        et.mean(), ref_e.mean(), se_e)
    assert abs(nav.mean() - ref_n.mean()) < max(4 * se_n, 0.02), (
        nav.mean(), ref_n.mean(), se_n)


def h5_layout(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj.shape, obj.dtype.kind)
            if isinstance(obj, h5py.Dataset) else None))
        headers = [h.decode() for h in f["basic/headers"][()]]
        meta = json.loads(f["metadata"][()])
        rdm = f["basic/one_rdm/000000001"][()]
    return out, headers, meta, rdm


def test_h5_layout_matches_jax(tmp_path):
    """The same datasets (energies and, with one_rdm, the weighted 1-RDM
    of each row), headers and metadata sections as the JAX driver's file;
    the iteration-0 1-RDM (before any draw) equal to JAX's."""
    jham, ham, kw = systems("hubbard")
    opts = dict(nwalkers=4, dt=kw["dt"], nsteps=1, nblocks=1,
                beta=kw["beta"], npop_control=2, rng_seed=8)
    eopts = {"mixed": {"one_rdm": True}}
    jta.ThermalAFQMC(jham, j_mobt(jham, **kw), JQMCOpts(**opts),
                     estimator_options=eopts,
                     filename=str(tmp_path / "j.h5")).run()
    tta.ThermalAFQMC(ham, make_one_body_trial(ham, **kw, **CPU),
                     QMCOpts(**opts), estimator_options=eopts,
                     filename=str(tmp_path / "t.h5"), device="cpu").run()
    jl, jh, jm, jr = h5_layout(tmp_path / "j.h5")
    tl, th, tm, tr = h5_layout(tmp_path / "t.h5")
    assert tl == jl
    assert "basic/one_rdm/000000000" in tl
    with h5py.File(tmp_path / "j.h5") as fj, h5py.File(tmp_path / "t.h5") \
            as ft:
        np.testing.assert_allclose(ft["basic/one_rdm/000000000"][()],
                                   fj["basic/one_rdm/000000000"][()],
                                   atol=1e-12)
    assert tr.shape == jr.shape == (2, 9, 9)
    assert th == jh == tta.THERMAL_HEADER == jta.THERMAL_HEADER
    for section in ("system", "qmc", "propagators", "estimators"):
        assert tm[section] == jm[section], section


def test_thermal_options_match_jax():
    """beta, scaled_temperature and the reduced-unit conversion
    (theta = T / T_F) read and computed as in JAX."""
    inputs = {"beta": 2.0, "timestep": 0.05, "scaled_temperature": True,
              "nwalkers": 16}
    jq, q = JQMCOpts.from_dict(inputs), QMCOpts.from_dict(inputs)
    assert (q.beta, q.dt, q.scaled_temp, q.nwalkers) == (
        jq.beta, jq.dt, jq.scaled_temp, jq.nwalkers) == (2.0, 0.05, True, 16)
    jq.convert_from_reduced_units(j_make_ueg(nup=7, ndown=7, rs=1.0,
                                             ecut=1.0))
    q.convert_from_reduced_units(make_ueg(7, 7, rs=1.0, ecut=1.0, **CPU))
    assert (q.beta, q.dt, q.beta_scaled) == (jq.beta, jq.dt, jq.beta_scaled)
    assert q.beta_scaled == 2.0 and q.beta != 2.0


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the CPU-only machine's")
    with pytest.raises(RuntimeError):
        make_ueg(1, 1, rs=1.0, ecut=0.5)
    _, ham, kw = systems("hubbard")
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    with pytest.raises(RuntimeError):
        make_one_body_trial(ham, 0.5, 0.05, mu=0.9)
    with pytest.raises(RuntimeError):
        tta.ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05,
                                             beta=0.5))


@pytest.mark.parametrize("case", ["discrete", "low_rank", "average_gf",
                                  "no_beta", "generic"])
def test_unported_options_raise(case):
    _, ham, kw = systems("hubbard")
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    qmc = QMCOpts(nwalkers=2, dt=0.05, nsteps=1, nblocks=1, beta=0.5)
    kwargs = {}
    err = NotImplementedError
    if case == "discrete":
        kwargs["propagator_options"] = {"hubbard_stratonovich": "discrete"}
    elif case == "low_rank":
        kwargs["walker_options"] = {"low_rank": True}
    elif case == "average_gf":
        kwargs["estimator_options"] = {"mixed": {"average_gf": True}}
    elif case == "no_beta":
        qmc.beta, err = None, ValueError
    else:
        from pauxy_tpu_torch.propagation.thermal import (
            make_thermal_propagator)

        class FakeGeneric:
            name = "Generic"
            nbasis = 9
        with pytest.raises(NotImplementedError):
            make_thermal_propagator(FakeGeneric(), trial, 0.05, **CPU)
        return
    with pytest.raises(err):
        tta.ThermalAFQMC(ham, trial, qmc, device="cpu", **kwargs)


def test_thermal_path_imports_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models.ueg import make_ueg\n"
        "from pauxy_tpu_torch.models.thermal_trial import "
        "make_one_body_trial\n"
        "from pauxy_tpu_torch.qmc import QMCOpts\n"
        "from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC\n"
        "ham = make_ueg(1, 1, rs=1.0, ecut=0.5, device='cpu', "
        "dtype='double')\n"
        "trial = make_one_body_trial(ham, 0.1, 0.025, mu=0.245, "
        "device='cpu', dtype='double')\n"
        "ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.025, nsteps=1, "
        "nblocks=1, beta=0.1), device='cpu').run()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)
