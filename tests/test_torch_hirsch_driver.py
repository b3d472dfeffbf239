"""Port driver tests for the discrete-HS (Hirsch) CPMC path.

* the golden statistical anchor: UHF orbitals of
  tests/data/hubbard4x4_uhf_discrete.npz, 40 walkers, 100 blocks, CPU
  float64; the reference's random stream differs from the port's, so the
  equilibrated means must agree statistically: |diff| < max(4 se, 0.05),
  the test of tests/test_hirsch.py;
* uhf_trial's orbitals and energy equal to JAX's for the same seed, 1e-10;
* the HDF5 layout equal to the JAX driver's for the same discrete run;
* the device rule: device=None means the card and raises without one;
* importing and running the port alone pulls in no jax (subprocess).
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.qmc import AFQMC as JAFQMC
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu_torch.models import (free_electron_trial, make_hubbard,
                                    trial_from_orbitals, uhf_trial)
from pauxy_tpu_torch.models.trial import checkerboard_guess
from pauxy_tpu_torch.propagation.hirsch import Hirsch
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "hubbard4x4_uhf_discrete.npz")
CPU = dict(device="cpu", dtype="double")
DISCRETE = {"hubbard_stratonovich": "discrete"}


def test_hubbard_4x4_discrete_vs_reference_golden():
    g = np.load(GOLDEN)
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, **CPU)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), **CPU)
    assert trial.etrial == pytest.approx(float(np.real(g["etrial"])),
                                         abs=1e-6)
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc, propagator_options=DISCRETE,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    assert isinstance(af.prop, Hirsch) and af.prop.sweep_kernel == "kernel"
    assert af.hybrid is False and not af.use_fast_block
    rows = af.run()
    assert rows.shape == (100, 11) and np.isfinite(rows.real).all()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                  theirs.std(ddof=1) / np.sqrt(len(theirs)))
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.05), (mine.mean(), theirs.mean(), se)


@pytest.mark.parametrize("kw", [
    dict(nup=7, ndown=7, nx=4, ny=4, seed=7, ninitial=3, nconv=300),
    dict(nup=3, ndown=2, nx=3, ny=3, seed=1, ninitial=2, nconv=200,
         ueff=0.8),
    dict(nup=7, ndown=7, nx=4, ny=4, initial="checkerboard"),
])
def test_uhf_trial_matches_jax(kw):
    kw = dict(kw)
    sizes = {k: kw.pop(k) for k in ("nup", "ndown", "nx", "ny")}
    jh = j_make_hubbard(U=4.0, **sizes)
    jt = jtrial.uhf_trial(jh, **kw)
    th = make_hubbard(sizes["nup"], sizes["ndown"], U=4.0, nx=sizes["nx"],
                      ny=sizes["ny"], **CPU)
    tt = uhf_trial(th, **kw, **CPU)
    np.testing.assert_allclose(tt.psia.numpy(), jt.psia, atol=1e-10)
    np.testing.assert_allclose(tt.psib.numpy(), jt.psib, atol=1e-10)
    assert tt.etrial == pytest.approx(jt.etrial, abs=1e-10)
    assert tt.name == jt.name == "uhf"


def test_checkerboard_guess_matches_jax():
    np.testing.assert_array_equal(checkerboard_guess(16, 7, 6, 4, 4),
                                  jtrial.checkerboard_guess(16, 7, 6, 4, 4))


def test_h5_layout_matches_jax_driver(tmp_path):
    kw = dict(nwalkers=10, dt=0.01, nsteps=5, nblocks=3, rng_seed=2)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    jham = j_make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    JAFQMC(jham, jtrial.free_electron_trial(jham), JQMCOpts(**kw),
           propagator_options=DISCRETE, estimator_options=eopts,
           filename=str(tmp_path / "jax.h5")).run()
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    AFQMC(ham, free_electron_trial(ham, **CPU), QMCOpts(**kw),
          propagator_options=DISCRETE, estimator_options=eopts,
          filename=str(tmp_path / "port.h5"), device="cpu").run()

    def layout(path):
        names = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: names.__setitem__(
                n, (o.shape, o.dtype.kind) if isinstance(o, h5py.Dataset)
                else None))
            headers = list(f["basic/headers"][()])
        return names, headers

    assert layout(tmp_path / "port.h5") == layout(tmp_path / "jax.h5")
    with h5py.File(tmp_path / "port.h5", "r") as f:
        row = f["basic/energies/000000002"][()]
    assert row.shape == (11,) and row[0].real == 15
    assert np.isfinite(row.real).all()


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    trial = free_electron_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AFQMC(ham, trial, qmc, propagator_options=DISCRETE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.hubbard(np.zeros((2, 4, 4)), 4.0, False, nx=2, ny=2, nup=2,
                        ndown=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uhf_trial(ham, initial="checkerboard")
    rows = AFQMC(ham, trial, qmc, propagator_options=DISCRETE,
                 device="cpu").run()
    assert np.isfinite(rows.real).all()


def test_discrete_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from pauxy_tpu_torch.models import make_hubbard, uhf_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, device='cpu', "
        "dtype='double')\n"
        "trial = uhf_trial(ham, ninitial=1, nconv=50, seed=3, device='cpu',"
        " dtype='double')\n"
        "rows = AFQMC(ham, trial, QMCOpts(nwalkers=8, dt=0.01, nsteps=4, "
        "nblocks=2, nstblz=2), propagator_options={'hubbard_stratonovich':"
        " 'discrete'}, device='cpu').run()\n"
        "assert rows.shape == (2, 11)\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
