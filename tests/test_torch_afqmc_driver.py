"""Port driver tests: the golden statistical anchor, h5 layout, import
hygiene and the unsupported-configuration guard.

The golden series (tests/data/hubbard4x4_uhf_continuous.npz) comes from the
reference implementation run serially with the same UHF trial; the port's
random stream differs, so its equilibrated mean must agree statistically:
|diff| < max(4 se, 0.05), the test of tests/test_afqmc_driver.py.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from pauxy_tpu.models import free_electron_trial as j_free_electron
from pauxy_tpu.models import make_hubbard as j_make_hubbard
from pauxy_tpu.qmc import AFQMC as JAFQMC
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu_torch.models import (free_electron_trial, make_hubbard,
                                    trial_from_orbitals)
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "hubbard4x4_uhf_continuous.npz")
CPU = dict(device="cpu", dtype="double")


def test_hubbard_4x4_uhf_vs_reference_golden():
    g = np.load(GOLDEN)
    ham = make_hubbard(7, 7, U=4.0, nx=4, ny=4, **CPU)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), **CPU)
    assert trial.etrial == pytest.approx(float(np.real(g["etrial"])),
                                         abs=1e-6)
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    rows = af.run()
    assert rows.shape == (100, 11) and np.isfinite(rows.real).all()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                  theirs.std(ddof=1) / np.sqrt(len(theirs)))
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.05), (mine.mean(), theirs.mean(), se)
    weights = rows[:, 2].real
    assert np.all(weights > 20) and np.all(weights < 80), weights


def test_h5_layout_matches_jax_driver(tmp_path):
    kw = dict(nwalkers=10, dt=0.01, nsteps=5, nblocks=3, rng_seed=2)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    jham = j_make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    JAFQMC(jham, j_free_electron(jham), JQMCOpts(**kw),
           estimator_options=eopts,
           filename=str(tmp_path / "jax.h5")).run()
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    AFQMC(ham, free_electron_trial(ham, **CPU), QMCOpts(**kw),
          estimator_options=eopts, filename=str(tmp_path / "port.h5"),
          device="cpu").run()

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


def test_no_file_without_filename(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    af = AFQMC(ham, free_electron_trial(ham, **CPU),
               QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=2, rng_seed=1),
               device="cpu")
    rows = af.run()
    assert rows.shape == (2, 11) and os.listdir(tmp_path) == []
    assert len(af.block_seconds) == 2


@pytest.mark.parametrize("popts,eopts", [
    ({"hubbard_stratonovich": "discrete"}, None),
    ({"free_projection": True}, None),
    ({"hybrid": False}, None),
    (None, {"back_propagation": {"tau_bp": 0.05}}),
    (None, {"mixed": {"one_rdm": True}}),
])
def test_unported_configurations_raise(popts, eopts):
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, **CPU)
    with pytest.raises(NotImplementedError):
        AFQMC(ham, free_electron_trial(ham, **CPU),
              QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1),
              propagator_options=popts, estimator_options=eopts,
              device="cpu")


def test_options_from_dict_matches_jax():
    d = {"num_walkers": 64, "timestep": 0.02, "blocks": 7,
         "stabilise_freq": 5, "pop_control_method": "pair_branch",
         "rng_seed": 3}
    port = QMCOpts.from_dict(d)
    ref = JQMCOpts.from_dict(d)
    assert port.__dict__ == {k: ref.__dict__[k] for k in port.__dict__}
    assert port.neqlb == ref.neqlb


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pauxy_tpu_torch, pauxy_tpu_torch.qmc, "
        "pauxy_tpu_torch.utils.convert, pauxy_tpu_torch.ops.greens_cuda, "
        "pauxy_tpu_torch.ops.batchla_cuda\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pauxy_tpu', "
        "'h5py', 'pandas')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
