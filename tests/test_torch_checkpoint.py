"""Walker restart, the driver's output readers and the analysis package.

* ``utils/checkpoint``: the save/load round trip (h5py and the port's
  h5lite), a file the JAX package wrote loads (walkers, step and eshift;
  the stream starts afresh, said by a warning), a template's missing
  optional fields stay missing;
* a run split by a checkpoint (2 blocks, ``write_file``, a new driver with
  ``read_file``, 1 block) equals the straight 3-block run exactly on the
  CPU, for the Generic and the lanes Hubbard blocks;
* ``AFQMC.get_energy`` / ``get_one_rdm`` / ``finalise``, and the JAX
  package's readers on the port's file;
* the analysis copies against ``pauxy_tpu.analysis`` on one file: the
  same output.
"""

import dataclasses

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from pauxy_tpu.analysis import autocorr as jautocorr
from pauxy_tpu.analysis import blocking as jblocking
from pauxy_tpu.analysis import correlation as jcorrelation
from pauxy_tpu.analysis import extraction as jextraction
from pauxy_tpu.analysis import rdm as jrdm
from pauxy_tpu.analysis import thermal as jthermal
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.utils import checkpoint as jcheckpoint
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.analysis import autocorr, blocking, correlation, \
    extraction, rdm, thermal
from pauxy_tpu_torch.models import (free_electron_trial, make_generic,
                                    make_hubbard, make_one_body_trial,
                                    rhf_identity_trial)
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts, ThermalAFQMC
from pauxy_tpu_torch.utils import checkpoint, h5lite
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")


@pytest.fixture(params=["h5py", "h5lite"])
def backend(request, monkeypatch):
    if request.param == "h5lite":
        monkeypatch.setattr(h5lite, "open_file", h5lite.File)
    return request.param


def generic(seed=21):
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=seed)
    ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    return ham, rhf_identity_trial(ham, **CPU), (h1e, chol, enuc)


def assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.dtype == y.dtype, f.name
            assert torch.equal(x, y), f.name


def test_save_load_round_trip(tmp_path, backend):
    ham, trial, _ = generic()
    state = init_walkers(trial, 6, nprop_tot=3, nfields=ham.nfields)
    gen = torch.Generator()
    gen.manual_seed(5)
    torch.rand(7, generator=gen)
    state = dataclasses.replace(
        state, phia=state.phia + 0.1j * torch.rand(state.phia.shape,
                                                   dtype=torch.float64,
                                                   generator=gen),
        weight=torch.rand(6, dtype=torch.float64, generator=gen))
    fn = str(tmp_path / "restart.h5")
    checkpoint.save_walkers(state, fn, generator=gen, step=40, eshift=-1.25,
                            extra={"note": np.arange(3)})
    template = init_walkers(trial, 6, nprop_tot=3, nfields=ham.nfields)
    got, info = checkpoint.load_walkers(template, fn)
    assert_states_equal(got, state)
    assert info["step"] == 40 and info["eshift"] == -1.25
    assert info["jax_rng_key"] is None
    assert torch.equal(info["rng_state"], gen.get_state())
    with h5py.File(fn, "r") as f:
        assert "phia__re" in f["walkers"] and "weight" in f["walkers"]
        assert f["state_class"][()] in (b"WalkerState", "WalkerState")
        np.testing.assert_array_equal(f["extra/note"][:], np.arange(3))
    # A template without the BP buffers takes only what it carries.
    small, _ = checkpoint.load_walkers(init_walkers(trial, 6), fn)
    assert small.configs is None
    assert torch.equal(small.phia, state.phia)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_walkers(init_walkers(trial, 4), fn)


def test_jax_written_checkpoint_loads(tmp_path, backend):
    ham, trial, (h1e, chol, enuc) = generic()
    jham = j_make_generic((2, 2), h1e, chol, enuc)
    jt = jtrial.rhf_identity_trial(jham)
    js = j_init_walkers(jt, 6, total_weight=6.0)
    js = js.replace(weight=js.weight * np.linspace(0.5, 1.5, 6),
                    log_ovlp=js.log_ovlp + 0.3j)
    import jax

    fn = str(tmp_path / "jax.h5")
    jcheckpoint.save_walkers(js, fn, key=jax.random.key(3), step=30,
                             eshift=-2.5)
    got, info = checkpoint.load_walkers(init_walkers(trial, 6), fn)
    for f in ("phia", "phib", "weight", "log_ovlp", "total_weight",
              "phase", "eloc", "hybrid_energy"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert info["rng_state"] is None and info["jax_rng_key"] is not None
    assert (info["step"], info["eshift"]) == (30, -2.5)
    qmc = QMCOpts(nwalkers=6, dt=0.01, nsteps=5, nblocks=1, rng_seed=4)
    with pytest.warns(UserWarning, match="starts afresh"):
        af = AFQMC(ham, trial, qmc, walker_options={"read_file": fn},
                   device="cpu")
    assert af.step == 30 and af.eshift == -2.5
    np.testing.assert_array_equal(af.state.weight.numpy(),
                                  np.asarray(js.weight))
    assert np.isfinite(af.run().real).all()


def driver(kind, tmp_path, name, **wopts):
    qmc = QMCOpts(nwalkers=10, dt=0.01 if kind == "generic" else 0.05,
                  nsteps=4, nblocks=3, nstblz=2, npop_control=1, rng_seed=7)
    if kind == "generic":
        ham, trial, _ = generic(seed=3)
    else:
        ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
        trial = free_electron_trial(ham, **CPU)
    return AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 filename=str(tmp_path / f"{name}.h5"), walker_options=wopts,
                 device="cpu")


@pytest.mark.parametrize("kind", ["generic", "hubbard_lanes"])
def test_split_run_equals_straight_run(tmp_path, backend, kind):
    straight = driver(kind, tmp_path, "straight")
    assert straight.use_fast_block == (kind == "hubbard_lanes")
    rows = [straight.run_block() for _ in range(3)]
    restart = str(tmp_path / "restart.h5")
    first = driver(kind, tmp_path, "first", write_freq=2, write_file=restart)
    for _ in range(2):
        first.run_block()
    second = driver(kind, tmp_path, "second", read_file=restart)
    assert second.step == 8
    row = second.run_block()
    np.testing.assert_array_equal(row[:10], rows[2][:10])
    assert_states_equal(second.state, straight.state)
    assert torch.equal(second.generator.get_state(),
                       straight.generator.get_state())


def test_get_energy_one_rdm_and_finalise(tmp_path, backend, capsys):
    ham, trial, _ = generic(seed=9)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=4, nblocks=12, rng_seed=2)
    fn = str(tmp_path / "est.h5")
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1,
                                            "one_rdm": True}},
               filename=fn, verbose=True, device="cpu")
    rows = af.run()
    out = capsys.readouterr().out
    assert "# - Setup:" in out and "# - Blocks: 12" in out
    assert af.timing["setup"] > 0 and len(af.block_seconds) == 12
    mean, err = af.get_energy(skip=2)
    s = blocking.reblock_summary(rows[2:, 5].real)
    assert (mean, err) == (float(s["mean"]), float(s["standard error"]))
    frame = jextraction.extract_mixed_estimates(fn, 2)
    js = jblocking.reblock_summary(np.asarray(frame.ETotal.values,
                                              dtype=complex).real)
    assert mean == float(js["mean"]) and err == float(js["standard error"])
    av, aerr = af.get_one_rdm()
    jav, jaerr = jblocking.average_rdm(fn, skip=1, est_type="basic", ix=None)
    np.testing.assert_array_equal(av, jav)
    np.testing.assert_array_equal(aerr, jaerr)
    assert av.shape == (2, 6, 6)
    np.testing.assert_allclose(np.trace(av[0]).real, 2.0, atol=1e-10)
    af.filename = str(tmp_path / "missing.h5")
    with pytest.raises(FileNotFoundError):
        af.get_energy()
    af.filename = None
    assert af.get_energy() is None and af.get_one_rdm() is None


def test_analysis_copies_match_jax(tmp_path, backend, monkeypatch):
    """Each module of the port's analysis/ against pauxy_tpu.analysis on
    the same files: a Hubbard run with back propagation and the mixed
    one_rdm, and a thermal run."""
    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    fn = str(tmp_path / "bp.h5")
    AFQMC(ham, free_electron_trial(ham, **CPU),
          QMCOpts(nwalkers=10, dt=0.05, nsteps=4, nblocks=16, rng_seed=3),
          propagator_options={"hubbard_stratonovich": "discrete"},
          estimator_options={"mixed": {"energy_eval_freq": 1,
                                       "one_rdm": True},
                             "back_propagation": {"tau_bp": 0.2,
                                                  "nsplit": 2}},
          filename=fn, device="cpu").run()
    tfn = str(tmp_path / "thermal.h5")
    ThermalAFQMC(ham, make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU),
                 QMCOpts(nwalkers=8, dt=0.05, nsteps=1, nblocks=6, beta=0.5,
                         rng_seed=3),
                 filename=tfn, device="cpu").run()

    def same(a, b):
        if isinstance(a, pd.DataFrame):
            pd.testing.assert_frame_equal(a, b)
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    frame = extraction.extract_mixed_estimates(fn)
    series = frame.ETotal.values.real
    calls = [
        (extraction, jextraction, "get_metadata", (fn,)),
        (extraction, jextraction, "extract_mixed_estimates", (fn, 2)),
        (extraction, jextraction, "extract_data",
         (fn, "back_propagated", "energies_4", True)),
        (extraction, jextraction, "extract_rdm", (fn,)),
        (extraction, jextraction, "extract_rdm", (fn, "basic", "one_rdm")),
        (blocking, jblocking, "reblock_series", (series,)),
        (blocking, jblocking, "reblock_summary", (series,)),
        (blocking, jblocking, "reblock_mixed", (frame, 2)),
        (blocking, jblocking, "average_fp", (frame,)),
        (blocking, jblocking, "analyse_energy", (fn, 2)),
        (blocking, jblocking, "average_rdm", (fn,)),
        (autocorr, jautocorr, "autocorr_func_1d", (series,)),
        (autocorr, jautocorr, "integrated_time", (series,)),
        (autocorr, jautocorr, "reblock_by_autocorr", (series,)),
        (correlation, jcorrelation, "correlation_function", (fn, 3, 3)),
        (rdm, jrdm, "analyse_one_body", (fn, ham.T.numpy()[0])),
        (rdm, jrdm, "average_rdm", (fn,)),
        (thermal, jthermal, "analyse_energy", (tfn,)),
    ]
    for tmod, jmod, name, args in calls:
        same(getattr(tmod, name)(*args), getattr(jmod, name)(*args))
    out = blocking.analyse_estimates(fn)
    with h5py.File("analysed_bp.h5", "r") as f:
        port = f["basic/estimates"][:]
    jout = jblocking.analyse_estimates(fn)
    same(out, jout)
    with h5py.File("analysed_bp.h5", "r") as f:
        np.testing.assert_array_equal(port, f["basic/estimates"][:])
