"""The port's host surface: AFQMC's positional order (JAX's), h5lite's
chunked datasets crossed with h5py, the out-of-core Cholesky through
h5lite against JAX's, the split-mode phase table and the profile trace.
"""

import glob
import inspect
import json
import os
import sys

import h5py
import numpy as np
import pytest

from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.utils import h5lite

KW = dict(device="cpu", dtype="double")


def test_afqmc_positional_order_is_jax(tmp_path, monkeypatch):
    """The port's AFQMC takes (ham, trial, qmc, propagator_options,
    estimator_options, walker_options, verbose, filename) as JAX's does:
    a JAX-style positional call with write_freq writes the checkpoint."""
    from pauxy_tpu.qmc import AFQMC as JAFQMC

    jax_names = list(inspect.signature(JAFQMC.__init__).parameters)[1:9]
    port_names = list(inspect.signature(AFQMC.__init__).parameters)[1:9]
    assert port_names == jax_names
    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **KW)
    qmc = QMCOpts(nwalkers=8, dt=0.05, nsteps=4, nblocks=2, nstblz=2,
                  npop_control=2, rng_seed=1)
    ck = str(tmp_path / "ck.h5")
    af = AFQMC(ham, free_electron_trial(ham, **KW), qmc, None,
               {"mixed": {"energy_eval_freq": 4}},
               {"write_freq": 1, "write_file": ck}, False,
               str(tmp_path / "est.h5"), device="cpu")
    assert af.verbose is False and af.write_freq == 1
    af.run()
    with h5py.File(ck, "r") as fh5:
        assert fh5["step"][()] == 8
    assert os.path.exists(tmp_path / "est.h5")


CHUNK_CASES = [((10, 7), (4, 3), "f8"), ((300, 5), (2, 5), "f8"),
               ((5000,), (7,), "i8"), ((3, 4, 5), (2, 2, 2), "c16"),
               ((6, 6), (6, 6), "f4"), ((0, 4), (1, 4), "f8")]


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "c16":
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if dtype == "i8":
        return rng.integers(0, 100, size=shape)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("shape,chunks,dtype", CHUNK_CASES)
def test_h5lite_chunked_crosses_h5py(tmp_path, shape, chunks, dtype):
    """h5lite's chunked datasets (the chunk B-tree grows a level past 64
    chunks) open in h5py, and h5py's open in h5lite."""
    a = _data(shape, dtype)
    lite, py = str(tmp_path / "lite.h5"), str(tmp_path / "py.h5")
    with h5lite.File(lite, "w") as fh:
        ds = fh.create_dataset("x", shape, a.dtype, chunks=chunks,
                               maxshape=(None,) * len(shape))
        ds[...] = a
        fh["plain"] = np.arange(3)
    with h5py.File(lite, "r") as fh:
        assert fh["x"].chunks == chunks
        assert fh["x"].maxshape == (None,) * len(shape)
        np.testing.assert_array_equal(fh["x"][...], a)
        np.testing.assert_array_equal(fh["plain"][...], np.arange(3))
    with h5py.File(py, "w") as fh:
        fh.create_dataset("x", data=a, chunks=chunks,
                          maxshape=(None,) * len(shape))
    with h5lite.File(py, "r") as fh:
        assert fh["x"].chunks == chunks
        np.testing.assert_array_equal(fh["x"][...], a)


def test_h5lite_chunked_resize_and_append(tmp_path):
    """Rows written one by one, a shrinking resize, a row rewritten on
    reopening with "a", then h5py growing the dataset h5lite wrote."""
    f = str(tmp_path / "rs.h5")
    with h5lite.File(f, "w") as fh:
        ds = fh.create_dataset("c", (40, 9), "f8", chunks=(16, 9))
        for r in range(23):
            ds[r] = r
        ds.resize((23, 9))
        with pytest.raises(ValueError, match="maxshape"):
            ds.resize((41, 9))
        with pytest.raises(TypeError, match="chunked"):
            fh.create_dataset("flat", (3,), "f8").resize((2,))
    with h5py.File(f, "r") as fh:
        assert fh["c"].shape == (23, 9) and fh["c"].maxshape == (40, 9)
        np.testing.assert_array_equal(fh["c"][:, 0], np.arange(23))
    with h5lite.File(f, "a") as fh:
        fh["c"][0] = -1
        fh["new"] = np.ones(2)
    with h5py.File(f, "a") as fh:
        assert fh["c"][0, 0] == -1 and "new" in fh
        fh["c"].resize((30, 9))
        fh["c"][29] = 5
    with h5lite.File(f, "r") as fh:
        c = fh["c"][...]
    assert c.shape == (30, 9) and c[29, 0] == 5 and c[0, 0] == -1
    assert not c[23:29].any()


def test_h5lite_refuses_filtered_chunks(tmp_path):
    """h5lite reads deflate, shuffle and fletcher32; a chunk through any
    other filter (h5py's lzf here) raises, naming the filter's id, when it
    is read; the file's other datasets still read."""
    f = str(tmp_path / "z.h5")
    with h5py.File(f, "w") as fh:
        fh.create_dataset("z", data=np.ones((8, 8)), chunks=(4, 4),
                          compression="lzf")
        fh["plain"] = np.arange(3)
    with h5lite.File(f, "r") as fh:
        np.testing.assert_array_equal(fh["plain"][...], np.arange(3))
        with pytest.raises(NotImplementedError, match="32000"):
            fh["z"][...]


@pytest.mark.parametrize("writer", ["h5lite", "h5py"])
def test_chunked_cholesky_outcore_matches_jax(tmp_path, monkeypatch,
                                               writer):
    """The out-of-core Cholesky through h5lite.open_file (h5lite itself
    when h5py does not import) equals JAX's, which writes with h5py, in
    float64 to 1e-12; either file reads in h5py."""
    from pauxy_tpu.utils import from_pyscf as jfp
    from pauxy_tpu_torch.utils import from_pyscf as tfp

    rng = np.random.default_rng(5)
    nao = 6
    a = rng.normal(size=(nao * nao, 9))
    eri = (a @ a.T).reshape(nao, nao, nao, nao)
    jf, tf = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    nj = jfp.chunked_cholesky_outcore(eri, jf, max_error=1e-9, chunk_rows=3)
    if writer == "h5lite":
        monkeypatch.setitem(sys.modules, "h5py", None)
    nt = tfp.chunked_cholesky_outcore(eri, tf, max_error=1e-9, chunk_rows=3)
    monkeypatch.undo()
    assert nt == nj
    with h5py.File(jf, "r") as fj, h5py.File(tf, "r") as ft:
        assert ft["chol_outcore"].shape == (nt, nao * nao)
        np.testing.assert_allclose(ft["chol_outcore"][...],
                                   fj["chol_outcore"][...], rtol=0,
                                   atol=1e-12)
    src = inspect.getsource(tfp.chunked_cholesky_outcore)
    assert "import h5py" not in src


def _split_run(hs, tmp_path, **kw):
    ham = make_hubbard(2, 2, U=4.0, nx=4, ny=1, **KW)
    qmc = QMCOpts(nwalkers=8, dt=0.05, nsteps=4, nblocks=2, nstblz=2,
                  npop_control=2, rng_seed=1)
    return AFQMC(ham, free_electron_trial(ham, **KW), qmc,
                 propagator_options={"hubbard_stratonovich": hs},
                 estimator_options={"mixed": {"energy_eval_freq": 4}},
                 filename=str(tmp_path / f"{hs}.h5"), device="cpu", **kw)


@pytest.mark.parametrize("hs", ["continuous", "discrete"])
def test_split_mode_prints_jax_table(tmp_path, monkeypatch, capsys, hs):
    """block_mode="split" (the lanes block with the continuous propagator,
    the generic block with the discrete one) times each phase and prints
    JAX's table (pauxy_tpu/qmc/afqmc.py:1054-1075); PAUXY_TPU_SPLIT=1
    selects it too; the timers leave the rows as the default block's."""
    monkeypatch.chdir(tmp_path)
    af = _split_run(hs, tmp_path, block_mode="split")
    assert af.use_fast_block == (hs == "continuous")
    rows = af.run()
    af.finalise()
    out = capsys.readouterr().out.splitlines()
    table = [line for line in out if line.startswith("# ")][-7:]
    assert table[0].startswith("# Running time : ")
    assert table[1] == "# Timing breakdown (per step):"
    for line, head in zip(table[2:], ("Setup", "Orthogonalisation",
                                      "Propagation", "Population control",
                                      "Estimators")):
        assert line.startswith(f"# - {head}: ") and line.endswith(" s")
    assert af.timing["prop"] > 0 and af.timing["setup"] > 0
    assert af.timing["ortho"] > 0 and af.timing["estim"] > 0
    parts = sum(af.timing[k] for k in ("ortho", "prop", "pop", "estim"))
    assert parts <= af.timing["block"]
    default = _split_run(hs, tmp_path)
    assert default.block_mode == "fused"
    np.testing.assert_array_equal(default.run()[:, :10], rows[:, :10])
    assert default.timing["prop"] == 0.0
    monkeypatch.setenv("PAUXY_TPU_SPLIT", "1")
    assert _split_run(hs, tmp_path).block_mode == "split"
    with pytest.raises(ValueError, match="block_mode"):
        _split_run(hs, tmp_path, block_mode="pipelined")


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir: the whole run() as one torch.profiler trace (Chrome
    trace format), with the block's operations in it."""
    d = str(tmp_path / "trace")
    af = _split_run("continuous", tmp_path, profile_dir=d)
    af.run()
    files = glob.glob(os.path.join(d, "trace.*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
