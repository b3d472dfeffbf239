"""Sharded walker checkpoints of the port (``utils/checkpoint.py``):
``tests/test_checkpoint_sharded.py``'s four cases on 2 gloo ranks of this
machine (the round trip on the mesh, a sharded save restored densely, the
driver resuming, an incomplete directory raising), and the directories
crossed with the JAX package's: a JAX-written one (JAX on a 2-device CPU
mesh) restored in the port, and a port-written one read by JAX's dense
``load_walkers_sharded``. The ranks run once per file.
"""

import glob
import os
import warnings

import h5py
import jax
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from pauxy_tpu_torch.parallel import launch
from pauxy_tpu_torch.utils.checkpoint import (load_walkers_sharded,
                                              save_walkers_sharded)
from pauxy_tpu_torch.walkers import init_walkers

NRANKS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    return tmp, launch.run_ranks(cases.checkpoint_rank, NRANKS, tmp,
                                 timeout=120.0)


def test_sharded_roundtrip_on_mesh(ranks):
    tmp, outs = ranks
    files = sorted(glob.glob(os.path.join(tmp, "rt", "shard_*.h5")))
    assert [os.path.basename(f) for f in files] == [
        "shard_00000000.h5", "shard_00000008.h5"]
    assert os.path.exists(os.path.join(tmp, "rt", "meta.h5"))
    for out in outs:
        assert all(out["roundtrip"].values()), out["roundtrip"]
        assert out["info"] == (70, -1.25, True)
        assert out["nlocal"] == 16 // NRANKS


def test_sharded_save_dense_restore(ranks):
    """Without a mesh the shards are concatenated (an elastic restart onto
    one rank)."""
    tmp, _ = ranks
    trial, state = cases.random_state()
    restored, info = load_walkers_sharded(init_walkers(trial, 16),
                                          os.path.join(tmp, "dense"))
    for name in ("phia", "phib", "weight", "log_ovlp"):
        assert torch.equal(getattr(restored, name), getattr(state, name))
    assert (info["step"], info["eshift"]) == (5, 0.5)


def test_driver_resumes_from_sharded_checkpoint(ranks):
    """2 blocks, a sharded checkpoint, a fresh driver and 1 block equal 3
    blocks straight (the generator state travels in meta.h5), by hand and
    through write_freq / read_file."""
    _, outs = ranks
    for out in outs:
        full, resumed, opts = out["rows"]
        np.testing.assert_allclose(resumed, full, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(opts, full, rtol=1e-8, atol=1e-10)


def test_incomplete_checkpoint_raises(tmp_path):
    """A field missing from some (not all) shard files is a truncated
    checkpoint: both the mesh load and the dense one raise."""
    trial, state = cases.random_state()
    d = str(tmp_path / "ckpt")
    for c in range(2):
        save_walkers_sharded_as(state, d, _mesh_of(c))
    victim = sorted(glob.glob(d + "/shard_*.h5"))[-1]
    with h5py.File(victim, "a") as fh5:
        del fh5["weight"]
    with pytest.raises(ValueError, match="incomplete"):
        load_walkers_sharded(init_walkers(trial, 8), d, mesh=_mesh_of(0))
    with pytest.raises(ValueError, match="incomplete"):
        load_walkers_sharded(init_walkers(trial, 16), d, mesh=None)
    os.remove(victim)
    with pytest.raises(ValueError, match="incomplete"):
        load_walkers_sharded(init_walkers(trial, 16), d, mesh=None)


def _mesh_of(coord):
    from pauxy_tpu_torch.parallel import mesh as pmesh

    return pmesh.Mesh(shape=(2, 1), coords=(coord, 0), groups={},
                      device=torch.device("cpu"))


def save_walkers_sharded_as(state, d, mesh):
    """Rank ``mesh.coords[0]``'s save, made in this process."""
    from pauxy_tpu_torch.parallel import mesh as pmesh

    local = pmesh.shard_walkers(state, mesh)
    try:
        save_walkers_sharded(local, d, step=1, eshift=0.0)
    finally:
        pmesh.set_active_mesh(None)


def _jax_state(nw=16):
    from pauxy_tpu.models import free_electron_trial, make_hubbard
    from pauxy_tpu.walkers import init_walkers as jinit

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    state = jinit(trial, nw)
    k = jax.random.key(3)
    return trial, state.replace(
        phia=state.phia + 0.1 * jax.random.normal(k, state.phia.shape),
        weight=jax.random.uniform(jax.random.fold_in(k, 1), (nw,),
                                  dtype=state.weight.dtype) + 0.5)


def test_jax_written_sharded_checkpoint_restores(tmp_path):
    """JAX on a 2-device CPU mesh writes the directory; the port restores
    the walkers, step and eshift (densely, and each rank's half on a
    mesh), and a driver reading it starts a fresh stream with a warning."""
    from pauxy_tpu.parallel import mesh as jmesh
    from pauxy_tpu.utils.checkpoint import save_walkers_sharded as jsave

    _, jstate = _jax_state()
    m = jmesh.walker_mesh(jax.devices()[:2])
    d = str(tmp_path / "jax")
    try:
        jsave(jmesh.shard_walkers(jstate, m), d, key=jax.random.key(99),
              step=70, eshift=-1.25)
    finally:
        jmesh.set_active_mesh(None)
    assert len(glob.glob(d + "/shard_*.h5")) == 2
    trial, _ = cases.random_state()
    restored, info = load_walkers_sharded(init_walkers(trial, 16), d)
    for name in ("phia", "phib", "weight", "log_ovlp"):
        np.testing.assert_array_equal(getattr(restored, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    assert (info["step"], info["eshift"]) == (70, -1.25)
    assert info["rng_state"] is None and info["jax_rng_key"] is not None
    half, _ = load_walkers_sharded(init_walkers(trial, 8), d,
                                   mesh=_mesh_of(1))
    np.testing.assert_array_equal(half.phia.numpy(),
                                  np.asarray(jstate.phia)[8:])
    with pytest.warns(UserWarning, match="starts afresh"):
        af = cases.resume_driver(1, {"read_file": d})
    assert (af.step, af.eshift) == (70, -1.25)
    np.testing.assert_array_equal(af.state.weight.numpy(),
                                  np.asarray(jstate.weight))


def test_port_written_sharded_checkpoint_reads_in_jax(ranks):
    """The port's directory (2 ranks) through JAX's dense
    load_walkers_sharded."""
    from pauxy_tpu.utils.checkpoint import load_walkers_sharded as jload

    tmp, _ = ranks
    jtrial, _ = _jax_state()
    from pauxy_tpu.walkers import init_walkers as jinit

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restored, info = jload(jinit(jtrial, 16), os.path.join(tmp, "dense"))
    _, state = cases.random_state()
    for name in ("phia", "phib", "weight", "log_ovlp"):
        np.testing.assert_array_equal(np.asarray(getattr(restored, name)),
                                      getattr(state, name).numpy())
    assert (info["step"], info["eshift"]) == (5, 0.5)
