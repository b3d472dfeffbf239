"""The port's walker mesh at zero temperature: each case of
``tests/test_multidevice.py`` (continuous lanes, comb across ranks,
pair_branch, discrete Hirsch on both sweep routes, free projection, GHF,
back propagation, ITCF, the kernel dispatch, the lanes block's "shard"
route) on 4 gloo ranks of this machine, held against the port's one-rank
run at rtol 1e-8 in float64; comb across ranks also against JAX's
``pop_control.comb`` with JAX's uniform injected. The one-rank and the
sharded runs of the whole file run once (``torch_mesh_harness``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
import torch_mesh_harness as harness
from pauxy_tpu_torch.parallel import mesh as pmesh

NAMES = ("continuous", "comb_gather", "pair_branch", "discrete",
         "sweep_kernel", "free_projection", "ghf", "back_propagation",
         "itcf", "kernel_dispatch", "fast_block_shard")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return harness.sharded_and_one_rank(NAMES, tmp_path_factory.mktemp("m"))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_one_rank(name, runs):
    ref, ranks = runs
    assert len(ranks) == harness.NRANKS
    for got in ranks:
        harness.assert_same(ref[name], got[name])


def test_comb_gather_matches_jax(runs):
    """All the weight on walker 3 (rank 0's): every slot of every rank
    takes walker 3 and weight 1, as JAX's comb gives with the same
    uniform (JAX's draw from key 0)."""
    from pauxy_tpu.models import free_electron_trial, make_hubbard
    from pauxy_tpu.walkers import init_walkers
    from pauxy_tpu.walkers import pop_control as jpc

    key = jax.random.key(0)
    assert float(jax.random.uniform(key, (), dtype=jnp.float64)) == \
        cases.COMB_UNIFORM
    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    state = init_walkers(free_electron_trial(ham), 16)
    w = np.full(16, 1e-6)
    w[3] = 1.0
    state = state.replace(
        phia=state.phia.at[:, 0, 0].set(jnp.arange(16, dtype=state.phia.dtype)),
        weight=jnp.asarray(w, state.weight.dtype))
    out = jpc.comb(state, key, 16.0)
    want = np.stack([np.asarray(out.phia[:, 0, 0]).real,
                     np.asarray(out.weight)])
    assert np.all(want[0] == 3)
    for got in runs[1]:
        np.testing.assert_array_equal(got["comb_gather"], want)


def test_shard_walkers_checks_divisibility():
    """W not a multiple of the walker-axis size raises JAX's ValueError;
    the active mesh is registered only by a successful call."""
    state = cases.comb_state(nw=10)
    mesh = pmesh.Mesh(shape=(4, 1), coords=(1, 0), groups={},
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by the walker mesh"):
        pmesh.shard_walkers(state, mesh)
    assert pmesh.active_mesh() is None
    mesh = dataclasses.replace(mesh, shape=(5, 1))
    try:
        local = pmesh.shard_walkers(state, mesh)
        assert pmesh.active_mesh() is mesh
    finally:
        pmesh.set_active_mesh(None)
    assert local.nwalkers == 2
    np.testing.assert_array_equal(local.phia[:, 0, 0].real.numpy(), [2, 3])
    assert local.total_weight.shape == ()


def test_fresh_driver_clears_the_mesh():
    """A new driver starts unsharded (JAX's afqmc.py:387-392)."""
    from pauxy_tpu_torch.models import free_electron_trial, make_hubbard
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    pmesh.set_active_mesh(object())
    ham = make_hubbard(2, 2, U=4.0, nx=2, ny=2, device="cpu", dtype="double")
    AFQMC(ham, free_electron_trial(ham, device="cpu", dtype="double"),
          QMCOpts(nwalkers=4, nsteps=1, nblocks=1), device="cpu")
    assert pmesh.active_mesh() is None


def test_mesh_needs_a_process_group_and_a_card():
    """Without init_process_group the mesh raises; a rank with no card
    raises unless it asked for the CPU."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group is running in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.walker_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh._rank_device(None)


def test_run_ranks_returns_tensors_and_reports_failures(monkeypatch):
    """parallel.launch.run_ranks hands back each rank's tensors after the
    rank has exited, and a rank that raises fails the call with its
    traceback."""
    from pauxy_tpu_torch.parallel import launch

    out = launch.run_ranks(cases.tensor_rank, 2, timeout=60.0)
    assert [o["rank"] for o in out] == [0, 1]
    assert torch.equal(out[1]["x"], torch.full((3,), 1.0))
    monkeypatch.setenv("MESH_CASES_FAIL", "1")
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run_ranks(cases.tensor_rank, 2, timeout=60.0)
