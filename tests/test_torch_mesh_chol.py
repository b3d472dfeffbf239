"""The port's Generic paths on a [walker, chol] mesh: 4 gloo ranks as
[walker 2, chol 2] against the port's one-rank run at rtol 1e-8 in float64
(``_generic_ham``'s system: M = 8, X = 16, 16 walkers), and the chol
group's sums of the ranks' partials against JAX at 1e-10.

Cases (``tests/torch_mesh_cases.py``, the one-rank and the sharded runs of
the whole file once, ``torch_mesh_harness``):
  * back propagation with energies, EKT and restore_weights="partial" (the
    field buffer holds each rank's X slice), and the ITCF;
  * the exact-ERI, PNO and stochastic-RI energies (the latter with and
    without the control variate);
  * the sketched one-body step, every rank applying the one-rank run's
    sketches;
  * ThermalAFQMC with a Generic Hamiltonian on the full-rank stack, and
    on the low-rank stack with a diagonal one-body part;
  * a back-propagation run checkpointed on the mesh: the directory holds
    the whole-X field buffer and restores on one rank, where the next
    block equals the straight run's;
  * module parity: the dense-G energy, both EKT Focks and the
    stochastic-RI energy, each rank holding its X slice, against JAX's
    functions on the whole X and the same numpy inputs (JAX runs in this
    process; the ranks are spawned).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
import torch_mesh_harness as harness
from pauxy_tpu.estimators import ekt as jekt
from pauxy_tpu.estimators import local_energy as jle
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.utils import h5lite
from pauxy_tpu_torch.utils.testing import generate_hamiltonian

NAMES = ("bp_chol", "itcf_chol", "exact_eri_chol", "pno_chol", "sri_chol",
         "sri_cv_chol", "sri_step_chol", "thermal_generic_chol",
         "thermal_generic_low_rank_chol", "bp_ckpt_chol", "parity_chol")
# Every case but the checkpoint's, whose one-rank run is a block longer.
SAME = tuple(n for n in NAMES if n != "bp_ckpt_chol")
# The stochastic-RI probes of the parity case, as JAX's energy draws them.
KEY = jax.random.key(7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chol")
    np.save(tmp / cases.SRI_THETA,
            np.asarray(jax.random.rademacher(KEY, (16, 6))))
    ref, ranks = harness.sharded_and_one_rank(NAMES, tmp)
    return ref, ranks, tmp


@pytest.mark.parametrize("name", SAME)
def test_chol_mesh_matches_one_rank(name, runs):
    ref, ranks, _ = runs
    assert len(ranks) == harness.NRANKS
    assert cases.MESH_OF[name] == "walker_chol"
    for got in ranks:
        harness.assert_same(ref[name], got[name])


def test_every_rank_applies_the_same_sketches(runs):
    """The sketched step's theta1, theta2 [M, S] of every half-step: the
    same on all four ranks (both walker and both chol coordinates) as on
    the one-rank run."""
    ref, ranks, _ = runs
    want = ref["sri_step_chol"][1]
    assert want.shape == (32, 8, 64)
    for got in ranks:
        assert np.array_equal(got["sri_step_chol"][1], want)


def test_bp_checkpoint_on_the_mesh_restores_on_one_rank(runs):
    """Two blocks with a checkpoint on the mesh equal the straight run's
    first two; the directory's field buffer holds the whole X (JAX's
    layout) and each rank reads back its own slice; one rank restores it
    and its block equals the straight run's third."""
    ref, ranks, tmp = runs
    rows, bp = ref["bp_ckpt_chol"]
    for got in ranks:
        harness.assert_same((rows[:2], bp[:2]), got["bp_ckpt_chol"][:2])
        assert got["bp_ckpt_chol"][2], "the mesh's read-back differs"
    d = os.path.join(tmp, "bp_ckpt")
    shards = sorted(glob.glob(os.path.join(d, "shard_*.h5")))
    assert len(shards) == 2
    for f in shards:
        with h5lite.open_file(f, "r") as fh5:
            assert np.asarray(fh5["configs__re"]).shape == (8, 4, 16)
    af = cases._generic_af(estimator_options=cases.BP_CHOL,
                           qmc=cases.bp_ckpt_qmc(1),
                           walker_options={"read_file": d})
    assert af.state.configs.shape == (16, 4, 16) and af.step == 16
    got = af.run()[:, 1:10].real
    harness.assert_same((rows[2:], bp[2:]), (got, cases._bp_rows(af)[0]))


def _jax_wants():
    ga, gb, gha, ghb = cases.parity_inputs()
    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    want = {}
    for cv in (False, True):
        jham = j_make_generic((3, 3), h1e, chol, enuc, stochastic_ri=True,
                              nsamples=6, control_variate=cv)
        jt = jtrial.rhf_identity_trial(jham)
        want[f"sri_{cv}"] = jle.local_energy_generic_stochastic_ri(
            jt, jnp.asarray(gha), jnp.asarray(ghb), jham.ecore, KEY, 6, cv)
    want["cholesky_G"] = jle.local_energy_generic_cholesky_G(
        jham, jnp.asarray(ga), jnp.asarray(gb))
    eye = np.eye(8)
    pa = jnp.asarray(eye - ga.transpose(0, 2, 1))
    pb = jnp.asarray(eye - gb.transpose(0, 2, 1))
    want["ekt_1p"] = jekt.ekt_1p_fock(jham.H1[0], jham.chol, pa, pb)
    want["ekt_1h"] = jekt.ekt_1h_fock(jham.H1[0], jham.chol, pa, pb)
    return {k: np.asarray(jnp.stack(v) if isinstance(v, tuple) else v)
            for k, v in want.items()}


@pytest.mark.parametrize("name", ["cholesky_G", "ekt_1p", "ekt_1h",
                                  "sri_False", "sri_True"])
def test_chol_sums_of_partials_match_jax(name, runs):
    """Each rank's function, on its X slice with the chol group's sum
    inside, and the one-rank run, against JAX's on the whole X: 1e-10
    relative to the result's scale."""
    ref, ranks, _ = runs
    want = _jax_wants()[name]
    scale = np.abs(want).max()
    for got in [ref["parity_chol"]] + [r["parity_chol"] for r in ranks]:
        np.testing.assert_allclose(got[name], want, rtol=1e-10,
                                   atol=1e-10 * scale)


def _slice_mesh(coord, nchol=2):
    return pmesh.Mesh(shape=(2, nchol), coords=(1, coord), groups={},
                      device=torch.device("cpu"))


def test_shard_generic_takes_every_variant_and_the_thermal_inner():
    """The exact-ERI and PNO tensors stay whole, the stochastic-RI system
    shards like the plain one, and a thermal Generic propagator's inner
    keeps its X slice of chol and mf_shift; the originals are untouched."""
    from pauxy_tpu_torch.models import make_generic
    from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
    from pauxy_tpu_torch.qmc import QMCOpts
    from pauxy_tpu_torch.qmc.thermal_afqmc import ThermalAFQMC

    for variant in ({"exact_eri": True}, {"pno": True, "thresh_pno": 1e-6},
                    {"stochastic_ri": True, "nsamples": 6}):
        af = cases._generic_af(variant)
        parts = [pmesh.shard_generic(af.ham, af.trial, af.prop,
                                     _slice_mesh(c)) for c in range(2)]
        joined = torch.cat([t.rchola for _, t, _ in parts])
        assert torch.equal(joined, af.trial.rchola)
        for key in ("eri_aa", "pno_aa", "ghalf0a"):
            whole = getattr(af.trial, key, None)
            if whole is not None:
                for _, t, _ in parts:
                    assert all(np.array_equal(a, b) for a, b in zip(
                        harness.flat(getattr(t, key)), harness.flat(whole)))
        assert af.ham.chol.shape[-1] == 16
    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    ham = make_generic((3, 3), h1e, chol, enuc, **cases.KW)
    af = ThermalAFQMC(ham, make_one_body_trial(ham, 0.25, 0.05, **cases.KW),
                      QMCOpts(nwalkers=4, dt=0.05, nblocks=1, beta=0.25),
                      device="cpu")
    parts = [pmesh.shard_generic(af.ham, af.trial, af.prop, _slice_mesh(c))
             for c in range(2)]
    for name, axis in (("chol", -1), ("mf_shift", 0)):
        whole = getattr(af.prop.inner, name)
        assert whole.shape[axis] == 16
        assert torch.equal(torch.cat([getattr(p.inner, name)
                                      for _, _, p in parts], dim=axis),
                           whole)
    assert all(p.inner.BH1 is af.prop.inner.BH1 for _, _, p in parts)


def test_draw_shared_keeps_this_ranks_x_rows():
    """Every rank draws the whole [X, S] and keeps its rows; without a
    mesh, or without a chol dim, the draw is the one asked for."""
    def fn(shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(4),
                           dtype=torch.float64)

    whole = fn((16, 5))
    for c in range(2):
        pmesh.set_active_mesh(_slice_mesh(c))
        try:
            got = pmesh.draw_shared(fn, (8, 5), chol_dim=0)
            assert torch.equal(got, whole[8 * c:8 * (c + 1)])
            assert torch.equal(pmesh.draw_shared(fn, (16, 5)), whole)
        finally:
            pmesh.set_active_mesh(None)
    assert torch.equal(pmesh.draw_shared(fn, (16, 5), chol_dim=0), whole)
