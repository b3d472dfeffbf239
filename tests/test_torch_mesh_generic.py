"""The port's walker mesh at finite temperature, for Hubbard-Holstein and
on the Cholesky axis: each case of ``tests/test_multidevice.py`` (full-rank,
discrete and low-rank thermal; the coherent-state and multi-coherent HH
trials; Generic with a single- and a multi-determinant trial on a
[walker=2, chol=2] mesh) on 4 gloo ranks of this machine, held against the
port's one-rank run at rtol 1e-8 in float64. The one-rank and the sharded
runs of the whole file run once (``torch_mesh_harness``).
"""

import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
import torch_mesh_harness as harness
from pauxy_tpu_torch.parallel import mesh as pmesh

NAMES = ("thermal", "thermal_discrete", "thermal_low_rank",
         "hubbard_holstein", "multi_coherent", "generic", "msd_generic")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return harness.sharded_and_one_rank(NAMES, tmp_path_factory.mktemp("m"))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_one_rank(name, runs):
    ref, ranks = runs
    assert len(ranks) == harness.NRANKS
    for got in ranks:
        harness.assert_same(ref[name], got[name])


def _slice_mesh(coord, nchol=2):
    return pmesh.Mesh(shape=(2, nchol), coords=(0, coord), groups={},
                      device=torch.device("cpu"))


def test_shard_generic_keeps_the_x_slice():
    """Each chol coordinate keeps its X slice of chol, rchol (a
    multi-determinant trial's on its axis 1) and mf_shift; the
    supermatrix goes; the originals are untouched."""
    from pauxy_tpu_torch.models import multi_slater_trial, rhf_identity_trial
    from pauxy_tpu_torch.qmc import AFQMC, QMCOpts

    ham = cases._generic_ham()
    eye = np.eye(8)[:, :6]
    for trial in (rhf_identity_trial(ham, **cases.KW),
                  multi_slater_trial(ham, np.stack([eye, eye]),
                                     np.array([0.9, 0.1]), **cases.KW)):
        af = AFQMC(ham, trial, QMCOpts(nwalkers=4), device="cpu")
        parts = [pmesh.shard_generic(af.ham, af.trial, af.prop,
                                     _slice_mesh(c)) for c in range(2)]
        xa = 0 if trial.rchola.dim() == 3 else 1
        for name, get, axis in (
                ("chol", lambda h, t, p: h.chol, -1),
                ("rchola", lambda h, t, p: t.rchola, xa),
                ("rcholb", lambda h, t, p: t.rcholb, xa),
                ("prop chol", lambda h, t, p: p.inner.chol, -1),
                ("mf_shift", lambda h, t, p: p.inner.mf_shift, 0)):
            whole = get(af.ham, af.trial, af.prop)
            joined = torch.cat([get(*p) for p in parts], dim=axis)
            assert torch.equal(joined, whole), name
            assert get(*parts[0]).shape[axis] == whole.shape[axis] // 2
        assert all(getattr(p[1], "exx_supera", None) is None
                   for p in parts)
        assert af.ham.chol.shape[-1] == 16
    with pytest.raises(ValueError, match="not divisible by the chol"):
        pmesh.shard_generic(af.ham, af.trial, af.prop, _slice_mesh(0, 3))
