"""Port tests for the low-rank thermal stack (walkers/low_rank.py) against
the JAX package, float64 on the CPU:

* ``update_low_rank`` slice by slice against JAX's at 1e-10 (G relative to
  max|G|; log det(1 + A) real part relative to its scale, phase modulo
  2 pi) and against the dense (1 + A)^-1 and log det(1 + A): without
  truncation (M = 12, 6 slices, stack size 2) at 1e-12, and with the
  truncation active (M = 16, 20 slices, stack size 4, a strongly decaying
  trial spectrum) at 1e-5, the inputs of tests/test_thermal_afqmc.py;
* ``_identity_pad`` and ``_safe_inv`` on dead directions, and the
  boundary step on exactly zeroed columns (no inf, no nan);
* ``init_low_rank_walkers`` against JAX's, field by field;
* two paths of ``ThermalAFQMC`` with the low-rank walkers against JAX's
  with JAX's draws injected (UEG ecut = 1, M = 19, 8 walkers, comb), every
  row entry but the time at rtol 1e-8; the converter of the state;
* the anchor tests/data/thermal_ueg_lowrank.npz's iteration-0 row (UEG
  rs = 1, ecut = 4, M = 93, system mu = 0.245, the trial's mu bisected to
  N = 2, beta = 0.5): ETotal 5.97385568 and Nav 1.99999991 at abs 1e-7,
  the pinned values of the JAX test;
* a non-diagonal trial refused.
"""

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
from pauxy_tpu.walkers import low_rank as jlrw
from pauxy_tpu_torch.models import make_hubbard
from pauxy_tpu_torch.models.thermal_trial import make_one_body_trial
from pauxy_tpu_torch.models.ueg import make_ueg
from pauxy_tpu_torch.qmc import QMCOpts
from pauxy_tpu_torch.qmc import thermal_afqmc as tta
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import low_rank as lrw

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
FIELDS = ("Qr", "Dr", "Tr", "Dl", "G", "log_ovlp", "weight",
          "unscaled_weight", "phase", "total_weight", "hybrid_energy")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = np_(a), np_(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def logdet_gap(a, b):
    """(max |dRe| over the scale, max |dIm| modulo 2 pi): the wrap gives
    [-pi, pi), kernel B's branch (-pi, pi], so +-pi are one value."""
    d = np_(a) - np_(b)
    return (np.abs(d.real).max() / max(np.abs(np_(b).real).max(), 1.0),
            np.abs(np.angle(np.exp(1j * d.imag))).max())


class DiagTrial:
    """The fields init_low_rank_walkers reads, for both packages."""

    def __init__(self, bt_diag, nslice, torch_side):
        self.nbasis = bt_diag.shape[0]
        self.num_slices = nslice
        dmat = np.stack([np.diag(bt_diag)] * 2).astype(np.complex128)
        self.dmat = (torch.from_numpy(dmat) if torch_side
                     else jnp.asarray(dmat))


def stack_inputs(case):
    """The two input sets of tests/test_thermal_afqmc.py's low-rank
    tests: (bt_diag, slice propagators [nslice, w, 2, M, M], stack size)."""
    if case == "untruncated":
        rng = np.random.default_rng(3)
        m, nslice, ss, nw = 12, 6, 2, 3
        bt_diag = np.sort(rng.uniform(0.2, 1.4, m))[::-1].copy()
        bs = np.eye(m)[None, None, None] + 0.3 * (
            rng.standard_normal((nslice, nw, 2, m, m))
            + 1j * rng.standard_normal((nslice, nw, 2, m, m))) / np.sqrt(m)
        return bt_diag, bs, ss
    rng = np.random.default_rng(5)
    m, nslice, ss, nw = 16, 20, 4, 2
    bt_diag = np.exp(-0.5 * np.sort(rng.uniform(0, 30, m)))
    bs = np.einsum("i,lwsij->lwsij", bt_diag, np.eye(m)[None, None, None]
                   + 0.1 * (rng.standard_normal((nslice, nw, 2, m, m))
                            + 1j * rng.standard_normal((nslice, nw, 2, m, m))
                            ) / np.sqrt(m))
    return bt_diag, bs, ss


@pytest.mark.parametrize("case,dense_tol", [("untruncated", 1e-12),
                                            ("truncated", 1e-5)])
def test_update_low_rank_matches_jax_and_dense(case, dense_tol):
    bt_diag, bs, ss = stack_inputs(case)
    nslice, nw, _, m, _ = bs.shape
    btinv = np.stack([1 / bt_diag] * 2).astype(np.complex128)
    jstate = jlrw.init_low_rank_walkers.__wrapped__(
        DiagTrial(bt_diag, nslice, False), nw)
    state = lrw.init_low_rank_walkers(DiagTrial(bt_diag, nslice, True), nw)
    for t in range(nslice):
        jstate = jlrw.update_low_rank(jnp.asarray(btinv), jstate,
                                      jnp.asarray(bs[t]), jnp.asarray(t),
                                      stack_size=ss, thresh=1e-6)
        state = lrw.update_low_rank(torch.from_numpy(btinv), state,
                                    torch.from_numpy(bs[t]), t,
                                    stack_size=ss, thresh=1e-6)
        assert rel(state.G, jstate.G) < 1e-10, t
        gap = logdet_gap(state.log_ovlp, jstate.log_ovlp)
        assert gap[0] < 1e-10 and gap[1] < 1e-10, (t, gap)
        assert rel(state.Dl, jstate.Dl) < 1e-12
        if case == "truncated" and t < nslice - 1:
            continue
        a = np.broadcast_to(np.eye(m, dtype=complex), (nw, 2, m, m))
        for k in range(t + 1):
            a = bs[k] @ a
        a = (bt_diag.astype(complex) ** (nslice - t - 1))[:, None] * a
        sign, ld = np.linalg.slogdet(np.eye(m) + a)
        assert np.abs(np_(state.G) - np.linalg.inv(np.eye(m) + a)).max() \
            < dense_tol
        assert np.abs(np_(state.log_ovlp) - (ld + np.log(sign))).max() \
            < dense_tol
    assert np.isfinite(np_(state.G)).all()


def test_masks_on_dead_directions():
    """Padding puts 1 only on inactive diagonals; 1/d of a dead entry is
    0; a boundary step whose right factor has exactly zero (dead) columns
    stays finite."""
    m = torch.arange(9.0, dtype=torch.float64).reshape(3, 3) + 0j
    mask = torch.tensor([True, False, True])
    padded = lrw._identity_pad(m, mask)
    want = m.clone()
    want[1, 1] += 1.0
    assert torch.equal(padded, want)
    d = torch.tensor([2.0, 0.0, -4.0], dtype=torch.complex128)
    assert torch.equal(lrw._safe_inv(d, d.abs() > 0),
                       torch.tensor([0.5, 0.0, -0.25],
                                    dtype=torch.complex128))
    bt_diag, bs, ss = stack_inputs("truncated")
    state = lrw.init_low_rank_walkers(DiagTrial(bt_diag, 20, True), 2)
    dead = torch.ones(16, dtype=torch.complex128)
    dead[10:] = 1e-12                                  # below the threshold
    state.Dr = state.Dr * dead
    state = lrw.update_low_rank(torch.from_numpy(1 / np.stack([bt_diag] * 2)
                                                 + 0j), state,
                                torch.from_numpy(bs[0]), ss - 1,
                                stack_size=ss, thresh=1e-6)
    assert (state.Dr[..., 10:] == 0).all()
    assert torch.isfinite(state.G).all() and torch.isfinite(state.Tr).all()
    assert torch.isfinite(state.log_ovlp).all()


def ueg_pair(ecut=1.0):
    return (j_make_ueg(nup=1, ndown=1, rs=1.0, ecut=ecut),
            make_ueg(1, 1, rs=1.0, ecut=ecut, **CPU))


def test_init_low_rank_walkers_matches_jax():
    jham, ham = ueg_pair()
    kw = dict(beta=0.25, dt=0.025, mu=0.245, stack_size=2)
    jstate = jlrw.init_low_rank_walkers(j_mobt(jham, **kw), 5)
    state = lrw.init_low_rank_walkers(make_one_body_trial(ham, **kw, **CPU),
                                      5)
    for name in FIELDS:
        assert rel(getattr(state, name), getattr(jstate, name)) < 1e-12, name
    # The converter carries JAX's state over unchanged.
    conv = convert.low_rank_walker_state(
        **{k: np.asarray(getattr(jstate, k)) for k in FIELDS}, device="cpu")
    for name in FIELDS:
        assert np.array_equal(np_(getattr(conv, name)),
                              np.asarray(getattr(jstate, name))), name


def jax_path_noise(sub, nslices, nw, nfields):
    xi, pop = [], []
    for key in jax.random.split(sub, nslices):
        kprop, kpop = jax.random.split(key)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nfields),
                                               dtype=jnp.float64)))
        pop.append(np.asarray(jax.random.uniform(kpop, (),
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return tta.PathNoise(torch.from_numpy(np.array(xi)),
                         torch.from_numpy(np.array(pop)))


def test_two_low_rank_paths_match_jax(tmp_path):
    jham, ham = ueg_pair()
    kw = dict(beta=0.25, dt=0.025, mu=0.245, stack_size=2)
    nw = 8
    opts = dict(nwalkers=nw, dt=kw["dt"], nsteps=1, nblocks=2,
                beta=kw["beta"], npop_control=2, rng_seed=8)
    wopts = {"low_rank": True, "low_rank_thresh": 1e-6}
    jaf = jta.ThermalAFQMC(jham, j_mobt(jham, **kw), JQMCOpts(**opts),
                           walker_options=wopts,
                           filename=str(tmp_path / "j.h5"))
    af = tta.ThermalAFQMC(ham, make_one_body_trial(ham, **kw, **CPU),
                          QMCOpts(**opts), walker_options=wopts,
                          device="cpu")
    assert isinstance(af.state, lrw.LowRankWalkerState)
    assert af.prop.low_rank and af.prop.low_rank_thresh == 1e-6
    assert af.ham.nbasis == 19
    key = jax.random.key(8)
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise = jax_path_noise(sub, af.ntime_slices, nw, af.prop.nfields)
        jrow, row = jaf.run_block(), af.run_block(noise)
        np.testing.assert_allclose(row[:11], jrow[:11], rtol=1e-8,
                                   atol=1e-10)
        assert np.isfinite(row).all()
    # The reset after each path is a fresh low-rank population.
    assert isinstance(af.state, lrw.LowRankWalkerState)


def test_anchor_iteration0_row_m93():
    """tests/data/thermal_ueg_lowrank.npz's deterministic first row; the
    model's mu is the system's (the sampled slices'), the trial's is
    bisected, as the JAX package's input reader (`setup_calculation`)
    sets them. Every walker starts at the trial, so the row does not
    depend on the anchor's 16 walkers; 2 keep the UEG exchange's
    intermediates small."""
    ham = make_ueg(1, 1, rs=1.0, ecut=4.0, **CPU)
    trial = make_one_body_trial(ham, 0.5, 0.05, **CPU)
    assert ham.nbasis == 93 and trial.stack_size == 2
    rows = tta.ThermalAFQMC(
        ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1, nblocks=0,
                            beta=0.5, rng_seed=8),
        propagator_options={"mu": 0.245},
        walker_options={"low_rank": True, "low_rank_thresh": 1e-6},
        device="cpu").run()
    assert rows.shape == (1, 12)
    assert rows[0, 5].real == pytest.approx(5.97385568, abs=1e-7)
    assert rows[0, 10].real == pytest.approx(1.99999991, abs=1e-7)


def test_non_diagonal_trial_refused():
    ham = make_hubbard(3, 3, U=4.0, nx=3, ny=3, **CPU)
    trial = make_one_body_trial(ham, 0.5, 0.05, mu=0.9, **CPU)
    with pytest.raises(ValueError, match="diagonal"):
        tta.ThermalAFQMC(ham, trial, QMCOpts(nwalkers=2, dt=0.05, nsteps=1,
                                             nblocks=1, beta=0.5),
                         walker_options={"low_rank": True}, device="cpu")
    # JAX refuses the same trial (by assertion).
    jham = j_make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    with pytest.raises(AssertionError, match="diagonal"):
        jta.ThermalAFQMC(jham, j_mobt(jham, 0.5, 0.05, mu=0.9),
                         JQMCOpts(nwalkers=2, dt=0.05, nsteps=1, nblocks=1,
                                  beta=0.5),
                         walker_options={"low_rank": True}, filename=None)
