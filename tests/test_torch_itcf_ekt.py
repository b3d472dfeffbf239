"""Port parity: the ITCF and EKT estimators against JAX.

float64, the same inputs on both sides (a walker state with filled
buffers, carried across with pauxy_tpu_torch.utils.convert):
  * ekt_1p_fock / ekt_1h_fock on random RDMs of a Generic system: 1e-10;
  * itcf.dense_propagators (discrete; continuous Hubbard and Generic),
    equal_time_greens, back_propagate_left and measure (stable and
    unstable, stack_size 1 and 2, with and without weight restoration):
    1e-10;
  * itcf_to_kspace against JAX's, and on free fermions against the
    diagonal of F G F^dagger / M by hand;
  * ITCFReporter's modes ('full', 'diagonal', pairs) and k-space output
    against JAX's reporter on the same accumulator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.estimators import ekt as jekt
from pauxy_tpu.estimators import itcf as jitcf
from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.ops import greens as jgreens
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.propagation.hirsch import make_hirsch as j_make_hirsch
from pauxy_tpu.propagation.hubbard import make_hubbard_continuous as j_mhc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.estimators import ekt as tekt
from pauxy_tpu_torch.estimators import itcf as titcf
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight", "phase", "eloc")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def port_state(js):
    hist = {f: np.asarray(getattr(js, f)) for f in convert.HISTORY_FIELDS
            if getattr(js, f) is not None}
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu",
                                **hist)


def generic_system(nmo=6, nelec=(2, 2), seed=3):
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    jham = j_make_generic(nelec, h1e, chol, enuc)
    return jham, jtrial.rhf_identity_trial(jham)


def random_rdms(m, nw, seed):
    """Hermitian RDM-like matrices P_s [w, M, M]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = rng.standard_normal((nw, m, m)) + 1j * rng.standard_normal(
            (nw, m, m))
        out.append(0.1 * (a + np.conj(np.swapaxes(a, 1, 2))))
    return out


@pytest.mark.parametrize("chunk", [None, 20, 150])
@pytest.mark.parametrize("which", ["1p", "1h"])
def test_ekt_focks_match_jax(which, chunk, monkeypatch):
    """With the Cholesky sandwiches in one chunk, and in chunks of one
    walker and one vector (20 elements) or of 4 walkers (150)."""
    if chunk is not None:
        monkeypatch.setattr(tekt, "MAX_ELEMS", chunk)
    jham, _ = generic_system()
    pa, pb = random_rdms(6, 4, seed=1)
    h1 = np.asarray(jham.H1[0])
    chol = np.asarray(jham.chol)
    jfn = jekt.ekt_1p_fock if which == "1p" else jekt.ekt_1h_fock
    tfn = tekt.ekt_1p_fock if which == "1p" else tekt.ekt_1h_fock
    jout = jfn(jnp.asarray(h1), jnp.asarray(chol), jnp.asarray(pa),
               jnp.asarray(pb))
    close(tfn(t(h1), t(chol), t(pa), t(pb)).numpy(), jout)


def propagators(kind):
    """(JAX prop, port prop, JAX trial, port trial, nfields, discrete)."""
    if kind == "generic":
        jham, jtr = generic_system()
        jprop = JContinuous(inner=j_mgc(jham, jtr, 0.05), dt=0.05)
        inner = jprop.inner
        tprop = Continuous(inner=convert.generic_continuous(
            np.asarray(inner.BH1), np.asarray(inner.mf_shift),
            np.asarray(inner.chol), dt=0.05, device="cpu"), dt=0.05)
        nf = jham.nchol
    else:
        jham = make_hubbard(nup=4, ndown=3, U=4.0, nx=3, ny=3,
                            ktwist=[0.01, -0.02])
        jtr = free_electron_trial(jham)
        nf = 9
        if kind == "discrete":
            jprop = j_make_hirsch(jham, jtr, 0.05, sweep_kernel="scan")
            tprop = convert.hirsch(
                np.asarray(jprop.BT2), np.asarray(jprop.auxf),
                np.asarray(jprop.aux_wfac), dt=0.05, charge=False,
                gamma=jprop.gamma, sweep_kernel="scan", device="cpu")
        else:
            jprop = JContinuous(inner=j_mhc(jham, jtr, 0.05,
                                            charge_decomposition=False),
                                dt=0.05)
            tprop = Continuous(inner=convert.hubbard_continuous(
                np.asarray(jprop.inner.BH1),
                np.asarray(jprop.inner.mf_shift), dt=0.05, U=4.0,
                charge=False, device="cpu"), dt=0.05)
    ttr = convert.trial(np.asarray(jtr.psia), np.asarray(jtr.psib),
                        jtr.etrial, device="cpu")
    return jprop, tprop, jtr, ttr, nf, kind == "discrete"


def history_state(jtr, nw, nprop, nfields, seed, discrete):
    js = j_init_walkers(jtr, nw, total_weight=float(nw), nprop_tot=nprop,
                        nfields=nfields, itcf=True)
    rng = np.random.default_rng(seed)

    def noisy(x):
        x = np.asarray(x)
        return jnp.asarray(x + 0.1 * (rng.standard_normal(x.shape)
                                      + 1j * rng.standard_normal(x.shape)))

    if discrete:
        configs = rng.integers(0, 2, size=(nw, nprop, nfields)) + 0j
    else:
        configs = 0.5 * (rng.standard_normal((nw, nprop, nfields))
                         + 0.2j * rng.standard_normal((nw, nprop, nfields)))
    cos = rng.uniform(0.5, 1.0, (nw, nprop))
    cos[1, 0] = 0.0
    return js.replace(
        phia=noisy(js.phia), phib=noisy(js.phib),
        weight=jnp.asarray(rng.uniform(0.3, 2.0, nw)),
        configs=jnp.asarray(configs), cos_fac=jnp.asarray(cos),
        weight_fac=jnp.asarray(np.exp(1j * rng.uniform(-0.3, 0.3,
                                                       (nw, nprop)))),
        phia_right=noisy(js.phia_right), phib_right=noisy(js.phib_right))


@pytest.mark.parametrize("kind", ["discrete", "hubbard", "generic"])
def test_dense_propagators_and_left_wavefunctions_match_jax(kind):
    jprop, tprop, jtr, ttr, nf, discrete = propagators(kind)
    js = history_state(jtr, 4, 6, nf, seed=2, discrete=discrete)
    x = np.asarray(js.configs[:, 2])
    for a, b in zip(titcf.dense_propagators(tprop, t(x), discrete),
                    jitcf.dense_propagators(jprop, jnp.asarray(x),
                                            discrete)):
        close(a.numpy(), b)
    tout = titcf.back_propagate_left(tprop, ttr, t(js.configs), 4, discrete)
    jout = jitcf.back_propagate_left(jprop, jtr, js.configs, 4, discrete)
    close(tout[0].numpy(), jout[0])
    close(tout[1].numpy(), jout[1])
    close(torch.stack(tout[2]).numpy(), jout[2])
    close(torch.stack(tout[3]).numpy(), jout[3])
    ts = port_state(js)
    for a, b in zip(titcf.equal_time_greens(ts.phia, ts.phib, ts.phia_right,
                                            ts.phib_right),
                    jitcf.equal_time_greens(js.phia, js.phib, js.phia_right,
                                            js.phib_right)):
        close(a[0].numpy(), b[0])
        close(a[1].numpy(), b[1])


MEASURE_CASES = {
    "discrete_stable": dict(kind="discrete", stable=True),
    "discrete_unstable_stack2": dict(kind="discrete", stable=False,
                                     stack_size=2),
    "hubbard_stable_stack2_no_restore": dict(kind="hubbard", stable=True,
                                             stack_size=2, restore=False),
    "generic_unstable": dict(kind="generic", stable=False),
}


@pytest.mark.parametrize("case", list(MEASURE_CASES))
def test_itcf_measure_matches_jax(case):
    kw = MEASURE_CASES[case]
    jprop, tprop, jtr, ttr, nf, discrete = propagators(kw["kind"])
    js = history_state(jtr, 5, 6, nf, seed=3, discrete=discrete)
    opts = dict(nmax=4, nstblz=3, stable=kw["stable"],
                restore_weights=kw.get("restore", True), discrete=discrete,
                stack_size=kw.get("stack_size", 1))
    jacc = jitcf.measure(jprop, jtr, js, **opts)
    tacc = titcf.measure(tprop, ttr, port_state(js), **opts)
    m = js.nbasis
    assert tacc.shape[0] == titcf.itcf_acc_size(m, 4, opts["stack_size"])
    close(tacc.numpy(), jacc)


def test_itcf_to_kspace_matches_jax_and_the_transform():
    nx, ny = 3, 2
    m = nx * ny
    rng = np.random.default_rng(4)
    spgf = rng.standard_normal((3, 2, 2, m, m)) + 1j * rng.standard_normal(
        (3, 2, 2, m, m))
    out = titcf.itcf_to_kspace(spgf, nx, ny)
    close(out, jitcf.itcf_to_kspace(spgf, nx, ny))
    # G_k = (F G F^dagger)_kk / M with F[k, r] = e^{-i k r} on the grid.
    r = np.array([(i % nx, i // nx) for i in range(m)])
    k = np.array([(2 * np.pi * (i % nx) / nx, 2 * np.pi * (i // nx) / ny)
                  for i in range(m)])
    # The k index of fft2 over (ny, nx) runs ky-major, kx-minor as r does.
    f = np.exp(-1j * k @ r.T)
    want = np.einsum("kr,...rs,ks->...k", f, spgf, f.conj()) / m
    close(out, want)


@pytest.mark.parametrize("mode", ["full", "diagonal", [[0, 1], [2, 2]]])
def test_itcf_reporter_matches_jax(mode):
    class Sink:
        def __init__(self):
            self.data = {}

        def push(self, data, name):
            self.data[name] = np.asarray(data)

        def increment(self):
            pass

    m, nmax = 6, 2
    rng = np.random.default_rng(5)
    acc = rng.standard_normal(1 + (nmax + 1) * 4 * m * m) + 0j
    acc[0] = 3.0
    js, ts = Sink(), Sink()
    jout = jitcf.ITCFReporter(js, kspace_dims=(3, 2), mode=mode).block_row(
        acc, m, nmax)
    rep = titcf.ITCFReporter(ts, kspace_dims=(3, 2), mode=mode)
    close(rep.block_row(acc, m, nmax), jout)
    assert js.data.keys() == ts.data.keys()
    for name in js.data:
        close(ts.data[name], js.data[name])
        close(rep.rows[0][name], js.data[name])
    # Without an output the values are kept all the same.
    quiet = titcf.ITCFReporter(None, mode=mode)
    quiet.block_row(acc, m, nmax)
    close(quiet.rows[0]["real_space_greens_function"],
          js.data["real_space_greens_function"])


def test_equal_time_greens_sum_to_identity():
    jprop, tprop, jtr, ttr, nf, _ = propagators("hubbard")
    ts = port_state(history_state(jtr, 3, 2, nf, seed=6, discrete=False))
    (gra, grb), (lsa, lsb) = titcf.equal_time_greens(
        ts.phia, ts.phib, ts.phia_right, ts.phib_right)
    eye = np.eye(9)
    close((gra + lsa).numpy(), np.broadcast_to(eye, (3, 9, 9)))
    close(torch.diagonal(lsa, dim1=-2, dim2=-1).sum(-1).numpy(),
          np.full(3, 4.0))
    close(jgreens.gab(jnp.asarray(ts.phia.numpy()),
                      jnp.asarray(ts.phia_right.numpy())), lsa.numpy())
