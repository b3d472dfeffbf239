"""Port driver tests for the Generic (Cholesky ab-initio) phaseless path.

* two blocks of qmc/afqmc.run_block against pauxy_tpu.qmc.afqmc.run_block
  with JAX's draws injected, taken in JAX's order (keys = split(block_key,
  nsteps); kprop, kpop, kest = split(key, 3); xi = normal(kprop, (w, X));
  comb's uniform(kpop, ()) or pair_branch's uniform(kpop, (w // 2,))),
  float64, accumulators and weights at rtol 1e-8, atol 1e-10, for
  taylor_impl "xla", "pallas" (the kernel's plain version on the CPU; JAX's
  XLA route is the float64 reference, since its Pallas kernel computes in
  float32 and is held at 2e-4), the exchange kernel's route (the
  supermatrix cap lowered in both packages) and pair_branch;
* the golden statistical anchor: tests/data/generic_nmo11.npz (the
  reference's Hamiltonian and trial orbitals), 40 walkers, 100 blocks, CPU
  float64, |diff| < max(4 se, 0.02), the test of tests/test_afqmc_driver.py;
* the HDF5 layout equal to the JAX driver's for the same Generic run;
* the device rule: device=None means the card and raises without one;
* configurations not ported yet raise NotImplementedError; free
  projection and the local-energy update run;
* importing and running the port's Generic path pulls in no jax.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.models import make_generic as j_make_generic
from pauxy_tpu.models import trial as jtrial
from pauxy_tpu.propagation.continuous import Continuous as JContinuous
from pauxy_tpu.propagation.generic import make_generic_continuous as j_mgc
from pauxy_tpu.qmc import AFQMC as JAFQMC
from pauxy_tpu.qmc import QMCOpts as JQMCOpts
from pauxy_tpu.qmc import afqmc as jafqmc
from pauxy_tpu.utils.testing import generate_hamiltonian
from pauxy_tpu.walkers import init_walkers as j_init_walkers
from pauxy_tpu_torch.models import (make_generic, rhf_identity_trial,
                                    trial_from_orbitals)
from pauxy_tpu_torch.models import trial as ttrial
from pauxy_tpu_torch.ops import exx_cuda, taylor_cuda
from pauxy_tpu_torch.propagation.continuous import Continuous
from pauxy_tpu_torch.qmc import AFQMC, QMCOpts
from pauxy_tpu_torch.qmc import afqmc as tafqmc
from pauxy_tpu_torch.qmc.hubbard_fast import BlockNoise
from pauxy_tpu_torch.utils import convert
from pauxy_tpu_torch.walkers import init_walkers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "generic_nmo11.npz")
CPU = dict(device="cpu", dtype="double")
TRIAL_TENSORS = ("rchola", "rcholb", "rh1a", "rh1b", "exx_supera",
                 "exx_superb")

CASES = {
    "xla": dict(impl="xla"),
    "pallas": dict(impl="pallas"),
    "exx_kernel": dict(impl="xla", cap=1),
    "pair_branch": dict(impl="pallas", pop_method="pair_branch"),
}


def jax_noise(block_key, nsteps, nw, nx, pop_method):
    xi, pop = [], []
    for key in jax.random.split(block_key, nsteps):
        kprop, kpop, _ = jax.random.split(key, 3)
        xi.append(np.asarray(jax.random.normal(kprop, (nw, nx),
                                               dtype=jnp.float64)))
        shape = () if pop_method == "comb" else (nw // 2,)
        pop.append(np.asarray(jax.random.uniform(kpop, shape,
                                                 dtype=jnp.float64)
                              ).reshape(-1))
    return BlockNoise(torch.from_numpy(np.array(xi)),
                      torch.from_numpy(np.array(pop)))


def jax_blocks(jham, jt, jimpl, nw, opts, keys):
    jprop = JContinuous(inner=j_mgc(jham, jt, 0.01, taylor_impl=jimpl),
                        dt=0.01)
    js = j_init_walkers(jt, nw, total_weight=float(nw))
    out = []
    for block, (key, eshift) in enumerate(zip(keys, (0.0, -3.0))):
        js, jacc, _, _ = jafqmc.run_block(
            jham, jt, jprop, js, key, jnp.asarray(eshift, jnp.complex128),
            jnp.asarray(10 * block, jnp.int32), free_projection=False,
            **opts)
        out.append((np.asarray(jacc)[0], np.asarray(js.weight),
                    np.asarray(js.phia)))
    return jprop, out


@pytest.mark.parametrize("case", list(CASES))
def test_block_trajectory_matches_jax(case, monkeypatch):
    kw = CASES[case]
    if "cap" in kw:
        monkeypatch.setattr(jtrial, "EXX_SUPER_MAX_ELEMS", kw["cap"])
    nw = 12
    pop_method = kw.get("pop_method", "comb")
    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 2), seed=13)
    jham = j_make_generic((3, 2), h1e, chol, enuc)
    jt = jtrial.rhf_identity_trial(jham)
    assert (jt.exx_supera is None) == ("cap" in kw)
    opts = dict(nsteps=10, nstblz=5, npop_control=1, pop_method=pop_method,
                target_weight=float(nw), energy_eval_freq=1)
    keys = [jax.random.key(21 + b) for b in range(2)]
    jprop, jout = jax_blocks(jham, jt, "xla", nw, opts, keys)

    tham = convert.generic(np.asarray(jham.H1), np.asarray(jham.h1e_mod),
                           np.asarray(jham.chol), ecore=jham.ecore,
                           nup=jham.nup, ndown=jham.ndown, device="cpu")
    tt = convert.trial(np.asarray(jt.psia), np.asarray(jt.psib), jt.etrial,
                       device="cpu", **{k: getattr(jt, k)
                                        for k in TRIAL_TENSORS})
    tprop = Continuous(inner=convert.generic_continuous(
        np.asarray(jprop.inner.BH1), np.asarray(jprop.inner.mf_shift),
        np.asarray(jprop.inner.chol), dt=0.01, taylor_impl=kw["impl"],
        device="cpu"), dt=0.01)
    ts = init_walkers(tt, nw, total_weight=float(nw))
    launches = (taylor_cuda.launches, exx_cuda.launches)
    routes = []
    for mod, name in ((taylor_cuda, "apply_taylor"), (exx_cuda, "exx")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            routes.append(_n), _fn(*a))[1])
    for block, (key, eshift) in enumerate(zip(keys, (0.0, -3.0))):
        noise = jax_noise(key, 10, nw, jham.nchol, pop_method)
        ts, tacc, _, _ = tafqmc.run_block(tham, tt, tprop, ts, None, eshift,
                                          10 * block, noise=noise, **opts)
        jacc, jweight, jphia = jout[block]
        np.testing.assert_allclose(tacc.numpy()[0], jacc, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(ts.weight.numpy(), jweight, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(ts.phia.numpy(), jphia, rtol=1e-8,
                                   atol=1e-10)
    # CPU tensors: the wrappers ran their plain versions, launching nothing.
    assert (taylor_cuda.launches, exx_cuda.launches) == launches
    assert ("apply_taylor" in routes) == (kw["impl"] == "pallas")
    assert ("exx" in routes) == ("cap" in kw)
    if kw["impl"] == "pallas" and pop_method == "comb":
        # JAX's Pallas kernel computes in float32.
        _, pout = jax_blocks(jham, jt, "pallas_interpret", nw, opts, keys)
        np.testing.assert_allclose(tacc.numpy()[0], pout[-1][0], rtol=2e-4,
                                   atol=2e-4)


def golden_system(dtype="double", device="cpu"):
    g = np.load(GOLDEN)
    nmo = g["h1e"].shape[-1]
    chol = np.asarray(g["chol"]).reshape(-1, nmo, nmo).transpose(1, 2, 0)
    ham = make_generic((3, 3), np.stack([g["h1e"], g["h1e"]]), chol,
                       ecore=float(g["enuc"]), device=device, dtype=dtype)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]), device=device,
                                dtype=dtype)
    return g, ham, trial


def test_generic_vs_reference_golden():
    g, ham, trial = golden_system()
    assert trial.exx_supera is not None
    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"taylor_impl": "pallas"},
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               device="cpu")
    assert not af.use_fast_block
    rows = af.run()
    assert rows.shape == (100, 11) and np.isfinite(rows.real).all()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                  theirs.std(ddof=1) / np.sqrt(len(theirs)))
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.02), (mine.mean(), theirs.mean(), se)


def test_h5_layout_matches_jax_driver(tmp_path):
    kw = dict(nwalkers=8, dt=0.01, nsteps=4, nblocks=3, rng_seed=2)
    eopts = {"mixed": {"energy_eval_freq": 1}}
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=21)
    jham = j_make_generic((2, 2), h1e, chol, enuc)
    JAFQMC(jham, jtrial.rhf_identity_trial(jham), JQMCOpts(**kw),
           estimator_options=eopts, filename=str(tmp_path / "jax.h5")).run()
    ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    AFQMC(ham, rhf_identity_trial(ham, **CPU), QMCOpts(**kw),
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
    assert row.shape == (11,) and row[0].real == 12
    assert np.isfinite(row.real).all()


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_generic((2, 2), h1e, chol, enuc)
    ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rhf_identity_trial(ham)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.generic(np.zeros((2, 5, 5)), np.zeros((2, 5, 5)),
                        np.zeros((5, 5, 3)), ecore=0.0, nup=2, ndown=2)
    trial = rhf_identity_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AFQMC(ham, trial, qmc)
    rows = AFQMC(ham, trial, qmc, device="cpu").run()
    assert np.isfinite(rows.real).all()


@pytest.mark.parametrize("popts", [
    {"stochastic_ri": True},
    {"hubbard_stratonovich": "discrete"},
    {"taylor_impl": "xla_3m"},
])
def test_unported_generic_configurations_raise(popts):
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=2)
    ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1)
    if "discrete" not in popts.get("hubbard_stratonovich", ""):
        # stochastic_ri and taylor_impl="xla_3m" are ported now and run
        # (their steps are held against JAX in
        # test_torch_generic_variants.py); the discrete Generic case stays
        # a refusal.
        rows = AFQMC(ham, trial, qmc, propagator_options=popts,
                     device="cpu").run()
        assert np.isfinite(rows).all()
        return
    with pytest.raises(NotImplementedError):
        AFQMC(ham, trial, qmc, propagator_options=popts, device="cpu")


@pytest.mark.parametrize("popts", [
    {"free_projection": True},
    {"hybrid": False},
])
def test_formerly_unported_generic_configurations_run(popts):
    """Free projection and the local-energy update now run (their
    trajectories are held against JAX in test_torch_run_modes.py)."""
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=2)
    ham = make_generic((2, 2), h1e, chol, enuc, **CPU)
    trial = rhf_identity_trial(ham, **CPU)
    rows = AFQMC(ham, trial, QMCOpts(nwalkers=4, dt=0.01, nsteps=2,
                                     nblocks=2),
                 propagator_options=popts,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 device="cpu").run()
    assert rows.shape == (2, 11) and np.isfinite(rows).all()


def test_supermatrix_cap_routes_the_energy(monkeypatch):
    """Past the cap an AFQMC run's energy takes the exchange kernel's route
    (its plain version on the CPU) and matches the supermatrix energy."""
    g, ham, trial = golden_system()
    monkeypatch.setattr(ttrial, "EXX_SUPER_MAX_ELEMS", 1)
    _, _, capped = golden_system()
    assert capped.exx_supera is None and trial.exx_supera is not None
    rows = []
    for t in (trial, capped):
        af = AFQMC(ham, t, QMCOpts(nwalkers=6, dt=0.005, nsteps=3, nblocks=2,
                                   rng_seed=4),
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   device="cpu")
        rows.append(af.run()[:, :-1])
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-10, atol=1e-12)


def test_generic_run_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from pauxy_tpu_torch.models import make_generic, "
        "rhf_identity_trial\n"
        "from pauxy_tpu_torch.qmc import AFQMC, QMCOpts\n"
        "rng = np.random.default_rng(7)\n"
        "chol = rng.normal(scale=0.05, size=(6, 6, 10))\n"
        "chol = 0.5 * (chol + chol.transpose(1, 0, 2))\n"
        "h1 = rng.normal(scale=0.1, size=(6, 6))\n"
        "ham = make_generic((2, 2), 0.5 * (h1 + h1.T), chol, "
        "device='cpu', dtype='double')\n"
        "trial = rhf_identity_trial(ham, device='cpu', dtype='double')\n"
        "rows = AFQMC(ham, trial, QMCOpts(nwalkers=8, dt=0.01, nsteps=4, "
        "nblocks=2, nstblz=2), propagator_options={'taylor_impl': "
        "'pallas'}, device='cpu').run()\n"
        "assert rows.shape == (2, 11)\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pauxy_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
