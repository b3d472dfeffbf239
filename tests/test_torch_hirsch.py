"""Port parity: the discrete (Hirsch) propagator against the JAX package.

* make_hirsch's tables (spin and charge) at 1e-12, and the U < 0 spin error;
* _auto_sweep_kernel's choice against JAX's rule (JAX's "pallas*" is the
  port's "kernel");
* the kinetic half-step with its phase constraint, float64, 1e-10;
* hirsch_sweep_real_plain against sweep_pallas.hirsch_sweep_real in
  interpret mode, float64, same draws: 1e-10, identical fields;
* the "scan" sweep against JAX's lax.scan sweep on complex (charge
  decomposition) walkers, float64, same draws: 1e-10, identical fields;
* ``sweep_mirror``, the sweep kernel's order of work (lane r's scalars,
  the gathered sums added in order), against hirsch_sweep_real_plain in
  float64 at 1e-12 with identical fields, dead walkers included, up to
  32 electrons in a spin and at na != nb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.models import free_electron_trial, make_hubbard
from pauxy_tpu.ops import sweep_pallas
from pauxy_tpu.propagation import hirsch as jhirsch
from pauxy_tpu.walkers import init_walkers
from pauxy_tpu_torch.ops import sweep_cuda
from pauxy_tpu_torch.propagation import hirsch as thirsch
from pauxy_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype="double")
STATE_FIELDS = ("phia", "phib", "weight", "unscaled_weight", "log_ovlp",
                "hybrid_energy", "log_detr", "total_weight")


def close(a, b, tol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def port_objects(ham, trial, prop=None):
    tham = convert.hubbard(np.asarray(ham.T), ham.U, ham.symmetric,
                           nx=ham.nx, ny=ham.ny, nup=ham.nup,
                           ndown=ham.ndown, device="cpu")
    ttrial = convert.trial(np.asarray(trial.psia), np.asarray(trial.psib),
                           trial.etrial, device="cpu")
    if prop is None:
        return tham, ttrial
    tprop = convert.hirsch(np.asarray(prop.BT2), np.asarray(prop.auxf),
                           np.asarray(prop.aux_wfac), dt=prop.dt,
                           charge=prop.charge, gamma=prop.gamma,
                           sweep_kernel="scan", device="cpu")
    return tham, ttrial, tprop


def port_state(js):
    return convert.walker_state(**{f: np.asarray(getattr(js, f))
                                   for f in STATE_FIELDS}, device="cpu")


def perturbed_state(trial, nw, seed, complex_noise):
    state = init_walkers(trial, nw)
    rng = np.random.default_rng(seed)
    pa = 0.1 * rng.standard_normal(state.phia.shape)
    pb = 0.1 * rng.standard_normal(state.phib.shape)
    if complex_noise:
        pa = pa + 0.1j * rng.standard_normal(state.phia.shape)
        pb = pb + 0.1j * rng.standard_normal(state.phib.shape)
    return state.replace(phia=state.phia + pa, phib=state.phib + pb)


@pytest.mark.parametrize("charge", [False, True])
@pytest.mark.parametrize("kw", [
    dict(nup=7, ndown=7, U=4.0, nx=4, ny=4),
    dict(nup=3, ndown=2, U=2.0, nx=3, ny=3, ktwist=[0.01, -0.02]),
])
def test_make_hirsch_tables_match_jax(charge, kw):
    jh = make_hubbard(**kw)
    jt = free_electron_trial(jh)
    jp = jhirsch.make_hirsch(jh, jt, 0.05, charge_decomposition=charge)
    th, tt = port_objects(jh, jt)
    tp = thirsch.make_hirsch(th, tt, 0.05, charge_decomposition=charge,
                             **CPU)
    for name in ("BT2", "auxf", "aux_wfac"):
        close(getattr(tp, name).numpy(), getattr(jp, name), 1e-12)
    close(tp.delta.numpy(), jp.delta, 1e-12)
    assert tp.gamma == pytest.approx(jp.gamma, rel=1e-12)
    assert (tp.dt, tp.charge, tp.hybrid) == (jp.dt, jp.charge, jp.hybrid)
    assert {n for n, _ in tp.named_buffers()} == {"BT2", "auxf", "aux_wfac"}


def test_spin_decomposition_needs_repulsive_u():
    jh = make_hubbard(nup=2, ndown=2, U=-2.0, nx=2, ny=2)
    jt = free_electron_trial(jh)
    th, tt = port_objects(jh, jt)
    with pytest.raises(ValueError, match="U >= 0"):
        jhirsch.make_hirsch(jh, jt, 0.01)
    with pytest.raises(ValueError, match="U >= 0"):
        thirsch.make_hirsch(th, tt, 0.01, **CPU)
    # For attractive U the charge tables are real: the kernel takes them.
    tp = thirsch.make_hirsch(th, tt, 0.01, charge_decomposition=True, **CPU)
    assert tp.sweep_kernel == "kernel"
    assert np.abs(tp.auxf.numpy().imag).max() == 0.0


@pytest.mark.parametrize("case,want", [
    (dict(nup=7, ndown=7, nx=4, ny=4), "kernel"),
    (dict(nup=4, ndown=2, nx=3, ny=3), "kernel"),
    (dict(nup=7, ndown=7, nx=4, ny=4, ktwist=[0.02, -0.01]), "scan"),
    (dict(nup=7, ndown=7, nx=4, ny=4, charge=True), "scan"),
    (dict(nup=33, ndown=31, nx=8, ny=8), "scan"),
    (dict(nup=3, ndown=0, nx=3, ny=3), "scan"),
])
def test_auto_sweep_kernel_chooses_as_jax(case, want):
    case = dict(case)
    charge = case.pop("charge", False)
    jh = make_hubbard(U=4.0, **case)
    jt = free_electron_trial(jh)
    # JAX keys its choice also on the device count (a mesh of 8 virtual
    # CPU devices here); a mesh object takes that condition out.
    jp = jhirsch.make_hirsch(jh, jt, 0.01, charge_decomposition=charge)
    jchoice = jhirsch._auto_sweep_kernel(jt, np.asarray(jh.T), jp.auxf,
                                         jp.aux_wfac, False, "single_site",
                                         mesh=object())
    th, tt = port_objects(jh, jt)
    tp = thirsch.make_hirsch(th, tt, 0.01, charge_decomposition=charge,
                             **CPU)
    assert tp.sweep_kernel == want
    assert ("kernel" if jchoice.startswith("pallas") else "scan") == want
    assert thirsch._auto_sweep_kernel(
        tt, th.T.numpy(), tp.auxf.numpy(), tp.aux_wfac.numpy(), True,
        "single_site", ) == "scan"


def test_unported_options_raise():
    jh = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    th, tt = port_objects(jh, free_electron_trial(jh))
    # JAX's mesh= (its per-shard kernel dispatch) is accepted now: on the
    # port's walker mesh each rank sweeps its own walkers, so the tables
    # are the unsharded ones (tests/test_torch_mesh_zero.py runs it).
    tm = thirsch.make_hirsch(th, tt, 0.01, mesh=object(), **CPU)
    tp = thirsch.make_hirsch(th, tt, 0.01, **CPU)
    assert tm.sweep_kernel == tp.sweep_kernel
    assert torch.equal(tm.BT2, tp.BT2) and torch.equal(tm.auxf, tp.auxf)
    with pytest.raises(ValueError):
        thirsch.Hirsch(tp.BT2, tp.auxf, tp.aux_wfac, dt=0.01,
                       sweep_kernel="pallas")
    with pytest.raises(ValueError):
        thirsch.Hirsch(tp.BT2, tp.auxf, tp.aux_wfac, dt=0.01,
                       two_body_mode="lattice")


@pytest.mark.parametrize("kw", [dict(free_projection=True),
                                dict(two_body_mode="direct"),
                                dict(kinetic_kspace=True)])
def test_formerly_unported_options_build_as_jax(kw):
    """Free projection, the direct update and kinetic_kspace build the
    JAX package's tables and flags (their steps and blocks are held
    against JAX in test_torch_run_modes.py); none of them takes the sweep
    kernel."""
    jh = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    jt = free_electron_trial(jh)
    th, tt = port_objects(jh, jt)
    jp = jhirsch.make_hirsch(jh, jt, 0.01, sweep_kernel="scan", **kw)
    tp = thirsch.make_hirsch(th, tt, 0.01, **kw, **CPU)
    for name in ("BT2", "auxf", "aux_wfac"):
        close(getattr(tp, name).numpy(), getattr(jp, name), 1e-12)
    assert (tp.free_projection, tp.two_body_mode, tp.nx, tp.ny) == (
        jp.free_projection, jp.two_body_mode, jp.nx, jp.ny)
    assert (tp.btk is None) == (jp.btk is None)
    if tp.btk is not None:
        close(tp.btk.numpy(), jp.btk, 1e-12)
    assert tp.sweep_kernel == ("kernel" if "kinetic_kspace" in kw
                               else "scan")


@pytest.mark.parametrize("charge", [False, True])
def test_kinetic_half_step_matches_jax(charge):
    jh = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    jt = free_electron_trial(jh)
    jp = jhirsch.make_hirsch(jh, jt, 0.05, charge_decomposition=charge)
    js = perturbed_state(jt, 12, 1, complex_noise=True)
    # A walker whose overlap ratio leaves the half plane is killed.
    js = js.replace(log_ovlp=js.log_ovlp.at[0].add(3.0j))
    th, tt, tp = port_objects(jh, jt, jp)
    jnew = jp._kinetic_half_step(jt, js)
    tnew = tp._kinetic_half_step(tt, port_state(js))
    close(tnew.phia.numpy(), jnew.phia)
    close(tnew.phib.numpy(), jnew.phib)
    close(tnew.weight.numpy(), jnew.weight)
    assert float(tnew.weight[0]) == 0.0 == float(jnew.weight[0])
    d = tnew.log_ovlp.numpy() - np.asarray(jnew.log_ovlp)
    close(d.real, 0.0)
    close(np.angle(np.exp(1j * d.imag)), 0.0)


@pytest.mark.parametrize("na,nb,nw", [(4, 2, 37), (3, 3, 5)])
def test_sweep_plain_matches_pallas_interpret(na, nb, nw):
    jh = make_hubbard(nup=na, ndown=nb, U=4.0, nx=3, ny=3)
    jt = free_electron_trial(jh)
    jp = jhirsch.make_hirsch(jh, jt, 0.05)
    js = perturbed_state(jt, nw, 2, complex_noise=False)
    rdt = jnp.float64
    psia, psib = jt.psia.real, jt.psib.real
    phia, phib = js.phia.real, js.phib.real
    inva = jnp.linalg.inv(jnp.einsum("mi,wmj->wij", psia, phia))
    invb = jnp.linalg.inv(jnp.einsum("mi,wmj->wij", psib, phib))
    rs = jax.random.uniform(jax.random.key(4), (9, nw), dtype=rdt)
    weight = js.weight.at[3].set(0.0)
    args = (psia, psib, jp.delta.real, jp.aux_wfac.real, phia, phib, inva,
            invb, rs, weight)
    jout = sweep_pallas.hirsch_sweep_real(*args, interpret=True)
    tout = sweep_cuda.hirsch_sweep_real(
        *(torch.from_numpy(np.array(a)) for a in args))
    for t, j in zip(tout[:4], jout[:4]):
        assert t.dtype == torch.float64
        close(t.numpy(), j)
    assert tout[4].dtype == torch.int32
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    assert float(tout[2][3]) == 0.0 and float(tout[3][3]) == 0.0


@pytest.mark.parametrize("charge", [True, False])
def test_scan_sweep_matches_jax_scan(charge):
    jh = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    jt = free_electron_trial(jh)
    jp = jhirsch.make_hirsch(jh, jt, 0.05, charge_decomposition=charge,
                             sweep_kernel="scan")
    js = perturbed_state(jt, 6, 3, complex_noise=True)
    key = jax.random.key(5)
    jnew, jfields = jp._site_sweep(jt, js, key)
    rs = torch.from_numpy(np.array(
        jax.random.uniform(key, (9, 6), dtype=jnp.float64)))
    th, tt, tp = port_objects(jh, jt, jp)
    tnew, tfields = tp._site_sweep(tt, port_state(js), rs=rs)
    close(tnew.phia.numpy(), jnew.phia)
    close(tnew.phib.numpy(), jnew.phib)
    close(tnew.weight.numpy(), jnew.weight)
    d = tnew.log_ovlp.numpy() - np.asarray(jnew.log_ovlp)
    close(d.real, 0.0)
    close(np.angle(np.exp(1j * d.imag)), 0.0)
    np.testing.assert_array_equal(tfields.numpy(), np.asarray(jfields))


def test_kernel_sweep_on_cpu_is_the_plain_version():
    """The "kernel" route on a CPU tensor runs hirsch_sweep_real_plain and
    follows the scan route on the same draws (real walkers)."""
    jh = make_hubbard(nup=3, ndown=2, U=4.0, nx=3, ny=3)
    jt = free_electron_trial(jh)
    jp = jhirsch.make_hirsch(jh, jt, 0.05)
    th, tt, tp = port_objects(jh, jt, jp)
    tk = convert.hirsch(np.asarray(jp.BT2), np.asarray(jp.auxf),
                        np.asarray(jp.aux_wfac), dt=jp.dt, charge=False,
                        gamma=jp.gamma, sweep_kernel="kernel", device="cpu")
    state = port_state(perturbed_state(jt, 7, 4, complex_noise=False))
    rs = torch.from_numpy(np.random.default_rng(0).uniform(size=(9, 7)))
    before = sweep_cuda.launches
    a, fa = tk._site_sweep(tt, state, rs=rs)
    b, fb = tp._site_sweep(tt, state, rs=rs)
    assert sweep_cuda.launches == before
    assert a.phia.dtype == torch.complex128
    close(a.phia.numpy(), b.phia.numpy())
    close(a.weight.numpy(), b.weight.numpy())
    close(a.log_ovlp.numpy().real, b.log_ovlp.numpy().real)
    np.testing.assert_array_equal(fa.numpy(), fb.numpy())


def sweep_mirror(psia, psib, delta, wfac, phia, phib, inva, invb, rs,
                 weight):
    """csrc/sweep.cu's order of work, batched over walkers, plain torch:
    column [:, r] is lane r's value. q[r] from column r of S^-1, G_ii the
    ordered sum of psi[a] q[a]; t1[r] from row r, t2[r] from column r;
    1 + vt . t1 the ordered sum of lane products; the rank-1 update row by
    row, scaled by one reciprocal of it."""
    w, m, na = phia.shape
    inv = [inva.clone(), invb.clone()]
    psi = (psia, psib)
    out = [phia.clone(), phib.clone()]
    (d00, d01), (d10, d11) = delta
    wt = weight.clone()
    dlog = torch.zeros_like(wt)
    fields = torch.zeros((w, m), dtype=torch.int32)

    def ordered(terms):              # terms [w, n]: sum over n in order
        acc = torch.zeros(terms.shape[0], dtype=terms.dtype)
        for a in range(terms.shape[1]):
            acc = acc + terms[:, a]
        return acc

    for i in range(m):
        rows = [out[0][:, i].clone(), out[1][:, i].clone()]
        g = []
        for sp in range(2):
            n = rows[sp].shape[1]
            q = torch.zeros_like(rows[sp])
            for b in range(n):
                q = q + inv[sp][:, b, :] * rows[sp][:, b:b + 1]
            g.append(ordered(psi[sp][i] * q))
        p0 = 0.5 * (1.0 + d00 * g[0]) * (1.0 + d01 * g[1]) * wfac[0]
        p1 = 0.5 * (1.0 + d10 * g[0]) * (1.0 + d11 * g[1]) * wfac[1]
        pr0 = torch.clamp_min(p0, 0.0)
        norm = pr0 + torch.clamp_min(p1, 0.0)
        alive = (norm > 0) & (wt != 0)
        xi = rs[i] >= pr0 / torch.where(alive, norm, torch.ones_like(norm))
        wt = torch.where(alive, wt * norm, torch.zeros_like(wt))
        dlog = dlog + torch.where(
            alive, torch.log(2.0 * torch.where(xi, p1, p0)),
            torch.zeros_like(dlog))
        fields[:, i] = xi.to(torch.int32)
        zero = torch.zeros_like(wt)
        dsp = (torch.where(alive, torch.where(xi, d10, d00), zero),
               torch.where(alive, torch.where(xi, d11, d01), zero))
        for sp in range(2):
            n = rows[sp].shape[1]
            vt = rows[sp] * dsp[sp][:, None]
            out[sp][:, i] = rows[sp] + vt
            t1 = torch.zeros_like(vt)
            t2 = torch.zeros_like(vt)
            for b in range(n):
                t1 = t1 + psi[sp][i, b] * inv[sp][:, :, b]
                t2 = t2 + vt[:, b:b + 1] * inv[sp][:, b, :]
            rden = 1.0 / (1.0 + ordered(vt * t1))
            inv[sp] = inv[sp] - t1[:, :, None] * t2[:, None, :] \
                * rden[:, None, None]
    return out[0], out[1], wt, dlog, fields


def sweep_case(m, na, nb, w, seed):
    """Walkers near an orthonormal trial (float64), the spin tables of
    dt=0.01, U=4, every seventh walker dead (weight 0)."""
    rng = np.random.default_rng(seed)
    psia = np.linalg.qr(rng.normal(size=(m, na)))[0]
    psib = np.linalg.qr(rng.normal(size=(m, nb)))[0]
    phia = psia[None] + 0.1 * rng.normal(size=(w, m, na))
    phib = psib[None] + 0.1 * rng.normal(size=(w, m, nb))
    inva = np.linalg.inv(np.einsum("mi,wmj->wij", psia, phia))
    invb = np.linalg.inv(np.einsum("mi,wmj->wij", psib, phib))
    g = np.arccosh(np.exp(0.5 * 0.01 * 4.0))
    delta = np.exp(-0.02) * np.array([[np.exp(g), np.exp(-g)],
                                      [np.exp(-g), np.exp(g)]]) - 1.0
    weight = np.ones(w)
    weight[::7] = 0.0
    return [torch.from_numpy(a) for a in (
        psia, psib, delta, np.ones(2), phia, phib, inva, invb,
        rng.uniform(size=(m, w)), weight)]


@pytest.mark.parametrize("m,na,nb", [(9, 3, 3), (16, 7, 7), (9, 4, 2),
                                     (36, 32, 5), (36, 3, 32)])
def test_sweep_mirror_matches_plain_f64(m, na, nb):
    args = sweep_case(m, na, nb, 15, m + na + nb)
    assert sweep_cuda.plan(na, nb).lanes == 1 << (max(na, nb) - 1).bit_length()
    mine = sweep_mirror(*args)
    ref = sweep_cuda.hirsch_sweep_real_plain(*args)
    for a, b in zip(mine[:4], ref[:4]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a - b).abs().max().item() <= 1e-12 * max(
            b.abs().max().item(), 1.0)
    assert torch.equal(mine[4], ref[4])
    dead = args[9] == 0
    assert bool((mine[2][dead] == 0).all() and (mine[3][dead] == 0).all())
    assert torch.equal(mine[0][dead], args[4][dead])
