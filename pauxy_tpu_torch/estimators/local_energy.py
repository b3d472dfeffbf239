"""Hubbard, Hubbard-Holstein, Generic, UEG and PW_FFT local energies:
walker-batched and host-side, for single- and multi-determinant trials.

Counterpart of ``local_energy_hubbard``, ``local_energy_hubbard_holstein``,
``local_energy_multi_coherent``, ``local_energy_generic_opt``,
``_exx``, ``local_energy_generic_opt_multi``, the Generic variants
(``local_energy_generic_exact_eri``, ``_stochastic_ri``, ``_pno``),
``local_energy_hubbard_ghf``,
``local_energy_generic_cholesky_G``, the UEG gather kernels
(``coulomb_greens_function_ueg``, ``exchange_greens_function_ueg``,
``local_energy_ueg``), the pseudo-spectral FFT energies
(``fft_coulomb_terms``, ``_fft_spin_terms``, ``structure_factor_ueg``,
``local_energy_ueg_half``, ``local_energy_pw_fft``) and
``local_energy_G_host`` in ``pauxy_tpu/estimators/local_energy.py``. The
lanes block of ``qmc/hubbard_fast.py`` keeps its own fused energy. JAX's
cube scatter ``_pw_cubes`` is ``propagation/pw_fft.to_cube`` here.

The FFT terms are correlations on the (4 nmax + 1)^3 cube, exact (the cube
holds every k +/- q without aliasing). Their exchange sums are formed only
at the q vectors' cube points (``qmap``), where JAX forms them on the whole
cube and then gathers: the same values, without the cube-sized product.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from pauxy_tpu_torch.ops import exx_cuda
from pauxy_tpu_torch.ops.contract import cr_einsum, rc_einsum
from pauxy_tpu_torch.parallel import mesh as pmesh
from pauxy_tpu_torch.propagation.pw_fft import fft3, ifft3, neg_perm, to_cube
from pauxy_tpu_torch.utils.tracing import span

# Elements of one chunk of the dense-G exchange intermediate
# t[w, l, k, x] = sum_i G[w, i, l] L[i, k, x] (2^26: 512 MB in complex64).
CHOLESKY_G_MAX_ELEMS = 2 ** 26


def local_energy_hubbard(ham, Ga: torch.Tensor, Gb: torch.Tensor):
    """(etot, e1b, e2b), each [w], from G [w, M, M] of both spins:
    ke = sum T_s * G_s; pe = U sum_i G_up[ii] G_dn[ii], or
    -U/2 (tr G_up + tr G_dn) in the symmetric form."""
    t = ham.T.to(Ga.dtype)
    ke = (torch.einsum("mn,wmn->w", t[0], Ga)
          + torch.einsum("mn,wmn->w", t[1], Gb))
    da = torch.diagonal(Ga, dim1=-2, dim2=-1)
    db = torch.diagonal(Gb, dim1=-2, dim2=-1)
    if ham.symmetric:
        pe = -0.5 * ham.U * (da.sum(-1) + db.sum(-1))
    else:
        pe = ham.U * torch.sum(da * db, dim=-1)
    return ke + pe, ke, pe


def local_energy_hubbard_holstein(ham, Ga: torch.Tensor, Gb: torch.Tensor,
                                  X: torch.Tensor, shift: torch.Tensor):
    """(etot, e_el, e_ph), each [w], of the Hubbard-Holstein model: the
    Hubbard energy of G, the phonon potential and kinetic (trial-laplacian)
    energies at X [w, M], and the coupling -g sqrt(2 m w0) sum_i rho_i X_i.
    """
    from pauxy_tpu_torch.models import hubbard_holstein as hh

    etot_el, ke, pe = local_energy_hubbard(ham, Ga, Gb)
    pe_ph = 0.5 * ham.m * ham.w0 ** 2 * torch.sum(X * X, dim=-1)
    lap = hh.ho_laplacian(X, ham.m, ham.w0, shift)
    ke_ph = -0.5 * torch.sum(lap, dim=-1) / ham.m - 0.5 * ham.w0 * ham.nbasis
    rho = (torch.diagonal(Ga, dim1=-2, dim2=-1)
           + torch.diagonal(Gb, dim1=-2, dim2=-1))
    e_eph = -ham.gsq2mw * torch.sum(rho * X, dim=-1)
    return etot_el + pe_ph + ke_ph + e_eph, ke + pe, pe_ph + ke_ph + e_eph


def local_energy_multi_coherent(ham, Gi: torch.Tensor, comp_w: torch.Tensor,
                                X: torch.Tensor, lap: torch.Tensor):
    """(etot, e_el, e_ph), each [w], of the Hubbard-Holstein model with a
    multi-coherent trial: the electron and coupling terms of each
    component's Gi [w, P, 2, M, M] weighted by comp_w [w, P], and the
    phonon kinetic term from the mixture's laplacian lap [w, M]."""
    t = ham.T.to(Gi.dtype)
    ke_p = (torch.einsum("mn,wpmn->wp", t[0], Gi[:, :, 0])
            + torch.einsum("mn,wpmn->wp", t[1], Gi[:, :, 1]))
    da = torch.diagonal(Gi[:, :, 0], dim1=-2, dim2=-1)      # [w, P, M]
    db = torch.diagonal(Gi[:, :, 1], dim1=-2, dim2=-1)
    pe_p = ham.U * torch.sum(da * db, dim=-1)
    e_eph_p = -ham.gsq2mw * torch.sum((da + db) * X[:, None, :], dim=-1)
    e_el = torch.sum(comp_w * (ke_p + pe_p), dim=-1)
    e_eph = torch.sum(comp_w * e_eph_p, dim=-1)
    pe_ph = 0.5 * ham.m * ham.w0 ** 2 * torch.sum(X * X, dim=-1)
    ke_ph = -0.5 * torch.sum(lap, dim=-1) / ham.m - 0.5 * ham.w0 * ham.nbasis
    return e_el + pe_ph + ke_ph + e_eph, e_el, pe_ph + ke_ph + e_eph


def local_energy_generic_opt(trial, Ghalfa: torch.Tensor,
                             Ghalfb: torch.Tensor, ecore: float):
    """(etot, e1b, e2b), each [w], from the half-rotated Green's functions
    Ghalf_s [w, n_s, M] and the trial's half-rotated tensors:
      e1b = sum_{i m} rh1_s[i, m] Ghalf_s[w, i, m] + ecore,
      X_s[w, x] = sum_{i m} rchol_s[x, i, m] Ghalf_s[w, i, m],
      e2b = 0.5 ((Xa + Xb).(Xa + Xb) - exx_a - exx_b),
    with both spins' exchange (``_exx``) in the span ``exchange``."""
    e1b = (cr_einsum("im,wim->w", trial.rh1a, Ghalfa)
           + cr_einsum("im,wim->w", trial.rh1b, Ghalfb))
    x = (cr_einsum("xim,wim->wx", trial.rchola, Ghalfa)
         + cr_einsum("xim,wim->wx", trial.rcholb, Ghalfb))
    ecoul = torch.sum(x * x, dim=-1)
    with span("exchange"):
        exx = (_exx(trial.rchola, Ghalfa, trial.exx_supera)
               + _exx(trial.rcholb, Ghalfb, trial.exx_superb))
    # On a [walker, chol] mesh both are partial sums over this rank's X
    # slice (the supermatrix is dropped there).
    if pmesh.chol_sharded():
        ecoul, exx = pmesh.chol_sum(torch.stack([ecoul,
                                                 exx.to(ecoul.dtype)]))
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ecore, e1b + ecore, e2b


def _exx(rchol: torch.Tensor, ghalf: torch.Tensor,
         exx_super: torch.Tensor | None = None) -> torch.Tensor:
    """exx[w] = sum_x tr(T_x(w) T_x(w)), T_x(w) = rchol_x Ghalf_w^T, by
    JAX's three routes in JAX's order: the exchange supermatrix (one GEMM,
    exx_w = vec(Ghalf_w)^T C vec(Ghalf_w)); the exchange kernel for a real
    rchol and complex ghalf (``ops/exx_cuda``; its plain version on a CPU
    tensor); else the einsum route, chunked over the Cholesky axis
    (``exx_cuda.exx_plain``)."""
    w = ghalf.shape[0]
    if exx_super is not None:
        gv = ghalf.reshape(w, -1)
        return torch.sum(gv * cr_einsum("pq,wq->wp", exx_super, gv), dim=-1)
    if not rchol.is_complex() and ghalf.is_complex():
        return exx_cuda.exx(rchol, ghalf.contiguous())
    return exx_cuda.exx_plain(rchol, ghalf)


def local_energy_generic_opt_multi(trial, Ghalfa: torch.Tensor,
                                   Ghalfb: torch.Tensor,
                                   det_weights: torch.Tensor, ecore: float):
    """(etot, e1b, e2b), each [w], of a Generic system with a
    multi-determinant trial: :func:`local_energy_generic_opt` per
    determinant (rchol_s [D, X, n, M], rh1_s [D, n, M], Ghalf_s
    [w, D, n, M]), averaged with the weights det_weights [w, D]. The
    per-determinant rchol is complex, so each exchange takes the einsum
    route, chunked over the Cholesky axis (``exx_cuda.exx_plain``), all of
    them in the span ``exchange``."""
    rca, rcb = trial.rchola, trial.rcholb
    e1_d = (cr_einsum("dim,wdim->wd", trial.rh1a, Ghalfa)
            + cr_einsum("dim,wdim->wd", trial.rh1b, Ghalfb))
    x = (cr_einsum("dxim,wdim->wdx", rca, Ghalfa)
         + cr_einsum("dxim,wdim->wdx", rcb, Ghalfb))
    ecoul_d = torch.einsum("wdx,wdx->wd", x, x)
    with span("exchange"):
        exx_d = torch.stack([_exx(rca[d], Ghalfa[:, d])
                             + _exx(rcb[d], Ghalfb[:, d])
                             for d in range(rca.shape[0])], dim=1)
    if pmesh.chol_sharded():
        ecoul_d, exx_d = pmesh.chol_sum(torch.stack(
            [ecoul_d, exx_d.to(ecoul_d.dtype)]))
    e2_d = 0.5 * (ecoul_d - exx_d)
    e1b = torch.sum(det_weights * e1_d, dim=-1) + ecore
    e2b = torch.sum(det_weights * e2_d, dim=-1)
    return e1b + e2b, e1b, e2b


def _e1b_half(trial, Ghalfa, Ghalfb, ecore: float) -> torch.Tensor:
    return (cr_einsum("im,wim->w", trial.rh1a, Ghalfa)
            + cr_einsum("im,wim->w", trial.rh1b, Ghalfb) + ecore)


def local_energy_generic_exact_eri(trial, Ghalfa: torch.Tensor,
                                   Ghalfb: torch.Tensor, ecore: float):
    """(etot, e1b, e2b), each [w], with E2 from the trial's half-rotated
    ERIs v_ipjq [n, M, n', M]: the Coulomb terms v_ipjq G_ip G_jq and the
    same-spin exchange -v_ipjq G_iq G_jp."""
    e1b = _e1b_half(trial, Ghalfa, Ghalfb, ecore)

    def pair(eri, g1, g2, exchange: bool):
        # Coulomb: sum_ipjq v_ipjq g1[w,i,p] g2[w,j,q], one [w, nM] x
        # [nM, n'M] product; exchange: sum_ipjq v_ipjq g1[w,i,q] g2[w,j,p].
        if exchange:
            tmp = torch.einsum("ipjq,wjp->wiq", eri, g2)
            return torch.sum(tmp * g1, dim=(1, 2))
        w = g1.shape[0]
        n1, m, n2, _ = eri.shape
        tmp = g1.reshape(w, n1 * m) @ eri.reshape(n1 * m, n2 * m)
        return torch.sum(tmp * g2.reshape(w, n2 * m), dim=-1)

    e2b = (0.5 * pair(trial.eri_aa, Ghalfa, Ghalfa, False)
           + 0.5 * pair(trial.eri_bb, Ghalfb, Ghalfb, False)
           + pair(trial.eri_ab, Ghalfa, Ghalfb, False)
           - 0.5 * pair(trial.eri_aa, Ghalfa, Ghalfa, True)
           - 0.5 * pair(trial.eri_bb, Ghalfb, Ghalfb, True))
    return e1b + e2b, e1b, e2b


def rademacher(shape, dtype, generator=None, device=None) -> torch.Tensor:
    """+1 / -1 draws with equal probability, of ``dtype``."""
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def local_energy_generic_stochastic_ri(trial, Ghalfa: torch.Tensor,
                                       Ghalfb: torch.Tensor, ecore: float,
                                       theta: torch.Tensor,
                                       control_variate: bool):
    """(etot, e1b, e2b), each [w], with the exact Coulomb term and the
    exchange estimated from the Rademacher probes theta [X, nsamples]
    shared by every walker:

      exx_s = (1/S) sum_s sum_kl (G_k . ra_l,s)(G_l . ra_k,s),
      ra[i, p, s] = sum_X rchol[X, i, p] theta[X, s];

    with ``control_variate`` the trial's exact exchange plus the walker's
    estimate minus the trial's estimate from the same probes. On a
    [walker, chol] mesh rchol and theta hold this rank's X rows: the
    exchange is quadratic in ra, so both spins' ra and the Coulomb term's
    partial X.X are summed over the chol group (one all_reduce) before
    the exchange is formed."""
    rca, rcb = trial.rchola, trial.rcholb
    e1b = _e1b_half(trial, Ghalfa, Ghalfb, ecore)
    x = (cr_einsum("xim,wim->wx", rca, Ghalfa)
         + cr_einsum("xim,wim->wx", rcb, Ghalfb))
    ecoul = torch.sum(x * x, dim=-1)
    theta = theta.to(rca.dtype)
    scale = 1.0 / theta.shape[1]
    ra = torch.einsum("xip,xs->ips", rca, theta)
    rb = torch.einsum("xip,xs->ips", rcb, theta)
    if pmesh.chol_sharded():
        dt = torch.promote_types(ecoul.dtype, ra.dtype)
        flat = pmesh.chol_sum(torch.cat([
            ecoul.to(dt), ra.reshape(-1).to(dt), rb.reshape(-1).to(dt)]))
        w, na = ecoul.shape[0], ra.numel()
        ecoul = flat[:w] if ecoul.is_complex() else flat[:w].real
        rest = flat[w:] if ra.is_complex() else flat[w:].real
        ra, rb = rest[:na].reshape(ra.shape), rest[na:].reshape(rb.shape)

    def exx_stoch(r, ghalf):
        r = r.to(ghalf.dtype)
        gra = torch.einsum("wkq,lqs->wlks", ghalf, r)
        return scale * torch.einsum("wlks,wkls->w", gra, gra)

    exxa = exx_stoch(ra, Ghalfa)
    exxb = exx_stoch(rb, Ghalfb)
    if control_variate:
        _, exxa0, exxb0 = trial.e0_terms
        exxa = exxa0 + (exxa - exx_stoch(ra, trial.ghalf0a[None])[0])
        exxb = exxb0 + (exxb - exx_stoch(rb, trial.ghalf0b[None])[0])
    e2b = 0.5 * (ecoul - exxa - exxb)
    return e1b + e2b, e1b, e2b


def local_energy_generic_pno(trial, Ghalfa: torch.Tensor,
                             Ghalfb: torch.Tensor, ecore: float):
    """(etot, e1b, e2b), each [w], with E2 the trial's exact two-body
    energy plus the PNO-truncated pair corrections relative to the trial
    (each pair's SVD factors U, VT from ``trial.pno_*``)."""
    e1b = _e1b_half(trial, Ghalfa, Ghalfb, ecore)

    def channel(pno, ga, gb, g0a, g0b, exchange: bool):
        idx_i, idx_j, coeff, u, vt = pno

        def dot_uv(a, b):                                # [..., n]
            tu = torch.einsum("...np,npk->...nk", a, u)
            tv = torch.einsum("...np,nkp->...nk", b, vt)
            return torch.sum(tu * tv, dim=-1)

        gi, gj = ga[:, idx_i, :], gb[:, idx_j, :]
        g0i, g0j = g0a[idx_i, :], g0b[idx_j, :]
        ej = torch.einsum("n,wn->w", coeff,
                          dot_uv(gi, gj) - dot_uv(g0i, g0j)[None])
        if not exchange:
            return ej, 0.0
        ek = -torch.einsum("n,wn->w", coeff,
                           dot_uv(gj, gi) - dot_uv(g0j, g0i)[None])
        return ej, ek

    ejaa, ekaa = channel(trial.pno_aa, Ghalfa, Ghalfa, trial.ghalf0a,
                         trial.ghalf0a, True)
    ejbb, ekbb = channel(trial.pno_bb, Ghalfb, Ghalfb, trial.ghalf0b,
                         trial.ghalf0b, True)
    ejab, _ = channel(trial.pno_ab, Ghalfa, Ghalfb, trial.ghalf0a,
                      trial.ghalf0b, False)
    ecoul0, exxa0, exxb0 = trial.e0_terms
    e2b = 0.5 * (ecoul0 - exxa0 - exxb0) + ejaa + ejbb + ejab + ekaa + ekbb
    return e1b + e2b, e1b, e2b


def local_energy_hubbard_ghf(ham, Gi: torch.Tensor,
                             det_weights: torch.Tensor):
    """(etot, e1b, e2b), each [w], of the Hubbard model with a GHF trial
    from the per-determinant Gi [w, D, 2M, 2M] and the normalised weights
    det_weights [w, D]:
      ke = sum_d w_d Tr(Gi_d blockdiag(T_up, T_dn)),
      pe = U sum_d w_d sum_i (Guu_ii Gdd_ii - Gud_ii Gdu_ii)."""
    t = ham.T.to(Gi.dtype)
    m = t.shape[-1]
    ke = (torch.einsum("wd,wdkl,kl->w", det_weights, Gi[:, :, :m, :m], t[0])
          + torch.einsum("wd,wdkl,kl->w", det_weights, Gi[:, :, m:, m:],
                         t[1]))
    guu = torch.diagonal(Gi[:, :, :m, :m], dim1=-2, dim2=-1)
    gdd = torch.diagonal(Gi[:, :, m:, m:], dim1=-2, dim2=-1)
    gud = torch.diagonal(Gi[:, :, m:, :m], dim1=-2, dim2=-1)
    gdu = torch.diagonal(Gi[:, :, :m, m:], dim1=-2, dim2=-1)
    pe = ham.U * torch.einsum("wd,wdi->w", det_weights,
                              guu * gdd - gud * gdu)
    return ke + pe, ke, pe


def local_energy_generic_cholesky_G(ham, Ga: torch.Tensor, Gb: torch.Tensor,
                                    max_elems: int | None = None):
    """(etot, e1b, e2b), each [w], of the Generic Hamiltonian from full
    Green's functions G_s [w, M, M] (no trial half-rotation: the
    back-propagated bra is not the trial):
      e1b = sum H1_s * G_s + ecore,
      X[w, x] = sum_ik L[i, k, x] (Ga + Gb)[w, i, k],
      exx = sum_s sum_x tr((G_s^T L_x)^2),
      e2b = 0.5 (X.X - exx).
    The exchange's [w, M, M, X] intermediate is formed in chunks of the
    Cholesky axis (and of walkers when one vector is already too large)
    of at most ``max_elems`` elements, so it fits the card at the bench
    shape. On a [walker, chol] mesh X.X and exx are summed over the chol
    group (one all_reduce)."""
    if max_elems is None:
        max_elems = CHOLESKY_G_MAX_ELEMS
    h1 = ham.H1
    chol = ham.chol                                       # [M, M, X]
    e1b = (cr_einsum("mn,wmn->w", h1[0], Ga)
           + cr_einsum("mn,wmn->w", h1[1], Gb))
    x = cr_einsum("ikx,wik->wx", chol, Ga + Gb)
    ecoul = torch.einsum("wx,wx->w", x, x)
    w, m = Ga.shape[0], Ga.shape[-1]
    nx = chol.shape[-1]
    wc = max(1, min(w, max_elems // (m * m)))
    xc = max(1, min(nx, max_elems // (wc * m * m)))
    exx = torch.zeros_like(ecoul)
    for g in (Ga, Gb):
        parts = []
        for w0 in range(0, w, wc):
            gw = g[w0:w0 + wc]
            acc = torch.zeros(gw.shape[0], dtype=ecoul.dtype,
                              device=ecoul.device)
            for x0 in range(0, nx, xc):
                t = rc_einsum("wil,ikx->wlkx", gw, chol[:, :, x0:x0 + xc])
                acc = acc + torch.einsum("wlkx,wklx->w", t, t)
            parts.append(acc)
        exx = exx + torch.cat(parts)
    # On a [walker, chol] mesh both are partial sums over this rank's X
    # slice; e1b is whole on every rank.
    if pmesh.chol_sharded():
        ecoul, exx = pmesh.chol_sum(torch.stack([ecoul, exx]))
    e2b = 0.5 * (ecoul - exx)
    return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b


def coulomb_greens_function_ueg(ham, G: torch.Tensor):
    """(Gkpq, Gpmq) [w, nq]: sum_i G[i, idx(k_i +/- q)] over valid pairs,
    as one masked gather and reduction each."""
    m = G.shape[-1]
    rows = torch.arange(m, device=G.device)[None, :]
    gkpq = torch.sum(G[:, rows, ham.kpq_idx] * ham.kpq_mask[None], dim=-1)
    gpmq = torch.sum(G[:, rows, ham.pmq_idx] * ham.pmq_mask[None], dim=-1)
    return gkpq, gpmq


def exchange_greens_function_ueg(ham, G: torch.Tensor,
                                 q_chunk: int | None = None,
                                 max_elems: int = 2 ** 26) -> torch.Tensor:
    """Gprod[w, q] = sum_{ij} G[j, idx(k_i + q)] G[i, idx(k_j - q)]: per q an
    elementwise trace of two gathered matrices, in chunks of q (and, when
    one q exceeds the budget, of walkers) so that the [w, M, qc, M]
    intermediates stay under ``max_elems``, as in JAX."""
    m = G.shape[-1]
    w = G.shape[0]
    if q_chunk is None:
        q_chunk = max(1, max_elems // max(1, 2 * w * m * m))
    if w * m * m * 2 > max_elems and w > 1:
        half = w // 2
        return torch.cat([
            exchange_greens_function_ueg(ham, G[:half], None, max_elems),
            exchange_greens_function_ueg(ham, G[half:], None, max_elems)])
    nq = ham.kpq_idx.shape[0]
    rdt = G.real.dtype
    out = []
    for q0 in range(0, nq, q_chunk):
        kpq_i = ham.kpq_idx[q0:q0 + q_chunk]
        pmq_i = ham.pmq_idx[q0:q0 + q_chunk]
        a = G[:, :, kpq_i] * ham.kpq_mask[q0:q0 + q_chunk].to(rdt)[None, None]
        b = G[:, :, pmq_i] * ham.pmq_mask[q0:q0 + q_chunk].to(rdt)[None, None]
        out.append(torch.einsum("wjqi,wiqj->wq", a, b))
    return torch.cat(out, dim=-1)


def local_energy_ueg(ham, Ga: torch.Tensor, Gb: torch.Tensor):
    """(etot, e1b, e2b), each [w]:
    pe = 1/(2 vol) sum_q v(q) [sum over spin pairs Gkpq_s Gpmq_s'
    - Gprod_up - Gprod_dn]; the Madelung ecore is not added (as in the
    reference kernel)."""
    h1 = ham.H1.to(Ga.dtype)
    ke = (torch.einsum("mn,wmn->w", h1[0], Ga)
          + torch.einsum("mn,wmn->w", h1[1], Gb))
    gkpq_a, gpmq_a = coulomb_greens_function_ueg(ham, Ga)
    gkpq_b, gpmq_b = coulomb_greens_function_ueg(ham, Gb)
    gprod_a = exchange_greens_function_ueg(ham, Ga)
    gprod_b = exchange_greens_function_ueg(ham, Gb)
    vq = ham.vqvec.to(Ga.dtype)
    ess = (torch.einsum("q,wq->w", vq, gkpq_a * gpmq_a - gprod_a)
           + torch.einsum("q,wq->w", vq, gkpq_b * gpmq_b - gprod_b))
    eos = (torch.einsum("q,wq->w", vq, gkpq_a * gpmq_b)
           + torch.einsum("q,wq->w", vq, gkpq_b * gpmq_a))
    fac = 1.0 / (2.0 * ham.vol)
    pe = fac * (ess + eos)
    return ke + pe, ke, pe


def fft_coulomb_terms(psi, gh, gmap, qmap, qmesh):
    """(Gkpq, Gpmq) [w, nq] by FFT correlations (the Coulomb part of
    ``_fft_spin_terms``), also the plane-wave force bias's expectations:
    <rho_q> = factor Gkpq, <rho_q^T> = factor Gpmq. One correlation cube
    C(Q) = sum_G ct(G) th(G - Q) gives Gkpq at Q and Gpmq at -Q."""
    qmesh = tuple(qmesh)
    ng = int(np.prod(qmesh))
    ct = to_cube(psi.conj().transpose(0, 1), gmap, ng)     # [n, Ng]
    th = to_cube(gh, gmap, ng)                             # [w, n, Ng]
    cube = ifft3(torch.einsum("ig,wig->wg", fft3(ct, qmesh),
                              ifft3(th, qmesh)) * ng, qmesh)
    return cube[..., qmap], cube[..., neg_perm(qmesh, cube.device)[qmap]]


def _fft_spin_terms(psi, gh, gmap, qmap, qmesh, pair_chunk: int = 8):
    """(Gkpq, Gpmq, Gprod) [w, nq] of one spin channel by pseudo-spectral
    correlations on the FFT cube. ``psi`` [M, n] is the trial's orbitals or
    a per-walker bra [w, M, n] (back propagation); ``gh`` [w, n, M] the
    half-rotated Green's function (G = psi* gh).

    With P[i, j](Q) = sum_G CT_i(G + Q) theta_j(G): Gpmq(q) = sum_i
    P[i, i](Q), Gkpq(q) = sum_i P[i, i](-Q) (the q labelling of the gather
    kernels and the reference; S(k) depends on it, the energy does not),
    and Gprod(Q) = sum_ij P[i, j](Q) P[j, i](-Q). With n > ``pair_chunk``
    the pair tensor is formed in chunks of the first occupied index, the
    exchange partner from its own transforms."""
    qmesh = tuple(qmesh)
    if psi.shape[-1] == 0:
        # A fully polarised system's empty channel contributes nothing.
        z = gh.new_zeros((gh.shape[0], qmap.shape[0]))
        return z, z, z
    ng = int(np.prod(qmesh))
    wbra = psi.dim() == 3
    ct = to_cube(psi.conj().transpose(-1, -2), gmap, ng)  # [(w,) n, Ng]
    th = to_cube(gh, gmap, ng)                           # [w, n, Ng]
    ct_f, th_if = fft3(ct, qmesh), ifft3(th, qmesh)
    n = psi.shape[-1]
    qneg = neg_perm(qmesh, gh.device)[qmap]
    if n <= pair_chunk:
        pair = (ct_f[:, :, None] if wbra else ct_f[None, :, None]) \
            * th_if[:, None]
        p = ifft3(pair.mul_(ng), qmesh)             # [w, i, j, Ng]
        del pair
        diag = torch.diagonal(p, dim1=1, dim2=2).sum(-1)
        gprod = torch.sum(p[..., qmap] * p[..., qneg].transpose(1, 2),
                          dim=(1, 2))
        return diag[..., qneg], diag[..., qmap], gprod
    ct_if, th_f = ifft3(ct, qmesh), fft3(th, qmesh)
    e_kpq = "wig,wig->wg" if wbra else "ig,wig->wg"
    cube = ifft3(torch.einsum(e_kpq, ct_f, th_if) * ng, qmesh)
    gprod = None
    for i0 in range(0, n, pair_chunk):
        i1 = min(i0 + pair_chunk, n)
        if wbra:
            p = ifft3(ct_f[:, i0:i1, None] * th_if[:, None] * ng, qmesh)
            r = ifft3(th_f[:, i0:i1, None] * ct_if[:, None] * ng, qmesh)
        else:
            p = ifft3(ct_f[None, i0:i1, None] * th_if[:, None] * ng, qmesh)
            r = ifft3(th_f[:, i0:i1, None] * ct_if[None, None] * ng, qmesh)
        part = torch.sum(p[..., qmap] * r[..., qmap], dim=(1, 2))
        gprod = part if gprod is None else gprod + part
    return cube[..., qneg], cube[..., qmap], gprod


def structure_factor_ueg(ham, spin_factors):
    """S(k) blocks [w, 2, 2, nq]. ``spin_factors`` is ((bra_a, gha),
    (bra_b, ghb)) with G_s = bra_s* gh_s, the FFT route when the system has
    its cube maps, or ((Ga, None), (Gb, None)) dense, the gather kernels."""
    (bra_a, gha), (bra_b, ghb) = spin_factors
    if getattr(ham, "gmap", None) is not None and gha is not None:
        ka, pa, xa = _fft_spin_terms(bra_a, gha, ham.gmap, ham.qmap,
                                     ham.qmesh)
        kb, pb, xb = _fft_spin_terms(bra_b, ghb, ham.gmap, ham.qmap,
                                     ham.qmesh)
    else:
        def dense(bra, gh):
            if gh is None:
                return bra
            eq = "wmi,win->wmn" if bra.dim() == 3 else "mi,win->wmn"
            return torch.einsum(eq, bra.conj(), gh)

        ga, gb = dense(bra_a, gha), dense(bra_b, ghb)
        ka, pa = coulomb_greens_function_ueg(ham, ga)
        kb, pb = coulomb_greens_function_ueg(ham, gb)
        xa = exchange_greens_function_ueg(ham, ga)
        xb = exchange_greens_function_ueg(ham, gb)
    return torch.stack([torch.stack([ka * pa - xa, ka * pb], 1),
                        torch.stack([kb * pa, kb * pb - xb], 1)], 1)


def _pw_energy(vol: float, vq, ke, terms_a, terms_b):
    """(etot, e1b, e2b) from the kinetic energy and each spin's (Gkpq,
    Gpmq, Gprod): pe = 1/(2 vol) sum_q v(q) [sum over spin pairs
    Gkpq_s Gpmq_s' - Gprod_up - Gprod_dn]."""
    ka, pa, xa = terms_a
    kb, pb, xb = terms_b
    vq = vq.to(ke.dtype)
    ess = (torch.einsum("q,wq->w", vq, ka * pa - xa)
           + torch.einsum("q,wq->w", vq, kb * pb - xb))
    eos = (torch.einsum("q,wq->w", vq, ka * pb)
           + torch.einsum("q,wq->w", vq, kb * pa))
    pe = (1.0 / (2.0 * vol)) * (ess + eos)
    return ke + pe, ke, pe


def _half_kinetic(eig, trial, gha, ghb):
    """sum_m eig_m (G_a + G_b)[m, m] from the half-rotated G."""
    diag = (torch.einsum("mi,wim->wm", trial.psia.conj(), gha)
            + torch.einsum("mi,wim->wm", trial.psib.conj(), ghb))
    return torch.einsum("m,wm->w", eig.to(diag.dtype), diag)


def local_energy_ueg_half(ham, trial, gha: torch.Tensor, ghb: torch.Tensor):
    """(etot, e1b, e2b), each [w], of the UEG from the half-rotated
    Green's functions by FFT correlations: O(w n^2 Ng log Ng) instead of
    the gathers' O(w nq M^2)."""
    ke = _half_kinetic(torch.diagonal(ham.H1[0]), trial, gha, ghb)
    return _pw_energy(ham.vol, ham.vqvec, ke,
                      _fft_spin_terms(trial.psia, gha, ham.gmap, ham.qmap,
                                      ham.qmesh),
                      _fft_spin_terms(trial.psib, ghb, ham.gmap, ham.qmap,
                                      ham.qmesh))


def local_energy_pw_fft(ham, trial, gha: torch.Tensor, ghb: torch.Tensor):
    """(etot, e1b, e2b), each [w], of the PW_FFT system from the
    half-rotated Green's functions:
      Gkpq(Q) = sum_iG CT_i(G + Q) theta_i(G),
      Gpmq(Q) = sum_iG CT_i(G - Q) theta_i(G),
      Gprod(Q) = sum_ij [sum_G CT_i(G + Q) theta_j(G)]
                        [sum_G CT_j(G - Q) theta_i(G)],
    each a circular FFT correlation on the cube."""
    qmesh = tuple(ham.qmesh)
    ng = int(np.prod(qmesh))
    gmap, qmap = ham.gmap, ham.qmap
    ke = _half_kinetic(ham.sp_eigv, trial, gha, ghb)

    def spin_terms(psi, gh):
        ct = to_cube(psi.conj().transpose(0, 1), gmap, ng)   # [n, Ng]
        th = to_cube(gh, gmap, ng)                           # [w, n, Ng]
        ct_f, ct_if = fft3(ct, qmesh), ifft3(ct, qmesh)
        th_f, th_if = fft3(th, qmesh), ifft3(th, qmesh)
        gkpq = ifft3(torch.einsum("ig,wig->wg", ct_f, th_if) * ng,
                     qmesh)[..., qmap]
        gpmq = ifft3(torch.einsum("wig,ig->wg", th_f, ct_if) * ng,
                     qmesh)[..., qmap]
        p = ifft3(ct_f[None, :, None] * th_if[:, None] * ng, qmesh)
        r = ifft3(th_f[:, :, None] * ct_if[None, None] * ng, qmesh)
        gprod = torch.sum(p[..., qmap] * r[..., qmap], dim=(1, 2))
        return gkpq, gpmq, gprod

    return _pw_energy(ham.vol, ham.vqvec, ke, spin_terms(trial.psia, gha),
                      spin_terms(trial.psib, ghb))


def _exx_host(chol: np.ndarray, g: np.ndarray, max_elems: int = 1 << 22):
    """sum_x sum_ij t_ijx t_jix with t[:, :, x] = L_x g^T, as batched
    [M, M] products over chunks of the Cholesky axis (no [M, M, X]
    intermediate)."""
    m, _, nx = chol.shape
    chunk = max(1, max_elems // (m * m))
    total = 0.0
    for x0 in range(0, nx, chunk):
        t = np.moveaxis(chol[:, :, x0:x0 + chunk], 2, 0) @ g.T
        total = total + np.sum(t * np.swapaxes(t, 1, 2))
    return total


def local_energy_G_host(ham, G: np.ndarray):
    """(etot, e1b, e2b) of one Green's function G [2, M, M], host-side."""
    if ham.name == "Generic":
        # Dense contraction from the Cholesky factors,
        # (ik|jl) = sum_x L[i,k,x] L[j,l,x].
        h1 = ham.H1.cpu().numpy()
        chol = ham.chol.cpu().numpy()                     # [M, M, X]
        m = chol.shape[0]
        e1b = np.sum(h1[0] * G[0]) + np.sum(h1[1] * G[1])
        xv = (G[0] + G[1]).reshape(-1) @ chol.reshape(m * m, -1)
        ecoul = 0.5 * np.dot(xv, xv)
        exx = 0.5 * (_exx_host(chol, G[0]) + _exx_host(chol, G[1]))
        e2b = ecoul - exx
        return e1b + e2b + ham.ecore, e1b + ham.ecore, e2b
    if ham.name == "UEG":
        # The batched kernel on one walker, in complex128.
        g = torch.from_numpy(np.asarray(G, dtype=np.complex128)).to(
            ham.H1.device)
        return tuple(x[0].item() for x in local_energy_ueg(ham, g[0][None],
                                                            g[1][None]))
    if ham.name == "PW_FFT":
        # The gather kernels on one walker in complex128, through the
        # system's host gather maps (q = 0 carries v_q = 0).
        from pauxy_tpu_torch.models.pw_fft import gather_maps

        dev = ham.sp_eigv.device
        maps = [torch.from_numpy(x).to(dev) for x in gather_maps(ham)]
        view = types.SimpleNamespace(
            H1=ham.T, vqvec=ham.vqvec, vol=ham.vol,
            **dict(zip(("kpq_idx", "kpq_mask", "pmq_idx", "pmq_mask"),
                       maps)))
        g = torch.from_numpy(np.asarray(G, dtype=np.complex128)).to(dev)
        return tuple(x[0].item() for x in local_energy_ueg(view, g[0][None],
                                                            g[1][None]))
    if ham.name not in ("Hubbard", "HubbardHolstein"):
        # Hubbard-Holstein: the electronic Hubbard energy (the phonon terms
        # need walker coordinates).
        raise NotImplementedError(f"no host local energy for {ham.name!r}")
    t = ham.T.cpu().numpy()
    ke = np.sum(t[0] * G[0] + t[1] * G[1])
    if ham.symmetric:
        pe = -0.5 * ham.U * (np.trace(G[0]) + np.trace(G[1]))
    else:
        pe = ham.U * np.dot(np.diagonal(G[0]), np.diagonal(G[1]))
    return ke + pe, ke, pe
