"""Multi-determinant GHF trial wavefunctions (Hubbard lattice models).

Counterpart of ``pauxy_tpu/models/ghf.py``. A GHF determinant is a
(2M x ne) Slater matrix mixing the spin sectors; the trial is an expansion
sum_d c_d |t_d>. The walker stays block-diagonal (up block [M, nup], down
block [M, ndown]): it starts so, the kinetic propagator is block-diagonal
and the Hirsch site updates scale rows within a block. So the walkers are
the usual ``WalkerState``; only the overlaps, Green's functions and the
local energy see the 2M x ne trial:

  S_d  = t_d^H phi          (ne x ne, spin-mixed)
  <psi_T|phi> = sum_d conj(c_d) det S_d
  Gi_d = (phi S_d^-1 t_d^H)^T     (2M x 2M)

batched over [w, D]. The trial is built host-side (numpy; setup).
"""

from __future__ import annotations

import ast

import numpy as np
import torch
from torch import nn

from pauxy_tpu_torch import config
from pauxy_tpu_torch.models.multi_slater import log_coeffs, logsumexp_c
from pauxy_tpu_torch.ops import clinalg
from pauxy_tpu_torch.ops.lanelinalg import cadd


class GHFTrial(nn.Module):
    """Buffers: ``psi`` [D, 2M, ne], ``coeffs`` [D], the walkers' initial
    block-diagonal determinant ``inita`` [M, nup] / ``initb`` [M, ndown].
    ``etrial`` is the expansion's variational energy."""

    def __init__(self, psi, coeffs, inita, initb, *, etrial: float,
                 name: str = "multi_determinant"):
        super().__init__()
        self.register_buffer("psi", psi)
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("inita", inita)
        self.register_buffer("initb", initb)
        self.etrial = float(etrial)
        self.name = name

    @property
    def ndets(self) -> int:
        return self.psi.shape[0]

    @property
    def nbasis(self) -> int:
        return self.psi.shape[1] // 2

    @property
    def nup(self) -> int:
        return self.inita.shape[1]

    @property
    def ndown(self) -> int:
        return self.initb.shape[1]



def ghf_overlap_matrices(trial: GHFTrial, phia, phib) -> torch.Tensor:
    """S[w, d] = t_d^H phi for a block-diagonal walker, [w, D, ne, ne]:
    columns e < nup from the up block, e >= nup from the down block."""
    m = trial.nbasis
    s1 = torch.einsum("dmk,wme->wdke", trial.psi[:, :m].conj(), phia)
    s2 = torch.einsum("dmk,wme->wdke", trial.psi[:, m:].conj(), phib)
    return torch.cat([s1, s2], dim=-1)


def ghf_log_overlap(trial: GHFTrial, phia, phib) -> torch.Tensor:
    """log <psi_T|phi> = log sum_d conj(c_d) det S_d, [w]."""
    return logsumexp_c(cadd(
        clinalg.slogdet(ghf_overlap_matrices(trial, phia, phib)),
        log_coeffs(trial)[None, :]))


def ghf_greens_function(trial: GHFTrial, phia, phib):
    """(Gi [w, D, 2M, 2M], det_weights [w, D]) for a block-diagonal walker:
    Gi_d = (phi S_d^-1 t_d^H)^T and det_weights_d = conj(c_d) det S_d / sum
    (so G = sum_d w_d Gi_d). S_d^-1 and log det S_d from one pass of
    kernel B."""
    nup = trial.nup
    logdets, inv = clinalg.inv_logdet(ghf_overlap_matrices(trial, phia,
                                                           phib))
    logw = cadd(logdets.to(phia.dtype), log_coeffs(trial)[None, :])
    w_un = torch.exp(logw - torch.amax(logw.real, dim=-1, keepdim=True))
    det_weights = w_un / torch.sum(w_un, dim=-1, keepdim=True)
    up = torch.einsum("wme,wdek->wdmk", phia, inv[:, :, :nup, :])
    dn = torch.einsum("wme,wdek->wdmk", phib, inv[:, :, nup:, :])
    phiinv = torch.cat([up, dn], dim=2)                   # [w, D, 2M, ne]
    gi = torch.einsum("wdyk,dxk->wdxy", phiinv, trial.psi.conj())
    return gi, det_weights


def ghf_trial_from_uhf(ham, psia: np.ndarray, psib: np.ndarray, *,
                       device=None, dtype=None) -> GHFTrial:
    """Block-embed a UHF determinant pair into a single GHF determinant."""
    prec = config.get_precision(dtype)
    m = psia.shape[0]
    na, nb = psia.shape[1], psib.shape[1]
    psi = np.zeros((1, 2 * m, na + nb), dtype=prec.np_cplx)
    psi[0, :m, :na] = psia
    psi[0, m:, na:] = psib
    return make_ghf_trial(ham, psi, np.ones((1,)), device=device,
                          dtype=dtype)


def read_fortran_complex_numbers(filename: str) -> np.ndarray:
    """Parse the reference's '(re,im)'-per-line GHF orbital / coefficient
    files."""
    with open(filename) as f:
        vals = [ast.literal_eval(line.strip()) for line in f if line.strip()]
    return np.array([complex(t[0], t[1]) for t in vals])


def ghf_trial_from_files(ham, orbital_file: str, coeffs_file: str,
                         ndets: int, *, device=None, dtype=None) -> GHFTrial:
    """Read the reference's ascii format: column-major (2M x ne) blocks,
    one per determinant."""
    coeffs = read_fortran_complex_numbers(coeffs_file)[:ndets]
    orbs = read_fortran_complex_numbers(orbital_file)
    m2, ne = 2 * ham.nbasis, ham.nup + ham.ndown
    psi = np.zeros((ndets, m2, ne), dtype=complex)
    skip = m2 * ne
    for d in range(ndets):
        psi[d] = orbs[d * skip:(d + 1) * skip].reshape((m2, ne), order="F")
    return make_ghf_trial(ham, psi, coeffs, device=device, dtype=dtype)


def make_ghf_trial(ham, psi: np.ndarray, coeffs: np.ndarray, init=None, *,
                   device=None, dtype=None) -> GHFTrial:
    """The trial from psi [D, 2M, ne] and coefficients [D]; the walkers
    start from ``init`` (inita, initb), else from the free-electron block
    determinant. ``etrial`` is the expansion's variational energy."""
    from pauxy_tpu_torch.models.trial import free_electron_trial

    prec = config.get_precision(dtype)
    device = config.resolve_device(device)
    psi = np.asarray(psi, dtype=prec.np_cplx)
    coeffs = np.asarray(coeffs, dtype=prec.np_cplx)
    if init is not None:
        inita, initb = init
    else:
        fe = free_electron_trial(ham, device="cpu", dtype=dtype)
        inita, initb = fe.psia.numpy(), fe.psib.numpy()

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, dtype=prec.np_cplx))).to(device)

    return GHFTrial(dev(psi), dev(coeffs), dev(inita), dev(initb),
                    etrial=ghf_variational_energy(ham, psi, coeffs))


def _t_ext(ham) -> np.ndarray:
    """blockdiag(T_up, T_dn) [2M, 2M]."""
    t = ham.T.cpu().numpy()
    return np.block([[t[0], np.zeros_like(t[0])],
                     [np.zeros_like(t[1]), t[1]]])


def ghf_variational_energy(ham, psi, coeffs) -> float:
    """<Psi|H|Psi> / <Psi|Psi> of the expansion with the cross-determinant
    Green's functions G_ab (host-side numpy; setup)."""
    psi = np.asarray(psi)
    coeffs = np.asarray(coeffs)
    d = psi.shape[0]
    m = psi.shape[1] // 2
    text = _t_ext(ham)
    num = 0.0 + 0j
    denom = 0.0 + 0j
    for a in range(d):
        for b in range(d):
            s = psi[a].conj().T @ psi[b]
            ovlp = np.linalg.det(s)
            if abs(ovlp) < 1e-14:
                continue
            w = coeffs[a].conj() * coeffs[b] * ovlp
            gab = (psi[b] @ np.linalg.solve(s, psi[a].conj().T)).T
            ke = np.sum(gab * text)
            guu = np.diagonal(gab[:m, :m])
            gdd = np.diagonal(gab[m:, m:])
            gud = np.diagonal(gab[m:, :m])
            gdu = np.diagonal(gab[:m, m:])
            pe = ham.U * np.sum(guu * gdd - gud * gdu)
            num += w * (ke + pe)
            denom += w
    return float(np.real(num / denom))


def _ghf_energy_host(ham, psi, coeffs, phia, phib):
    """The GHF local energy of one block-diagonal walker (host-side numpy;
    setup and tests)."""
    m = psi.shape[1] // 2
    na = phia.shape[1]
    d = psi.shape[0]
    s = np.concatenate(
        [np.einsum("dmk,me->dke", psi[:, :m, :].conj(), phia),
         np.einsum("dmk,me->dke", psi[:, m:, :].conj(), phib)], axis=-1)
    dets = np.array([np.linalg.det(s[i]) for i in range(d)])
    wts = coeffs.conj() * dets
    denom = wts.sum()
    inv = np.array([np.linalg.inv(s[i]) for i in range(d)])
    up = np.einsum("me,dek->dmk", phia, inv[:, :na, :])
    dn = np.einsum("me,dek->dmk", phib, inv[:, na:, :])
    phiinv = np.concatenate([up, dn], axis=1)
    gi = np.einsum("dyk,dxk->dxy", phiinv, psi.conj())
    text = _t_ext(ham)
    ke = np.einsum("d,dkl,kl->", wts, gi, text) / denom
    guu = np.einsum("dii->di", gi[:, :m, :m])
    gdd = np.einsum("dii->di", gi[:, m:, m:])
    gud = np.einsum("dii->di", gi[:, m:, :m])
    gdu = np.einsum("dii->di", gi[:, :m, m:])
    pe = ham.U * np.einsum("d,di->", wts, guu * gdd - gud * gdu) / denom
    return ke + pe
